"""Attention: blockwise (memory-efficient) causal attention with GQA/MQA,
optional sliding window, and single-token decode attention over a ring KV
cache (the port of ``repro.models.attention``).

The reference writes these in plain jnp, with no Pallas kernel, so the port
writes them in plain torch: the same online softmax over KV blocks, the
same masks and the same f32 accumulation.  ``chunk_attention`` is the
chunked-prefill primitive.  ``flash_causal_attention`` is the reference's
flash form: its forward (``_flash_fwd_impl``, which also returns the
log-sum-exp) is the blockwise online softmax, and its memory-saving
backward ``_flash_bwd`` recomputes the probabilities block by block.
"""
from __future__ import annotations

import math

import torch

from .common import unshard

__all__ = ["blockwise_causal_attention", "decode_attention",
           "chunk_attention", "flash_causal_attention"]

NEG_INF = -1e30


def _scale(P: int, scale: float | None) -> float:
    """The scores' multiplier: ``scale``, or ``P ** -0.5`` when None."""
    return P ** -0.5 if scale is None else scale


def _gqa_scores(qb: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """qb: (B, bq, K, G, P), kb: (B, bk, K, P) -> (B, K, G, bq, bk) f32."""
    return torch.einsum("bqkgp,bskp->bkgqs", qb.float(), kb.float())


def _flash_fwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int, block_q: int, block_k: int,
                    scale: float | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal (optionally sliding-window) attention by an online softmax
    over KV blocks, one Q block at a time.

    q: (B, T, H, P); k, v: (B, T, K, P) with H = K * G (GQA).  Returns
    (out (B, T, H, P) in q.dtype, lse (B, K, G, T) f32), the log-sum-exp
    of each query's masked scores.  T is padded internally to a multiple
    of lcm(block_q, block_k): padded keys sit at positions > every real
    query so the causal mask hides them; padded query rows are sliced off.
    ``scale`` multiplies the scores (``P ** -0.5`` when None).
    """
    B, T, H, P = q.shape
    K = k.shape[2]
    G = H // K
    block_q = min(block_q, T)
    block_k = min(block_k, T)
    pad = -T % math.lcm(block_q, block_k)
    if pad:
        p4 = (0, 0, 0, 0, 0, pad)
        q, k, v = (torch.nn.functional.pad(t, p4) for t in (q, k, v))
    Tf = T + pad
    nq, nk = Tf // block_q, Tf // block_k
    scale = _scale(P, scale)
    dev = q.device

    qb = q.reshape(B, nq, block_q, K, G, P)
    kb = k.reshape(B, nk, block_k, K, P)
    vb = v.reshape(B, nk, block_k, K, P)
    q_pos = torch.arange(block_q, device=dev)
    k_pos = torch.arange(block_k, device=dev)

    outs, lses = [], []
    for qi in range(nq):
        qblk = qb[:, qi]  # (B, bq, K, G, P)
        m = torch.full((B, K, G, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, K, G, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, G, block_q, P), dtype=torch.float32,
                          device=dev)
        abs_q = qi * block_q + q_pos
        for ki in range(nk):
            kblk, vblk = kb[:, ki], vb[:, ki]
            s = _gqa_scores(qblk, kblk) * scale  # (B, K, G, bq, bk)
            abs_k = ki * block_k + k_pos
            mask = abs_k[None, :] <= abs_q[:, None]
            if window:
                mask &= (abs_q[:, None] - abs_k[None, :]) < window
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskp->bkgqp", p.to(vblk.dtype).float(),
                              vblk.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)  # (B, K, G, bq, P)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (B, bq, K, G, P)
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.stack(outs, dim=1).reshape(B, Tf, H, P)[:, :T]
    lse = torch.cat(lses, dim=-1)[..., :T]
    return out.to(q.dtype), lse


def blockwise_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    block_q: int = 512,
    block_k: int = 512,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention.

    q: (B, T, H, P); k, v: (B, T, K, P) with H = K * G (GQA).
    Returns (B, T, H, P) in q.dtype.  The reference's ``unroll`` (a hint
    for XLA's cost analysis) has no counterpart: the port loops in Python.
    """
    return _flash_fwd_impl(q, k, v, window, block_q, block_k, scale)[0]


def _flash_bwd(window: int, block_q: int, block_k: int, scale, res, dout):
    """The reference's custom VJP of flash attention: each block's
    probabilities recomputed from ``lse`` (no O(T^2) residual), then a dq
    pass over query blocks and a dk / dv pass over key blocks, f32
    throughout.  ``res`` = (q, k, v, out, lse) from the forward.  Returns
    (dq, dk, dv) in q's, k's and v's types."""
    q, k, v, out, lse = res
    B, T, H, P = q.shape
    K = k.shape[2]
    G = H // K
    block_q = min(block_q, T)
    block_k = min(block_k, T)
    scale = _scale(P, scale)
    f32 = torch.float32
    dev = q.device
    # D_i = sum_p dout_i * out_i  (B, K, G, T)
    D = torch.einsum("bthp,bthp->bth", dout.float(), out.float())
    D = D.reshape(B, T, K, G).permute(0, 2, 3, 1)
    padq, padk = -T % block_q, -T % block_k
    Tq, Tk = T + padq, T + padk
    nq, nk = Tq // block_q, Tk // block_k

    def pad_t(x, pad, dim=1):
        if not pad:
            return x
        shape = list(x.shape)
        shape[dim] = pad
        return torch.cat([x, x.new_zeros(shape)], dim=dim)

    qb = pad_t(q, padq).reshape(B, nq, block_q, K, G, P)
    dob = pad_t(dout, padq).reshape(B, nq, block_q, K, G, P).float()
    kb = pad_t(k, padk).reshape(B, nk, block_k, K, P)
    vb = pad_t(v, padk).reshape(B, nk, block_k, K, P).float()
    lseb = pad_t(lse, padq, 3).reshape(B, K, G, nq, block_q)
    Db = pad_t(D, padq, 3).reshape(B, K, G, nq, block_q)
    q_pos = torch.arange(block_q, device=dev)
    k_pos = torch.arange(block_k, device=dev)

    def block_p(qi, ki):
        s = _gqa_scores(qb[:, qi], kb[:, ki]) * scale  # (B, K, G, bq, bk)
        abs_q = qi * block_q + q_pos
        abs_k = ki * block_k + k_pos
        mask = abs_k[None, :] <= abs_q[:, None]
        if window:
            mask &= (abs_q[:, None] - abs_k[None, :]) < window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        return torch.exp(s - lseb[:, :, :, qi, :, None])  # exact probs

    def block_ds(qi, ki, p):
        dp = torch.einsum("bqkgp,bskp->bkgqs", dob[:, qi], vb[:, ki])
        return p * (dp - Db[:, :, :, qi, :, None]) * scale

    # dq pass: over query blocks, key blocks in order
    dqs = []
    for qi in range(nq):
        dq = torch.zeros((B, block_q, K, G, P), dtype=f32, device=dev)
        for ki in range(nk):
            ds = block_ds(qi, ki, block_p(qi, ki))
            dq = dq + torch.einsum("bkgqs,bskp->bqkgp", ds,
                                   kb[:, ki].float())
        dqs.append(dq)
    dq = torch.stack(dqs, dim=1).reshape(B, Tq, H, P)[:, :T]
    # dk / dv pass: over key blocks, query blocks in order
    dks, dvs = [], []
    for ki in range(nk):
        dk = torch.zeros((B, block_k, K, P), dtype=f32, device=dev)
        dv = torch.zeros_like(dk)
        for qi in range(nq):
            p = block_p(qi, ki)
            dv = dv + torch.einsum("bkgqs,bqkgp->bskp", p, dob[:, qi])
            ds = block_ds(qi, ki, p)
            dk = dk + torch.einsum("bkgqs,bqkgp->bskp", ds,
                                   qb[:, qi].float())
        dks.append(dk)
        dvs.append(dv)
    dk = torch.stack(dks, dim=1).reshape(B, Tk, K, P)[:, :T]
    dv = torch.stack(dvs, dim=1).reshape(B, Tk, K, P)[:, :T]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """``_flash_fwd_impl`` forward, ``_flash_bwd`` backward: the saved
    residuals are (q, k, v, out, lse), as the reference's ``_flash_fwd``
    saves them."""

    @staticmethod
    def forward(ctx, q, k, v, window, block_q, block_k, scale):
        out, lse = _flash_fwd_impl(q, k, v, window, block_q, block_k, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (window, block_q, block_k, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.cfg, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, window: int = 0,
                           block_q: int = 512, block_k: int = 512,
                           scale: float | None = None) -> torch.Tensor:
    """The reference's flash attention with its custom VJP: the forward is
    ``_flash_fwd_impl``'s output (the same arithmetic as
    :func:`blockwise_causal_attention`), the backward ``_flash_bwd``, which
    recomputes each block's scores from the saved log-sum-exp instead of
    keeping the O(T^2) probabilities.  The reference computes both outside
    any Pallas kernel, and so does the port, in plain torch."""
    return _FlashAttention.apply(q, k, v, window, block_q, block_k, scale)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos,
    scale: float | None = None,
) -> torch.Tensor:
    """One-token attention over a ring KV cache.

    q: (B, 1, H, P); caches: (B, S, K, P); pos: scalar int (the absolute
    position of the new token), or (B,) per-request positions when the
    batch lanes sit at different depths.  Slots carry RoPE'd keys, so
    softmax is order-agnostic; the mask only hides never-written slots.
    Returns (B, 1, H, P).

    For the dry-run's DTensors, a cache whose KV-head dim is sharded (over
    ``model``) has that dim, and the query's head dim, gathered first
    (``unshard``; the other dims keep their sharding): the einsums'
    batched products would flatten it into the batch, which DTensor
    refuses on torch 2.11.  Any other cache (MQA's single KV head, plain
    tensors) is used as it is.
    """
    if any(getattr(pl, "dim", None) == 2
           for pl in getattr(k_cache, "placements", ())):
        q, k_cache, v_cache = (unshard(t, 2) for t in (q, k_cache, v_cache))
    B, S, K, P = k_cache.shape
    H = q.shape[2]
    G = H // K
    scale = _scale(P, scale)
    qr = q.reshape(B, 1, K, G, P)
    s = torch.einsum("bqkgp,bskp->bkgqs", qr.float(), k_cache.float()) * scale
    pos = torch.as_tensor(pos, device=q.device)
    slots = torch.arange(S, device=q.device)
    if pos.dim():  # (B,): per-lane ring validity
        valid = (slots[None] <= pos[:, None]) | (pos[:, None] >= S)
        valid = valid[:, None, None, None, :]
    else:
        valid = ((slots <= pos) | (pos >= S))[None, None, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskp->bqkgp", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, P).to(q.dtype)


def chunk_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos0,
    scale: float | None = None,
) -> torch.Tensor:
    """Multi-token attention over a ring KV cache — the chunked-prefill
    primitive.

    q: (B, Tc, H, P) — a chunk of prompt queries whose keys/values are
    already written into the cache at slots [pos0, pos0 + Tc); caches:
    (B, S, K, P); pos0: scalar int (a python int or a 0-d tensor), the
    absolute position of the chunk's first token (every lane of a
    resuming chunk sits at the same depth).  Query t attends causally to
    slots <= pos0 + t; never-written slots beyond the chunk are masked
    out.  Returns (B, Tc, H, P).
    """
    B, S, K, P = k_cache.shape
    Tc, H = q.shape[1], q.shape[2]
    G = H // K
    scale = _scale(P, scale)
    qr = q.reshape(B, Tc, K, G, P)
    s = torch.einsum("btkgp,bskp->bkgts", qr.float(),
                     k_cache.float()) * scale
    abs_q = (torch.as_tensor(pos0, device=q.device)
             + torch.arange(Tc, device=q.device))
    valid = torch.arange(S, device=q.device)[None, :] <= abs_q[:, None]
    s = torch.where(valid[None, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskp->btkgp", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, Tc, H, P).to(q.dtype)
