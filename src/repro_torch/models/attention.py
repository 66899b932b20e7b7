"""Attention: blockwise (memory-efficient) causal attention with GQA/MQA,
optional sliding window, and single-token decode attention over a ring KV
cache (the port of ``repro.models.attention``).

The reference writes these in plain jnp, with no Pallas kernel, so the port
writes them in plain torch: the same online softmax over KV blocks, the
same masks and the same f32 accumulation.  ``chunk_attention`` and
``flash_causal_attention`` are not ported yet (ROADMAP.md, Queue A item 8).
"""
from __future__ import annotations

import math

import torch

__all__ = ["blockwise_causal_attention", "decode_attention"]

NEG_INF = -1e30


def _gqa_scores(qb: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """qb: (B, bq, K, G, P), kb: (B, bk, K, P) -> (B, K, G, bq, bk) f32."""
    return torch.einsum("bqkgp,bskp->bkgqs", qb.float(), kb.float())


def blockwise_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention.

    q: (B, T, H, P); k, v: (B, T, K, P) with H = K * G (GQA).
    Returns (B, T, H, P) in q.dtype.  The reference's ``unroll`` (a hint
    for XLA's cost analysis) has no counterpart: the port loops in Python.
    """
    B, T, H, P = q.shape
    K = k.shape[2]
    G = H // K
    block_q = min(block_q, T)
    block_k = min(block_k, T)
    # pad T to block multiples: padded keys sit at positions > every real
    # query so the causal mask hides them; padded query rows are sliced off.
    pad = -T % math.lcm(block_q, block_k)
    if pad:
        p4 = (0, 0, 0, 0, 0, pad)
        q, k, v = (torch.nn.functional.pad(t, p4) for t in (q, k, v))
    Tf = T + pad
    nq, nk = Tf // block_q, Tf // block_k
    scale = P ** -0.5
    dev = q.device

    qb = q.reshape(B, nq, block_q, K, G, P)
    kb = k.reshape(B, nk, block_k, K, P)
    vb = v.reshape(B, nk, block_k, K, P)
    q_pos = torch.arange(block_q, device=dev)
    k_pos = torch.arange(block_k, device=dev)

    outs = []
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
    out = torch.stack(outs, dim=1).reshape(B, Tf, H, P)[:, :T]
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos,
) -> torch.Tensor:
    """One-token attention over a ring KV cache.

    q: (B, 1, H, P); caches: (B, S, K, P); pos: scalar int (the absolute
    position of the new token), or (B,) per-request positions when the
    batch lanes sit at different depths.  Slots carry RoPE'd keys, so
    softmax is order-agnostic; the mask only hides never-written slots.
    Returns (B, 1, H, P).
    """
    B, S, K, P = k_cache.shape
    H = q.shape[2]
    G = H // K
    scale = P ** -0.5
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
