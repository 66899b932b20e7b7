"""Unified decoder model (the port of ``repro.models.model``).

One functional model with a per-layer ``block_kind`` pattern:

* ``attn``  — pre-norm GQA/MQA attention (+ optional qk_norm, sliding
              window) followed by a dense (optionally gated) FFN.
* ``moe``   — attention followed by a routed mixture of experts: not ported
              yet (ROADMAP.md, Queue A item 8).
* ``mamba`` — Mamba2 SSD block (models/ssm.py), whose chunk runs the SSD
              kernel.

Hybrid architectures (zamba2) interleave ``mamba`` blocks with a *shared*
attention block applied every ``shared_attn_period`` layers (single weight
set, Zamba2-style).

Parameters are nested dicts with the reference's names and layouts, with
one difference: ``params["layers"]`` is always a per-layer list (the
reference stacks homogeneous layers for ``lax.scan``; the port runs
eagerly, layer by layer, in Python), and so is ``cache["layers"]``.
``repro_torch.convert`` unstacks the reference's parameters.

The FFN's GEMMs are the paper's type-1 operators: with ``coded_n`` set they
run through ``core/coded_linear.py`` (split, encode, n piece GEMMs, decode
at the k-th arrival) — on the worker pool when an executor is installed
with :func:`coded_executor`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any

import torch
import torch.nn.functional as F

from .._device import resolve_device
from .attention import blockwise_causal_attention, decode_attention
from .common import lecun_init, rms_norm, rope, rope_at
from .ssm import (SSMDims, MambaState, init_mamba_params, mamba_forward,
                  mamba_step)

__all__ = ["ModelConfig", "init_params", "forward", "prefill",
           "prefill_resume", "supports_prefill_pack", "decode_step",
           "init_cache", "param_count", "coded_executor", "current_executor"]

_NOT_PORTED = "is not ported yet (ROADMAP.md, Queue A item 8)"


# ---------------------------------------------------------------------------
# executor context: live distributed execution of the coded GEMMs
# ---------------------------------------------------------------------------
# The executor — a stateful thread pool — rides a thread-local context
# rather than the (hashable, frozen) config.  The serving engine sets it
# around the batches it serves (serving/engine.py).

_EXECUTOR_TLS = threading.local()


@contextlib.contextmanager
def coded_executor(executor):
    """Route this thread's coded GEMMs through an execution backend — the
    threaded ``repro_torch.dist.CodedExecutor`` pool."""
    prev = getattr(_EXECUTOR_TLS, "executor", None)
    _EXECUTOR_TLS.executor = executor
    try:
        yield executor
    finally:
        _EXECUTOR_TLS.executor = prev


def current_executor():
    return getattr(_EXECUTOR_TLS, "executor", None)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's fields, with ``dtype`` a ``torch.dtype``.  The
    reference's execution hints ``remat``, ``unstacked_exec`` and
    ``attn_unroll`` are kept so that configurations compare field by field;
    the eager port has nothing for them to change."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # defaults to d_model // n_heads
    act: str = "silu"                    # "silu" | "geglu" (gated GELU) | "gelu"
    gated: bool = True
    qk_norm: bool = False
    rope_theta: float = 1e4
    block: str = "attn"                  # "attn" | "mamba"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # hybrid (zamba2): shared attention block every `period` mamba layers
    shared_attn_period: int = 0
    # attention variant
    sliding_window: int = 0              # 0 = full causal
    # modality frontend ("none" | "audio" | "vision") — stub embeddings
    frontend: str = "none"
    dtype: Any = torch.bfloat16
    # attention block sizes
    block_q: int = 512
    block_k: int = 512
    ssm_chunk: int = 128
    # CoCoI coded execution of the type-1 GEMMs (FFN projections):
    # (coded_n, coded_k) > 0 routes every dense-FFN matmul through the
    # coded pipeline under ``coded_scheme`` (any name registered in
    # core/schemes.py)
    coded_n: int = 0
    coded_k: int = 0
    coded_scheme: str = "mds"
    # fuse each dense FFN into ONE coded token segment (selection schemes)
    coded_segment: bool = False
    remat: bool = False
    unstacked_exec: bool = False
    attn_unroll: bool = False
    # flash-attention custom VJP: not ported yet
    flash_vjp: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256; logits of the padding rows
        are masked to -1e30."""
        return -(-self.vocab // 256) * 256

    @property
    def ssm_dims(self) -> SSMDims:
        return SSMDims(self.d_model, self.ssm_state, self.ssm_expand,
                       self.ssm_head_dim, self.ssm_conv)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kind(self, i: int) -> str:
        if self.block == "mamba":
            return "mamba"
        return "moe" if self.is_moe else "attn"

    def has_shared_attn(self, i: int) -> bool:
        p = self.shared_attn_period
        return p > 0 and (i % p == p - 1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_attn(gen, cfg: ModelConfig, dev) -> dict:
    D, H, K, P = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": lecun_init(gen, (D, H, P), cfg.dtype, fan_in=D, device=dev),
        "wk": lecun_init(gen, (D, K, P), cfg.dtype, fan_in=D, device=dev),
        "wv": lecun_init(gen, (D, K, P), cfg.dtype, fan_in=D, device=dev),
        "wo": lecun_init(gen, (H, P, D), cfg.dtype, fan_in=H * P, device=dev),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((P,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.zeros((P,), dtype=torch.float32, device=dev)
    return p


def _init_ffn(gen, cfg: ModelConfig, dev) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"w_in": lecun_init(gen, (D, Fd), cfg.dtype, fan_in=D, device=dev),
         "w_out": lecun_init(gen, (Fd, D), cfg.dtype, fan_in=Fd, device=dev)}
    if cfg.gated:
        p["w_gate"] = lecun_init(gen, (D, Fd), cfg.dtype, fan_in=D,
                                 device=dev)
    return p


def _init_layer(cfg: ModelConfig, kind: str, gen, dev) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=dev)
    if kind == "mamba":
        return {"norm": zeros(),
                "mamba": init_mamba_params(gen, cfg.ssm_dims, cfg.dtype,
                                           device=dev)}
    if kind == "moe":
        raise NotImplementedError(f"the MoE FFN {_NOT_PORTED}")
    return {"attn_norm": zeros(), "attn": _init_attn(gen, cfg, dev),
            "ffn_norm": zeros(), "ffn": _init_ffn(gen, cfg, dev)}


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device: str | torch.device = "cuda") -> dict:
    """Parameters in the reference's layout (``layers`` a per-layer list),
    drawn from ``gen`` on the generator's device and kept on ``device``.
    Not the reference's random bits: parity tests carry its parameters
    across with ``repro_torch.convert.model_params_from_numpy``."""
    dev = resolve_device(device)
    layers = [_init_layer(cfg, cfg.layer_kind(i), gen, dev)
              for i in range(cfg.n_layers)]
    params = {
        "layers": layers,
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=dev),
        "embed": lecun_init(gen, (cfg.padded_vocab, cfg.d_model), cfg.dtype,
                            fan_in=cfg.d_model, device=dev),
    }
    if cfg.shared_attn_period:
        params["shared_attn"] = {
            "attn_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                     device=dev),
            "attn": _init_attn(gen, cfg, dev),
            "ffn_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                    device=dev),
            "ffn": _init_ffn(gen, dataclasses.replace(
                cfg, d_ff=cfg.d_ff or 4 * cfg.d_model), dev),
        }
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "geglu" or cfg.act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


@functools.lru_cache(maxsize=64)
def _coded_scheme(name: str, n: int, k: int | None):
    """Scheme instances are immutable and fully determined by (name, n, k);
    building one (LT walks seeds doing rank probes) must not happen per
    GEMM."""
    from ..core.schemes import get_scheme

    return get_scheme(name).make(n, k)


def _matmul(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor
            ) -> torch.Tensor:
    """Type-1 GEMM; coded execution under cfg.coded_scheme when configured."""
    shape = x.shape
    tokens = 1
    for d in shape[:-1]:
        tokens *= d
    if cfg.coded_n:
        from ..core.coded_linear import coded_matmul

        code = _coded_scheme(cfg.coded_scheme, cfg.coded_n,
                             cfg.coded_k or None)
        if tokens >= code.k:
            flat = x.reshape(-1, shape[-1]).float()
            ex = current_executor()
            if ex is not None:
                assignment = None
                if hasattr(ex, "plan_matmul"):
                    # backend pre-dispatch hook (dist/executor.py): elastic
                    # fleets move n with the live worker count
                    n_new, k_new, assignment = ex.plan_matmul(
                        code, cfg.coded_scheme, flat.shape[0],
                        flat.shape[1], w.shape[-1])
                    if (n_new is not None
                            or (k_new is not None and k_new != code.k)):
                        code = _coded_scheme(
                            cfg.coded_scheme,
                            n_new if n_new is not None else cfg.coded_n,
                            k_new if k_new is not None else code.k)
                y = coded_matmul(flat, w.float(), code, executor=ex,
                                 assignment=assignment)
            else:
                y = coded_matmul(flat, w.float(), code)
            return y.reshape(*shape[:-1], w.shape[-1]).to(x.dtype)
    # tiny subtasks run on the master (paper footnote 2) — plain GEMM
    return x @ w


def _ffn_segment(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Whole-FFN coded segment (one encode/decode pair), or None when the
    configuration cannot fuse: scheme is a linear mix, or too few tokens."""
    from ..core.coded_linear import coded_ffn_segment
    from ..core.schemes import commutes_elementwise

    if not (cfg.coded_n and cfg.coded_segment
            and commutes_elementwise(cfg.coded_scheme)):
        return None
    code = _coded_scheme(cfg.coded_scheme, cfg.coded_n, cfg.coded_k or None)
    shape = x.shape
    tokens = 1
    for d in shape[:-1]:
        tokens *= d
    if tokens < code.k:
        return None  # master-local, same as _matmul's footnote-2 path
    flat = x.reshape(-1, shape[-1]).float()
    f32 = lambda w: w.float()
    y = coded_ffn_segment(
        flat, f32(p["w_in"]), f32(p["w_out"]), lambda h: _act(cfg, h), code,
        w_gate=f32(p["w_gate"]) if cfg.gated else None,
        executor=current_executor())
    return y.reshape(*shape[:-1], p["w_out"].shape[-1]).to(x.dtype)


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    y = _ffn_segment(cfg, p, x)
    if y is not None:
        return y
    h = _matmul(cfg, x, p["w_in"])
    if cfg.gated:
        h = _act(cfg, _matmul(cfg, x, p["w_gate"])) * h
    else:
        h = _act(cfg, h)
    return _matmul(cfg, h, p["w_out"])


def _moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError(f"the MoE FFN {_NOT_PORTED}")


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    q = torch.einsum("btd,dhp->bthp", x, p["wq"])
    k = torch.einsum("btd,dkp->btkp", x, p["wk"])
    v = torch.einsum("btd,dkp->btkp", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _attention(cfg: ModelConfig, q, k, v, window: int) -> torch.Tensor:
    if cfg.flash_vjp:
        raise NotImplementedError(f"flash_causal_attention {_NOT_PORTED}")
    return blockwise_causal_attention(q, k, v, window=window,
                                      block_q=cfg.block_q,
                                      block_k=cfg.block_k)


def _attn_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, window: int) -> torch.Tensor:
    q, k, v = _qkv(cfg, p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = _attention(cfg, q, k, v, window)
    return torch.einsum("bthp,hpd->btd", o, p["wo"])


def _attn_block_full(cfg: ModelConfig, layer: dict, x: torch.Tensor,
                     positions: torch.Tensor, window: int,
                     ffn_key: str) -> torch.Tensor:
    h = x + _attn_full(cfg, layer["attn"], rms_norm(x, layer["attn_norm"]),
                       positions, window)
    y = rms_norm(h, layer["ffn_norm"])
    if ffn_key == "moe":
        return h + _moe_ffn(cfg, layer["moe"], y)
    return h + _ffn(cfg, layer["ffn"], y)


# ---------------------------------------------------------------------------
# forward (scoring)
# ---------------------------------------------------------------------------

def _embed_in(cfg: ModelConfig, params: dict, tokens=None, embeds=None):
    if embeds is not None:
        return embeds.to(cfg.dtype)
    emb = params["embed"]
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                         device=emb.device)
    return emb[torch.as_tensor(tokens, device=emb.device).long()] * scale


def _lm_head(cfg: ModelConfig, params: dict, x: torch.Tensor
             ) -> torch.Tensor:
    """Tied-embedding LM head; padding vocab rows are masked to -1e30."""
    logits = (x @ params["embed"].T).float()
    if cfg.padded_vocab > cfg.vocab:
        logits[..., cfg.vocab:] = -1e30
    return logits


def _layer_ffn_key(cfg: ModelConfig, i: int) -> str:
    return "moe" if cfg.layer_kind(i) == "moe" else "ffn"


def forward(cfg: ModelConfig, params: dict, tokens=None, embeds=None,
            window: int | None = None) -> torch.Tensor:
    """Full-sequence causal LM forward. Returns logits (B, T, V_padded)."""
    x = _embed_in(cfg, params, tokens, embeds)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)
    win = cfg.sliding_window if window is None else window
    for i, layer in enumerate(params["layers"]):
        if cfg.layer_kind(i) == "mamba":
            y, _ = mamba_forward(layer["mamba"], rms_norm(x, layer["norm"]),
                                 cfg.ssm_dims, cfg.ssm_chunk)
            x = x + y
            if cfg.has_shared_attn(i):
                x = _attn_block_full(cfg, params["shared_attn"], x,
                                     positions, win, "ffn")
        else:
            x = _attn_block_full(cfg, layer, x, positions, win,
                                 _layer_ffn_key(cfg, i))
    x = rms_norm(x, params["final_norm"])
    return _lm_head(cfg, params, x)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def _kv(cfg: ModelConfig, batch: int, S: int, dev) -> dict:
    K, P = cfg.n_kv_heads, cfg.hd
    return {"k": torch.zeros((batch, S, K, P), dtype=cfg.dtype, device=dev),
            "v": torch.zeros((batch, S, K, P), dtype=cfg.dtype, device=dev)}


def _mamba_cache(cfg: ModelConfig, batch: int, dev) -> dict:
    d = cfg.ssm_dims
    return {
        "conv": torch.zeros((batch, d.conv_dim, d.conv_width - 1),
                            dtype=cfg.dtype, device=dev),
        "ssm": torch.zeros((batch, d.n_heads, d.head_dim, d.d_state),
                           dtype=torch.float32, device=dev),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device: str | torch.device = "cuda") -> dict:
    """KV ring caches (window-capped) / Mamba states + position, one entry
    per layer."""
    dev = resolve_device(device)
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    layers = []
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "mamba":
            entry = {"mamba": _mamba_cache(cfg, batch, dev)}
            if cfg.has_shared_attn(i):
                entry["shared_kv"] = _kv(cfg, batch, S, dev)
            layers.append(entry)
        else:
            layers.append({"kv": _kv(cfg, batch, S, dev)})
    return {"layers": layers,
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def _attn_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, kv: dict, pos
                 ) -> tuple[torch.Tensor, dict]:
    B = x.shape[0]
    q, k, v = _qkv(cfg, p, x)
    q = rope_at(q, pos, cfg.rope_theta)
    k = rope_at(k, pos, cfg.rope_theta)
    S = kv["k"].shape[1]
    slot = (torch.as_tensor(pos, device=x.device) % S).long()
    if slot.dim():  # (B,) per-lane positions: each lane writes its own slot
        lanes = torch.arange(B, device=x.device)
        k_cache = kv["k"].index_put((lanes, slot), k[:, 0].to(kv["k"].dtype))
        v_cache = kv["v"].index_put((lanes, slot), v[:, 0].to(kv["v"].dtype))
    else:
        k_cache = kv["k"].index_copy(1, slot.reshape(1), k.to(kv["k"].dtype))
        v_cache = kv["v"].index_copy(1, slot.reshape(1), v.to(kv["v"].dtype))
    o = decode_attention(q, k_cache, v_cache, pos)
    out = torch.einsum("bthp,hpd->btd", o, p["wo"])
    return out, {"k": k_cache, "v": v_cache}


def _attn_block_decode(cfg, layer, x, kv, pos, ffn_key):
    a, kv = _attn_decode(cfg, layer["attn"], rms_norm(x, layer["attn_norm"]),
                         kv, pos)
    h = x + a
    y = rms_norm(h, layer["ffn_norm"])
    if ffn_key == "moe":
        return h + _moe_ffn(cfg, layer["moe"], y), kv
    return h + _ffn(cfg, layer["ffn"], y), kv


def _mamba_block_decode(cfg, layer, x, entry, pos):
    state = MambaState(conv=entry["mamba"]["conv"], ssm=entry["mamba"]["ssm"])
    y, st = mamba_step(layer["mamba"], rms_norm(x, layer["norm"]), state,
                       cfg.ssm_dims)
    return x + y, {"mamba": {"conv": st.conv, "ssm": st.ssm}}


def decode_step(cfg: ModelConfig, params: dict, cache: dict, token=None,
                embed=None) -> tuple[torch.Tensor, dict]:
    """One serving step: next-token logits given a populated cache.

    token: (B, 1) int or embed: (B, 1, D).  Returns (logits (B, 1, V),
    updated cache).  ``cache["pos"]`` may be a scalar (every row at the same
    depth) or a (B,) vector of per-request positions.  The cache given is
    not modified: the step returns new tensors.
    """
    x = _embed_in(cfg, params, token, embed)
    pos = cache["pos"]
    new_layers = []
    for i, layer in enumerate(params["layers"]):
        entry = dict(cache["layers"][i])
        if cfg.layer_kind(i) == "mamba":
            x, st = _mamba_block_decode(cfg, layer, x, entry, pos)
            entry.update(st)
            if cfg.has_shared_attn(i):
                x, entry["shared_kv"] = _attn_block_decode(
                    cfg, params["shared_attn"], x, entry["shared_kv"], pos,
                    "ffn")
        else:
            x, entry["kv"] = _attn_block_decode(
                cfg, layer, x, entry["kv"], pos, _layer_ffn_key(cfg, i))
        new_layers.append(entry)
    x = rms_norm(x, params["final_norm"])
    logits = _lm_head(cfg, params, x)
    return logits, {"layers": new_layers, "pos": pos + 1}


def supports_prefill_pack(cfg: ModelConfig) -> bool:
    """Whether mixed-length packed prefill / chunked prefill resume are
    EXACT for this architecture: dense attention only (SSM state integrates
    padding, MoE capacity couples tokens, sliding windows wrap the ring)."""
    return (cfg.block == "attn" and not cfg.is_moe
            and cfg.sliding_window == 0 and cfg.shared_attn_period == 0)


def prefill(cfg: ModelConfig, params: dict, tokens=None, embeds=None,
            max_seq: int | None = None, lens=None
            ) -> tuple[torch.Tensor, dict]:
    """Process a full prompt, returning (last-position logits (B, 1, V),
    cache).

    ``max_seq`` sizes the KV ring cache (prompt + planned generation);
    sliding-window archs cap it at the window.  ``lens`` (B,) enables
    packed mixed-length prefill, exact only for ``supports_prefill_pack``
    architectures: each lane's logits are gathered at ``lens[b] - 1`` and
    the cache carries per-lane positions.
    """
    if lens is not None and not supports_prefill_pack(cfg):
        raise ValueError(
            "lens= (packed mixed-length prefill) needs an architecture "
            "where right-padding is invisible to real tokens: dense attn, "
            "no MoE routing, no SSM state, no sliding window "
            f"(got block={cfg.block!r}, n_experts={cfg.n_experts}, "
            f"sliding_window={cfg.sliding_window})")
    x = _embed_in(cfg, params, tokens, embeds)
    B, T, _ = x.shape
    dev = x.device
    positions = torch.arange(T, device=dev)
    max_seq = max_seq or T
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    win = cfg.sliding_window
    layers = []
    for i, layer in enumerate(params["layers"]):
        entry = {}
        if cfg.layer_kind(i) == "mamba":
            y, st = mamba_forward(layer["mamba"], rms_norm(x, layer["norm"]),
                                  cfg.ssm_dims, cfg.ssm_chunk)
            x = x + y
            entry["mamba"] = {"conv": st.conv, "ssm": st.ssm}
            if cfg.has_shared_attn(i):
                x, entry["shared_kv"] = _prefill_attn(
                    cfg, params["shared_attn"], x, positions, win, S, "ffn")
        else:
            x, entry["kv"] = _prefill_attn(cfg, layer, x, positions, win, S,
                                           _layer_ffn_key(cfg, i))
        layers.append(entry)
    x = rms_norm(x, params["final_norm"])
    if lens is None:
        logits = _lm_head(cfg, params, x[:, -1])
        cache = {"layers": layers,
                 "pos": torch.tensor(T, dtype=torch.int32, device=dev)}
    else:
        lens = torch.as_tensor(lens, device=dev).to(torch.int32)
        x_last = x[torch.arange(B, device=dev), lens.long() - 1]
        logits = _lm_head(cfg, params, x_last)
        cache = {"layers": layers, "pos": lens}
    return logits[:, None], cache


def _prefill_attn(cfg, layer, x, positions, win, S, ffn_key):
    """Attention block over the full prompt that also emits the ring cache."""
    p = layer["attn"]
    q, k, v = _qkv(cfg, p, rms_norm(x, layer["attn_norm"]))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = _attention(cfg, q, k, v, win)
    h = x + torch.einsum("bthp,hpd->btd", o, p["wo"])
    y = rms_norm(h, layer["ffn_norm"])
    if ffn_key == "moe":
        out = h + _moe_ffn(cfg, layer["moe"], y)
    else:
        out = h + _ffn(cfg, layer["ffn"], y)
    # ring cache: the last min(S, T) positions, placed so that slot = pos % S
    T = k.shape[1]
    if S >= T:
        tail_k = F.pad(k, (0, 0, 0, 0, 0, S - T))
        tail_v = F.pad(v, (0, 0, 0, 0, 0, S - T))
    else:
        roll = (T - S) % S
        tail_k = torch.roll(k[:, -S:], shifts=roll, dims=1)
        tail_v = torch.roll(v[:, -S:], shifts=roll, dims=1)
    return out, {"k": tail_k, "v": tail_v}


def prefill_resume(cfg: ModelConfig, params: dict, cache: dict, tokens):
    """Chunked prefill resume (``chunk_attention``) is not ported yet."""
    raise NotImplementedError(f"prefill_resume {_NOT_PORTED}")
