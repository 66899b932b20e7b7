"""Unified decoder model (the port of ``repro.models.model``).

One functional model with a per-layer ``block_kind`` pattern:

* ``attn``  — pre-norm GQA/MQA attention (+ optional qk_norm, sliding
              window) followed by a dense (optionally gated) FFN.
* ``moe``   — attention followed by a top-k routed mixture-of-experts FFN
              (capacity-based dispatch; the experts' products are batched
              GEMMs outside the coded pipeline, as in the reference).
* ``mamba`` — Mamba2 SSD block (models/ssm.py), whose chunk runs the SSD
              kernel.

Hybrid architectures (zamba2) interleave ``mamba`` blocks with a *shared*
attention block applied every ``shared_attn_period`` layers (single weight
set, Zamba2-style).  Audio/VLM architectures take precomputed frame/patch
embeddings instead of token ids (``models/frontends.py``).

A :class:`HybridMoEConfig` (granite-4.0-h) lists each layer's mixer
(``layer_types``: a Mamba2 block or an attention block with its own
weights) and follows every layer, whatever its mixer, by the same FFN: a
dropless mixture of experts over the experts this device holds
(``models/moe.py``) plus a dense SiLU-gated shared expert, whose GEMMs are
coded like every dense FFN's; both branches of each layer are added to the
residual stream times ``residual_scale``.

Parameters are nested dicts with the reference's names and layouts, with
one difference: ``params["layers"]`` is always a per-layer list (the
reference stacks homogeneous layers for ``lax.scan``; the port runs
eagerly, layer by layer, in Python), and so is ``cache["layers"]``.
``repro_torch.convert`` unstacks the reference's parameters.

The dense FFN's GEMMs are the paper's type-1 operators: with ``coded_n``
set they run through ``core/coded_linear.py`` (split, encode, n piece
GEMMs, decode at the k-th arrival) — on the worker pool when an executor
is installed with :func:`coded_executor`.

Serving's :func:`prefill` and :func:`decode_step` run each layer in a
``repro.model.mamba`` or ``repro.model.attn`` span (a shared attention
block, FFN included, is its own ``attn`` span; a hybrid layer's FFN is a
``repro.model.moe`` span after its mixer's) and the final norm and LM
head in ``repro.model.head`` (``telemetry.trace.span``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .._device import resolve_device
from ..telemetry.trace import span
from .attention import (blockwise_causal_attention, chunk_attention,
                        decode_attention, flash_causal_attention)
from .common import (gather_fsdp, lecun_init, lookup, rms_norm, rope,
                     rope_at, settle, unshard)
from .moe import current_counters, dropless_moe
from .ssm import (SSMDims, MambaState, init_mamba_params, mamba_forward,
                  mamba_step)

__all__ = ["ModelConfig", "HybridMoEConfig", "init_params", "forward",
           "prefill", "prefill_resume", "supports_prefill_pack",
           "decode_step", "init_cache", "param_count", "coded_executor",
           "current_executor"]

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
    """The reference's fields, with ``dtype`` a ``torch.dtype``.  ``remat``
    recomputes each layer's activations in the backward (the reference's
    ``jax.checkpoint`` per layer, here ``torch.utils.checkpoint``).  The
    reference's execution hints ``unstacked_exec`` and ``attn_unroll`` are
    kept so that configurations compare field by field; the eager port has
    nothing for them to change."""

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
    # attention through ``flash_causal_attention`` (its backward recomputes
    # the probabilities from the saved log-sum-exp)
    flash_vjp: bool = False

    # The settings a HybridMoEConfig makes fields of, as plain class
    # attributes and properties here (ModelConfig's fields are the
    # reference's, one for one), at the values every configuration of the
    # reference computes with: no per-layer mixer list, unscaled residuals
    # and logits, RoPE, the attention's own 1/sqrt(head size) (None) and
    # RMSNorm's eps 1e-6; all experts held and sqrt(d_model) on the
    # embedding, below.
    layer_types = ()
    shared_d_ff = 0
    residual_scale = 1.0
    logits_scale = 1.0
    attn_scale = None
    positional = "rope"
    norm_eps = 1e-6

    @property
    def experts_held(self) -> int:
        return self.n_experts

    @property
    def embed_scale(self) -> float:
        return self.d_model ** 0.5

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


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """A decoder whose layers each have a mixer of their own kind,
    ``layer_types[i]`` ("mamba" or "attn", each with its own weights),
    followed by the same FFN: the dropless top-``top_k`` mixture over
    ``n_experts`` routed experts ``d_ff`` wide, of which this device holds
    the first ``experts_held`` (None: all of them), plus a SiLU-gated
    shared expert ``shared_d_ff`` wide.  ``embed_scale`` multiplies
    the embedding (None: sqrt(d_model)), ``residual_scale`` each branch
    added to the residual stream, the logits are divided by
    ``logits_scale``, ``attn_scale`` multiplies the attention scores (None:
    1/sqrt(head size)), ``positional`` is "rope" or "nope" (no positions),
    and every RMSNorm takes ``norm_eps``."""

    layer_types: tuple = ()
    experts_held: int | None = None
    shared_d_ff: int = 0
    embed_scale: float | None = None
    residual_scale: float = 1.0
    logits_scale: float = 1.0
    attn_scale: float | None = None
    positional: str = "rope"
    norm_eps: float = 1e-6

    def __post_init__(self):
        for name, value in (("experts_held", self.n_experts),
                            ("embed_scale", self.d_model ** 0.5)):
            if getattr(self, name) is None:
                object.__setattr__(self, name, value)
        if len(self.layer_types) != self.n_layers or not set(
                self.layer_types) <= {"mamba", "attn"}:
            raise ValueError(f"layer_types must name 'mamba' or 'attn' for "
                             f"each of the {self.n_layers} layers")
        if self.positional not in ("rope", "nope"):
            raise ValueError(f"unknown positional {self.positional!r}")

    def layer_kind(self, i: int) -> str:
        return self.layer_types[i]


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


def _init_experts(gen, shape, dtype, fan_in: int, dev) -> torch.Tensor:
    """An (E, a, b) expert tensor drawn expert by expert: ``lecun_init``
    draws its whole shape in f32 before the cast, which for kimi-k2's
    (384, 7168, 2048) would be a 22.5 GB temporary per tensor; one
    expert's f32 slab is 1/E of that."""
    w = torch.empty(shape, dtype=dtype, device=dev)
    if w.device.type == "meta":  # shapes only: nothing is drawn
        return w
    for e in range(shape[0]):
        w[e] = lecun_init(gen, shape[1:], dtype, fan_in=fan_in, device=dev)
    return w


def _init_moe(gen, cfg: ModelConfig, dev) -> dict:
    """Router ``(D, E)`` in f32 whatever ``cfg.dtype``; the held experts'
    ``w_in``, ``w_gate`` ``(H, D, F)`` and ``w_out`` ``(H, F, D)`` in
    ``cfg.dtype`` (H = E unless the configuration holds a share)."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    H = cfg.experts_held
    return {
        "router": lecun_init(gen, (D, E), torch.float32, fan_in=D,
                             device=dev),
        "w_in": _init_experts(gen, (H, D, Fd), cfg.dtype, D, dev),
        "w_gate": _init_experts(gen, (H, D, Fd), cfg.dtype, D, dev),
        "w_out": _init_experts(gen, (H, Fd, D), cfg.dtype, Fd, dev),
    }


def _init_layer(cfg: ModelConfig, kind: str, gen, dev) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=dev)
    if cfg.layer_types:  # the mixer, then the experts and the shared expert
        layer = ({"norm": zeros(),
                  "mamba": init_mamba_params(gen, cfg.ssm_dims, cfg.dtype,
                                             device=dev)}
                 if kind == "mamba" else
                 {"attn_norm": zeros(), "attn": _init_attn(gen, cfg, dev)})
        layer.update(ffn_norm=zeros(), moe=_init_moe(gen, cfg, dev),
                     shared=_init_ffn(gen, dataclasses.replace(
                         cfg, d_ff=cfg.shared_d_ff), dev))
        return layer
    if kind == "mamba":
        return {"norm": zeros(),
                "mamba": init_mamba_params(gen, cfg.ssm_dims, cfg.dtype,
                                           device=dev)}
    layer = {"attn_norm": zeros(), "attn": _init_attn(gen, cfg, dev),
             "ffn_norm": zeros()}
    if kind == "moe":
        layer["moe"] = _init_moe(gen, cfg, dev)
    else:
        layer["ffn"] = _init_ffn(gen, cfg, dev)
    return layer


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
                # the source weight: the backend casts it inside the op, so
                # a bf16 weight keeps one pointer (the mesh's graph key)
                # and no f32 copy of it outlives the call
                y = coded_matmul(flat, w, code, executor=ex,
                                 assignment=assignment)
            else:
                y = coded_matmul(flat, w, code)
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
    y = coded_ffn_segment(
        flat, p["w_in"], p["w_out"], lambda h: _act(cfg, h), code,
        w_gate=p["w_gate"] if cfg.gated else None,
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


def moe_route(cfg: ModelConfig, router: torch.Tensor, flat: torch.Tensor):
    """Top-k routing with capacity for ``flat`` (Tt, D) tokens.

    Returns ``(gates (Tt, K) f32, eid (Tt*K,), pos (Tt*K,), keep (Tt*K,),
    C)``: the renormalised gates, each (token, slot)'s expert, its
    exclusive position among that expert's slots in flattened (Tt*K)
    order, whether it fits the capacity ``C = ceil(Tt*K/E *
    capacity_factor)``, and C.  ``(~keep).sum()`` is the number of
    dropped slots."""
    E, K = cfg.n_experts, cfg.top_k
    Tt = flat.shape[0]
    logits = flat.float() @ router                           # (Tt, E)
    gates, idx = torch.topk(torch.softmax(logits, dim=-1), K, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    C = math.ceil(Tt * K / E * cfg.capacity_factor)
    eid = idx.reshape(-1)                                    # (Tt*K,)
    # int32: kimi-k2's table at 2048 prefill tokens is 16384 x 384
    onehot = F.one_hot(eid, E).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = pos_in_e.gather(1, eid[:, None])[:, 0]
    return gates, eid, pos, pos < C, C


def _moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Top-k routed MoE with capacity-based dispatch (the reference's
    ``_moe_ffn``).

    x: (B, T, D).  Each token goes to its top_k experts; each expert takes
    at most C slots (``moe_route``), the rest are dropped.  The kept slots
    are written into an (E, C, D) buffer by plain indexed assignment (the
    kept (expert, position) pairs are unique, so this is the reference's
    scatter-add, deterministic on the card), the experts run as three
    batched GEMMs, and each token sums its slots' outputs weighted by the
    gates in f32.  Every shape is known before the data: a dropped slot
    writes to a spare row past the buffer's E * C and reads back a zero,
    so no op has a data-dependent size (the dry-run runs this on fake
    tensors)."""
    Bsz, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    flat = x.reshape(-1, D)
    Tt = flat.shape[0]
    gates, eid, pos, keep, C = moe_route(cfg, p["router"], flat)
    counters = current_counters()
    if counters is not None:
        counters.count(Tt, rows=keep.sum(), dropped=(~keep).sum())
    slot = eid * C + pos                                     # (Tt*K,)
    token = torch.arange(Tt * K, device=x.device) // K
    rows = flat.new_zeros((E * C + 1, D))
    rows[torch.where(keep, slot, E * C)] = flat[token]
    buf = rows[:E * C].view(E, C, D)

    h = torch.bmm(buf, p["w_in"])                            # (E, C, F)
    g = _act(cfg, torch.bmm(buf, p["w_gate"]))
    out_e = torch.bmm(g * h, p["w_out"])                     # (E, C, D)

    picked = out_e.reshape(E * C, D)[torch.where(keep, slot, 0)]
    gathered = torch.where(keep[:, None], picked,
                           torch.zeros((), dtype=out_e.dtype, device=x.device))
    combined = (gathered.reshape(Tt, K, D).float()
                * gates[..., None]).sum(dim=1)
    return combined.to(x.dtype).reshape(Bsz, T, D)


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    q = settle(torch.einsum("btd,dhp->bthp", x, unshard(p["wq"], 2)))
    k = settle(torch.einsum("btd,dkp->btkp", x, unshard(p["wk"], 2)))
    v = settle(torch.einsum("btd,dkp->btkp", x, unshard(p["wv"], 2)))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _place(cfg: ModelConfig, q, k, positions):
    """q and k at their positions: rotated (RoPE), or as they are when the
    configuration has no positional encoding (NoPE)."""
    if cfg.positional == "nope":
        return q, k
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta))


def _place_at(cfg: ModelConfig, q, k, pos):
    if cfg.positional == "nope":
        return q, k
    return rope_at(q, pos, cfg.rope_theta), rope_at(k, pos, cfg.rope_theta)


def _attention(cfg: ModelConfig, q, k, v, window: int) -> torch.Tensor:
    if cfg.flash_vjp:
        return flash_causal_attention(q, k, v, window, cfg.block_q,
                                      cfg.block_k, cfg.attn_scale)
    return blockwise_causal_attention(q, k, v, window=window,
                                      block_q=cfg.block_q,
                                      block_k=cfg.block_k,
                                      scale=cfg.attn_scale)


def _attn_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, window: int) -> torch.Tensor:
    q, k, v = _qkv(cfg, p, x)
    q, k = _place(cfg, q, k, positions)
    o = _attention(cfg, q, k, v, window)
    return torch.einsum("bthp,hpd->btd", o, unshard(p["wo"], 1))


def _attn_block_full(cfg: ModelConfig, layer: dict, x: torch.Tensor,
                     positions: torch.Tensor, window: int,
                     ffn_key: str) -> torch.Tensor:
    h = x + _attn_full(cfg, layer["attn"], rms_norm(x, layer["attn_norm"]),
                       positions, window)
    y = rms_norm(h, layer["ffn_norm"])
    if ffn_key == "moe":
        return h + _moe_ffn(cfg, layer["moe"], y)
    return h + _ffn(cfg, layer["ffn"], y)


def _residual(cfg: ModelConfig, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """x + residual_scale * y, in one op, in x's type."""
    return torch.add(x, y, alpha=cfg.residual_scale).to(x.dtype)


def _hybrid_ffn(cfg: ModelConfig, layer: dict, h: torch.Tensor
                ) -> torch.Tensor:
    """A hybrid layer's FFN (a ``repro.model.moe`` span): the held
    experts' part of the routed mixture plus the shared expert, whose GEMMs
    are coded (``_ffn``), both on RMSNorm(h), added to h scaled."""
    with span("model.moe"):
        u = rms_norm(h, layer["ffn_norm"], cfg.norm_eps)
        routed = dropless_moe(layer["moe"], u, cfg.top_k)
        return _residual(cfg, h, routed + _ffn(cfg, layer["shared"], u))


def _hybrid_layer(cfg: ModelConfig, layer: dict, x: torch.Tensor, i: int,
                  positions: torch.Tensor, win: int, S: int):
    """Layer ``i`` of a hybrid configuration over a whole prompt: its mixer
    (a ``repro.model.mamba`` or ``repro.model.attn`` span) and its FFN.
    Returns (x, the layer's cache entry sized for ``S`` positions)."""
    eps = cfg.norm_eps
    if cfg.layer_kind(i) == "mamba":
        with span("model.mamba"):
            y, st = mamba_forward(layer["mamba"],
                                  rms_norm(x, layer["norm"], eps),
                                  cfg.ssm_dims, cfg.ssm_chunk, eps=eps)
            x = settle(_residual(cfg, x, y))
        entry = {"mamba": {"conv": st.conv, "ssm": st.ssm}}
    else:
        with span("model.attn"):
            a, kv = _prefill_attn_mixer(cfg, layer["attn"],
                                        rms_norm(x, layer["attn_norm"], eps),
                                        positions, win, S)
            x = settle(_residual(cfg, x, a))
        entry = {"kv": kv}
    return settle(_hybrid_ffn(cfg, layer, x)), entry


def _hybrid_layer_decode(cfg: ModelConfig, layer: dict, x: torch.Tensor,
                         i: int, entry: dict, pos):
    """One decode step of hybrid layer ``i``: (x, the entry's new state)."""
    eps = cfg.norm_eps
    if cfg.layer_kind(i) == "mamba":
        with span("model.mamba"):
            state = MambaState(conv=entry["mamba"]["conv"],
                               ssm=entry["mamba"]["ssm"])
            y, st = mamba_step(layer["mamba"],
                               rms_norm(x, layer["norm"], eps), state,
                               cfg.ssm_dims, eps=eps)
            x = settle(_residual(cfg, x, y))
        new = {"mamba": {"conv": st.conv, "ssm": st.ssm}}
    else:
        with span("model.attn"):
            a, kv = _attn_decode(cfg, layer["attn"],
                                 rms_norm(x, layer["attn_norm"], eps),
                                 entry["kv"], pos)
            x = settle(_residual(cfg, x, a))
        new = {"kv": kv}
    return settle(_hybrid_ffn(cfg, layer, x)), new


# ---------------------------------------------------------------------------
# forward (scoring)
# ---------------------------------------------------------------------------

def _embed_in(cfg: ModelConfig, params: dict, tokens=None, embeds=None):
    if embeds is not None:
        return embeds.to(cfg.dtype)
    # the lookup reads the whole table (on the dry-run's DTensors too)
    emb = unshard(gather_fsdp(params["embed"]), 0)
    scale = torch.tensor(cfg.embed_scale, dtype=cfg.dtype,
                         device=emb.device)
    return lookup(emb, torch.as_tensor(tokens, device=emb.device).long()) \
        * scale


def _lm_head(cfg: ModelConfig, params: dict, x: torch.Tensor
             ) -> torch.Tensor:
    """Tied-embedding LM head, divided by ``logits_scale``; padding vocab
    rows are masked to -1e30 (by a select, which writes the values an
    in-place fill writes and has a sharding rule for the dry-run's
    DTensors)."""
    logits = (x @ gather_fsdp(params["embed"]).T).float()
    if cfg.logits_scale != 1.0:
        logits = logits / cfg.logits_scale
    if cfg.padded_vocab > cfg.vocab:
        real = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
        logits = torch.where(real, logits, torch.full(
            (), -1e30, dtype=logits.dtype, device=logits.device))
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

    def mamba_layer(layer, x):
        layer = gather_fsdp(layer)
        y, _ = mamba_forward(layer["mamba"], rms_norm(x, layer["norm"]),
                             cfg.ssm_dims, cfg.ssm_chunk)
        return x + y

    def attn_layer(layer, x, ffn_key="ffn"):
        return _attn_block_full(cfg, gather_fsdp(layer), x, positions, win,
                                ffn_key)

    if cfg.remat and torch.is_grad_enabled():
        # each layer's activations are recomputed in the backward
        remat = lambda fn: functools.partial(
            torch.utils.checkpoint.checkpoint, fn, use_reentrant=False)
        mamba_layer, attn_layer = remat(mamba_layer), remat(attn_layer)
    for i, layer in enumerate(params["layers"]):
        if cfg.layer_types:
            x = _hybrid_layer(cfg, gather_fsdp(layer), x, i, positions, win,
                              T)[0]
        elif cfg.layer_kind(i) == "mamba":
            x = settle(mamba_layer(layer, x))
            if cfg.has_shared_attn(i):
                x = settle(attn_layer(params["shared_attn"], x))
        else:
            x = settle(attn_layer(layer, x, _layer_ffn_key(cfg, i)))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
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
    q, k, v = _qkv(cfg, p, x)
    q, k = _place_at(cfg, q, k, pos)
    S = kv["k"].shape[1]
    slot = (torch.as_tensor(pos, device=x.device) % S).long()
    # the new entry written at its ring slot (each lane its own slot for
    # (B,) per-lane positions) as a select over the slots: the values an
    # indexed copy writes, and an op the dry-run's DTensors can shard
    slots = torch.arange(S, device=x.device)
    hit = (slots == slot[:, None]) if slot.dim() else (slots == slot)[None]
    hit = hit[:, :, None, None]                              # (B|1, S, 1, 1)
    k_cache = torch.where(hit, k.to(kv["k"].dtype), kv["k"])
    v_cache = torch.where(hit, v.to(kv["v"].dtype), kv["v"])
    o = decode_attention(q, k_cache, v_cache, pos, cfg.attn_scale)
    out = torch.einsum("bthp,hpd->btd", o, unshard(p["wo"], 1))
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
        layer = gather_fsdp(layer)
        if cfg.layer_types:
            x, st = _hybrid_layer_decode(cfg, layer, x, i, entry, pos)
            entry.update(st)
        elif cfg.layer_kind(i) == "mamba":
            with span("model.mamba"):
                x, st = _mamba_block_decode(cfg, layer, x, entry, pos)
                x = settle(x)
            entry.update(st)
            if cfg.has_shared_attn(i):
                with span("model.attn"):
                    x, entry["shared_kv"] = _attn_block_decode(
                        cfg, gather_fsdp(params["shared_attn"]), x,
                        entry["shared_kv"], pos, "ffn")
                    x = settle(x)
        else:
            with span("model.attn"):
                x, entry["kv"] = _attn_block_decode(
                    cfg, layer, x, entry["kv"], pos, _layer_ffn_key(cfg, i))
                x = settle(x)
        new_layers.append(entry)
    with span("model.head"):
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
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
        layer = gather_fsdp(layer)
        if cfg.layer_types:
            x, entry = _hybrid_layer(cfg, layer, x, i, positions, win, S)
        elif cfg.layer_kind(i) == "mamba":
            with span("model.mamba"):
                y, st = mamba_forward(layer["mamba"],
                                      rms_norm(x, layer["norm"]),
                                      cfg.ssm_dims, cfg.ssm_chunk)
                x = settle(x + y)
            entry["mamba"] = {"conv": st.conv, "ssm": st.ssm}
            if cfg.has_shared_attn(i):
                with span("model.attn"):
                    x, entry["shared_kv"] = _prefill_attn(
                        cfg, gather_fsdp(params["shared_attn"]), x,
                        positions, win, S, "ffn")
                    x = settle(x)
        else:
            with span("model.attn"):
                x, entry["kv"] = _prefill_attn(cfg, layer, x, positions, win,
                                               S, _layer_ffn_key(cfg, i))
                x = settle(x)
        layers.append(entry)
    with span("model.head"):
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if lens is None:
            logits = _lm_head(cfg, params, x[:, -1])
        else:
            lens = torch.as_tensor(lens, device=dev).to(torch.int32)
            x_last = x[torch.arange(B, device=dev), lens.long() - 1]
            logits = _lm_head(cfg, params, x_last)
    if lens is None:
        cache = {"layers": layers,
                 "pos": torch.tensor(T, dtype=torch.int32, device=dev)}
    else:
        cache = {"layers": layers, "pos": lens}
    return logits[:, None], cache


def _prefill_attn(cfg, layer, x, positions, win, S, ffn_key):
    """Attention block over the full prompt that also emits the ring cache."""
    a, kv = _prefill_attn_mixer(cfg, layer["attn"],
                                rms_norm(x, layer["attn_norm"]), positions,
                                win, S)
    h = x + a
    y = rms_norm(h, layer["ffn_norm"])
    if ffn_key == "moe":
        return h + _moe_ffn(cfg, layer["moe"], y), kv
    return h + _ffn(cfg, layer["ffn"], y), kv


def _prefill_attn_mixer(cfg, p, x, positions, win, S):
    """Attention over the full (normed) prompt ``x``: its output
    projection, and the ring cache of its keys and values."""
    q, k, v = _qkv(cfg, p, x)
    q, k = _place(cfg, q, k, positions)
    o = _attention(cfg, q, k, v, win)
    out = torch.einsum("bthp,hpd->btd", o, unshard(p["wo"], 1))
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


# ---------------------------------------------------------------------------
# chunked prefill: resume a partially-filled cache with the next chunk
# ---------------------------------------------------------------------------

def _attn_resume(cfg: ModelConfig, p: dict, x: torch.Tensor, kv: dict,
                 pos0: torch.Tensor, positions: torch.Tensor
                 ) -> tuple[torch.Tensor, dict]:
    """Chunk attention block: write Tc new K/V slots at [pos0, pos0 + Tc),
    attend causally over the whole cache."""
    q, k, v = _qkv(cfg, p, x)
    q, k = _place(cfg, q, k, positions)
    slots = positions.long()
    k_cache = kv["k"].index_copy(1, slots, k.to(kv["k"].dtype))
    v_cache = kv["v"].index_copy(1, slots, v.to(kv["v"].dtype))
    o = chunk_attention(q, k_cache, v_cache, pos0, cfg.attn_scale)
    out = torch.einsum("bthp,hpd->btd", o, p["wo"])
    return out, {"k": k_cache, "v": v_cache}


def _attn_block_resume(cfg, layer, x, kv, pos0, positions):
    a, kv = _attn_resume(cfg, layer["attn"], rms_norm(x, layer["attn_norm"]),
                         kv, pos0, positions)
    h = x + a
    return h + _ffn(cfg, layer["ffn"], rms_norm(h, layer["ffn_norm"])), kv


def prefill_resume(cfg: ModelConfig, params: dict, cache: dict, tokens
                   ) -> tuple[torch.Tensor, dict]:
    """Extend a partially-prefilled cache by one chunk of prompt tokens.

    tokens: (B, Tc) int; ``cache["pos"]`` must be a SCALAR — every lane of
    a resuming chunk sits at the same depth.  Returns (logits at the
    chunk's last position (B, 1, V), updated cache with ``pos += Tc``).
    The serving primitive behind chunked prefill and prefix-cache hits;
    exact only for ``supports_prefill_pack`` architectures.  The chunk's
    FFN GEMMs take the same coded ``_matmul`` path as every type-1 GEMM.
    The position stays on the device: no host synchronisation here.
    """
    if not supports_prefill_pack(cfg):
        raise ValueError(
            "prefill_resume needs a dense-attention architecture: SSM "
            "state cannot resume from stored KV, MoE capacity routing "
            "couples tokens across chunks, and sliding-window rings wrap "
            f"(got block={cfg.block!r}, n_experts={cfg.n_experts}, "
            f"sliding_window={cfg.sliding_window})")
    x = _embed_in(cfg, params, tokens)
    Tc = x.shape[1]
    pos0 = torch.as_tensor(cache["pos"], device=x.device).to(torch.int32)
    if pos0.dim():
        raise ValueError(
            "prefill_resume needs a scalar cache position: all lanes of a "
            "chunk resume from the same depth (per-lane (B,) positions "
            "mean this cache already joined the decode batch)")
    positions = pos0 + torch.arange(Tc, device=x.device, dtype=torch.int32)
    new_layers = []
    for i, layer in enumerate(params["layers"]):
        entry = dict(cache["layers"][i])
        x, entry["kv"] = _attn_block_resume(cfg, layer, x, entry["kv"],
                                            pos0, positions)
        new_layers.append(entry)
    x = rms_norm(x, params["final_norm"])
    logits = _lm_head(cfg, params, x[:, -1])
    return logits[:, None], {"layers": new_layers, "pos": pos0 + Tc}
