"""Shared model primitives: norms, RoPE, initialisers (the port of
``repro.models.common``)."""
from __future__ import annotations

import torch

from .._device import resolve_device

__all__ = ["rms_norm", "rope", "rope_at", "he_init", "lecun_init", "settle",
           "unshard", "gather_fsdp", "settle_grad", "lookup"]


def settle(x: torch.Tensor) -> torch.Tensor:
    """``x`` sharded over its batch dim only: the counterpart of a
    sharding constraint for the dry-run's DTensors (``launch/dryrun.py``),
    set where a layer ends and where an attention, SSD or expert core
    begins.  A DTensor keeps the mesh dims that shard its dim 0; every
    other placement becomes ``Replicate`` (a sharded dim gathered, a
    partial sum reduced), so the cores fold (batch, heads) pairs in which
    only the batch is sharded.  Plain tensors come back as they are, the
    same object."""
    placements = getattr(x, "placements", None)
    if placements is None:
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(pl if type(pl) is Shard and pl.dim == 0 else Replicate()
                 for pl in placements)
    return x if want == tuple(placements) else x.redistribute(placements=want)


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``, the embedding lookup.  For the dry-run's DTensors it
    runs on the local shards (each rank's tokens against the whole table:
    pass ``unshard``ed and ``gather_fsdp``ed tables): DTensor has no rule
    for the lookup's backward, an indexed accumulate, on torch 2.11, so
    the table's gradient is each rank's local accumulate, a partial sum
    over the data axes.  Plain tensors index as they always did."""
    placements = getattr(table, "placements", None)
    if placements is None:
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not all(isinstance(pl, Replicate) for pl in placements):
        raise ValueError(f"lookup needs a replicated table, got {placements}")
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, table.device_mesh, list(placements),
                                 run_check=False)
    sharded = [not isinstance(pl, Replicate) for pl in idx.placements]
    local = table.to_local(grad_placements=[
        Partial() if s else Replicate() for s in sharded])
    out = local[idx.to_local()]
    return DTensor.from_local(out, table.device_mesh, idx.placements,
                              run_check=False)


def settle_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is :func:`settle`d when it arrives: for a
    DTensor that records a gradient, a hook reduces a partial-sum gradient
    over the model axis before it flows on (into the SSD's backward, whose
    index ops have no sharding rule for a partial sum on torch 2.11).
    Plain tensors come back as they are, no hook."""
    if hasattr(x, "placements") and x.requires_grad:
        x.register_hook(settle)
    return x


def gather_fsdp(tree):
    """The parameters of ``tree`` gathered over the data axes where they
    are used, as FSDP does: for the dry-run's DTensors, every mesh dim but
    ``model`` becomes ``Replicate`` (an all-gather; its backward a
    reduce-scatter), the ``model`` shard stays.  A tree without DTensors
    comes back as it is, the same object."""
    if isinstance(tree, dict):
        out = {k: gather_fsdp(v) for k, v in tree.items()}
        return tree if all(out[k] is tree[k] for k in tree) else out
    placements = getattr(tree, "placements", None)
    if placements is None:
        return tree
    from torch.distributed.tensor import Replicate

    want = [pl if name == "model" else Replicate()
            for name, pl in zip(tree.device_mesh.mesh_dim_names, placements)]
    return tree if tuple(want) == tuple(placements) \
        else tree.redistribute(placements=want)


def unshard(w: torch.Tensor, dim: int) -> torch.Tensor:
    """``w`` with no mesh dim sharding tensor dim ``dim``, for the
    dry-run's DTensors: a projection whose head_dim (the inner factor of
    the (heads, head_dim) pair an einsum flattens) is sharded cannot be
    split back by DTensor's view rule, so that weight is gathered where it
    is used.  Plain tensors come back as they are, the same object."""
    placements = getattr(w, "placements", None)
    if placements is None or not any(
            getattr(pl, "dim", None) == dim for pl in placements):
        return w
    from torch.distributed.tensor import Replicate

    return w.redistribute(placements=[
        Replicate() if getattr(pl, "dim", None) == dim else pl
        for pl in placements])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in f32, cast back to input dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4
         ) -> torch.Tensor:
    """Rotary embedding. x: (B, T, H, P); positions: (T,) or (B, T)."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    # broadcast to (B, T, 1, half)
    while cos.dim() < x.dim() - 1:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_at(x: torch.Tensor, pos, theta: float = 1e4) -> torch.Tensor:
    """RoPE for one decode step. x: (B, 1, H, P); pos: scalar int, or (B,)
    per-request positions (a continuous batch whose lanes are at different
    sequence depths)."""
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[:, None] if pos.dim() else pos[None]  # (B, 1) | (1,)
    return rope(x, positions, theta)


def he_init(gen: torch.Generator, shape, dtype=torch.bfloat16, fan_in=None,
            *, device: str | torch.device = "cuda") -> torch.Tensor:
    """Normal(0, 2 / fan_in) drawn from ``gen`` on the generator's device,
    moved to ``device``; on the ``meta`` device an empty tensor of the
    shape, with nothing drawn."""
    dev = resolve_device(device)
    if dev.type == "meta":  # shapes only: nothing is drawn
        return torch.empty(shape, dtype=dtype, device=dev)
    fan_in = fan_in or shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    w.mul_((2.0 / fan_in) ** 0.5)  # in place: one f32 copy of the shape
    return w.to(device=dev, dtype=dtype)


def lecun_init(gen: torch.Generator, shape, dtype=torch.bfloat16, fan_in=None,
               *, device: str | torch.device = "cuda") -> torch.Tensor:
    """Normal(0, 1 / fan_in) drawn from ``gen`` on the generator's device,
    moved to ``device``; on the ``meta`` device an empty tensor of the
    shape, with nothing drawn."""
    dev = resolve_device(device)
    if dev.type == "meta":  # shapes only: nothing is drawn
        return torch.empty(shape, dtype=dtype, device=dev)
    fan_in = fan_in or shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    w.mul_((1.0 / fan_in) ** 0.5)  # in place: one f32 copy of the shape
    return w.to(device=dev, dtype=dtype)
