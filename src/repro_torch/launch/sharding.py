"""Partitioning rules: param/input/cache specs by tree path, and their
DTensor placements (the port of ``repro.launch.sharding``).

MaxText-style logical rules, applied by leaf key:

* tensor parallelism on the ``model`` axis — attention heads, FFN hidden,
  MoE experts, vocab;
* FSDP on the ``data`` axis (+ ``pod`` when present) over d_model dims —
  this is what lets the ≥30B and the 1T-param MoE configs fit;
* batch (and long-context cache sequence) over the data axes.

The rules are plain Python over shapes and a mesh's ``{axis: extent}``
(``launch.mesh.axis_sizes``: a ``DeviceMesh``, the one-card ``LocalMesh``
or such a mapping).  A spec is a :class:`Spec`, the port's own
``PartitionSpec``: one entry per tensor dim, ``None``, an axis name, or a
tuple of axis names (major first).  :func:`to_placements` turns one into
DTensor placements, one per mesh dim; ``param_shardings``,
``cache_shardings``, ``input_sharding`` and ``piece_sharding`` return
placements.

The port keeps a decoder's layers and caches as per-layer lists where the
reference stacks them with a leading layer dim, for which its rules
prepend a ``None``.  The port's spec of layer i's leaf is the reference's
spec of the stacked leaf without that leading ``None``.  The rules read a
leaf's key and whether ``moe`` is on its path; list indices on the port's
paths are skipped.

GQA note: kv-head counts (1-8) are below the 16-way model axis on several
archs; the rules fall back to sharding the head dim (params) or the cache
sequence (caches) over ``model`` there.
"""
from __future__ import annotations

import math
from typing import Any

from .mesh import MODEL_AXIS, axis_sizes, dp_axes

__all__ = ["Spec", "to_placements", "param_specs", "param_shardings",
           "input_spec", "input_sharding", "cache_specs", "cache_shardings",
           "batch_spec", "piece_spec", "piece_sharding", "decode_block_spec",
           "sanitize", "local_shape", "map_with_path"]


class Spec(tuple):
    """A partition spec: ``Spec("model", None)``, ``Spec(("pod", "data"))``.
    Entries are ``None``, an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"

    def axes(self) -> list[str]:
        """Every axis name the spec uses, in entry order."""
        out = []
        for e in self:
            if e is not None:
                out.extend(e if isinstance(e, tuple) else (e,))
        return out


def map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (a
    :class:`Spec` is a leaf); a path holds dict keys and list indices."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec) \
            and not hasattr(tree, "_fields"):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


# ---------------------------------------------------------------------------
# coded piece placement (core.coded_linear / core.coded_conv sharded forms)
# ---------------------------------------------------------------------------
# The k-of-n coded path places one piece per slice of the worker axis:
# piece-stacked operands/results carry the piece dim FIRST and shard it
# over ``axis``; the master decode shards the flattened feature dim LAST
# (a column-parallel skinny GEMM — every device recovers its own block of
# all k sources from the piece rows it gathered).


def piece_spec(ndim: int, axis: str = MODEL_AXIS) -> Spec:
    """(n_pieces, ...) piece-major stack: pieces over the worker axis."""
    if ndim < 1:
        raise ValueError("piece-stacked arrays need at least the piece dim")
    return Spec(axis, *([None] * (ndim - 1)))


def piece_sharding(mesh, ndim: int, axis: str = MODEL_AXIS) -> tuple:
    return to_placements(piece_spec(ndim, axis), mesh)


def decode_block_spec(ndim: int, axis: str = MODEL_AXIS) -> Spec:
    """(m_pieces, ..., F) gathered stack for decode: feature blocks over
    the worker axis, piece rows replicated (eq. 4's D @ Y is independent
    per output column, so column blocks decode in parallel)."""
    if ndim < 2:
        raise ValueError("decode blocks need (pieces, ..., features) rank>=2")
    return Spec(*([None] * (ndim - 1)), axis)


# ---------------------------------------------------------------------------
# specs -> placements
# ---------------------------------------------------------------------------

def to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)`` on
    every mesh dim that tensor dim d's entry names, ``Replicate()`` on the
    rest.  A tuple entry shards its dim over several mesh dims, the major
    axis first as JAX orders it; DTensor splits over mesh dims in mesh
    order, so the tuple must list its axes in that order.  A mesh dim of
    extent 1 replicates (a shard over one rank is the whole tensor, and
    DTensor's view rules treat a shard there as a real split)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    names = list(sizes)
    out: list = [Replicate()] * len(names)
    used: set = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in sizes:
                raise ValueError(f"spec {spec!r} names {a!r}, not an axis of "
                                 f"the mesh {tuple(names)}")
            if a in used:
                raise ValueError(f"spec {spec!r} uses axis {a!r} twice")
            used.add(a)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: entry {entry!r} lists its axes "
                             f"out of mesh order {tuple(names)}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def _extent(sizes: dict, entry) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(sizes[a] for a in axes)


def local_shape(shape, spec, mesh) -> tuple:
    """One rank's shard shape of a ``shape`` tensor placed by ``spec``
    (entries must divide their dims, as :func:`sanitize` makes them)."""
    sizes = axis_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        e = _extent(sizes, entry)
        if dim % e:
            raise ValueError(f"{entry!r} (extent {e}) does not divide dim "
                             f"{dim} of {tuple(shape)}")
        out.append(dim // e)
    return tuple(out)


def sanitize(spec, shape: tuple, mesh) -> Spec:
    """Drop (or shrink) axis assignments that don't divide the dimension.

    Input shardings must tile evenly.  Tuple entries shrink from the left:
    ('pod','data') -> ('data',) -> None.
    """
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        while axes and dim % _extent(sizes, tuple(axes)):
            axes = tuple(axes)[1:]
        out.append(tuple(axes) if len(axes) > 1 else (axes[0] if axes else None))
    return Spec(*out)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _fsdp(mesh, fsdp: bool):
    return dp_axes(mesh) if fsdp else None


def _spec_candidates(key: str, is_moe: bool, mesh, fsdp: bool) -> list[Spec]:
    """Ordered candidate specs per param kind; the first one that survives
    sanitisation with the model axis intact wins."""
    F = _fsdp(mesh, fsdp)
    M = MODEL_AXIS
    if key == "embed":
        return [Spec(M, F), Spec(None, F)]
    if key in ("wq", "wk", "wv"):
        # (D, H|K, P): heads on model; fall back to head_dim when the head
        # count doesn't divide the axis (MQA/GQA with few kv heads).
        return [Spec(F, M, None), Spec(F, None, M)]
    if key == "wo":
        return [Spec(M, None, F), Spec(None, M, F)]
    if key in ("w_in", "w_gate"):
        if is_moe:  # (E, D, F): expert parallel
            return [Spec(M, F, None)]
        return [Spec(F, M)]
    if key == "w_out":
        if is_moe:  # (E, F, D)
            return [Spec(M, None, F)]
        return [Spec(M, F)]
    if key == "router":
        return [Spec(F, None)]
    if key == "in_proj":  # mamba (D, in_proj_dim)
        return [Spec(F, M)]
    if key == "out_proj":  # mamba (d_inner, D)
        return [Spec(M, F)]
    if key == "conv_w":
        return [Spec(M, None)]
    if key == "conv_b":
        return [Spec(M)]
    if key == "gate_norm":
        return [Spec(M)]
    # norms, A_log, D, dt_bias, q_norm/k_norm, scalars: replicated
    return [Spec()]


def _spec_for_param(path: tuple, shape: tuple, mesh, fsdp: bool) -> Spec:
    keys = [k for k in path if isinstance(k, str)]
    key = keys[-1]
    is_moe = "moe" in keys
    cands = _spec_candidates(key, is_moe, mesh, fsdp)

    def fit(spec: Spec) -> Spec:
        # pad with leading Nones to the leaf rank, cut to it
        spec = tuple(spec)
        if len(spec) < len(shape):
            spec = (None,) * (len(shape) - len(spec)) + spec
        return Spec(*spec[: len(shape)])

    best = None
    for cand in cands:
        s = sanitize(fit(cand), shape, mesh)
        if best is None:
            best = s
        if MODEL_AXIS in s.axes():
            return s
    return best


def param_specs(params: Any, mesh, fsdp: bool = True):
    """Tree of :class:`Spec` matching a tree of tensors (or anything with
    a ``shape``)."""
    return map_with_path(
        lambda path, leaf: _spec_for_param(path, tuple(leaf.shape), mesh,
                                           fsdp), params)


def param_shardings(params: Any, mesh, fsdp: bool = True):
    """Tree of DTensor placements matching ``params``."""
    return map_with_path(lambda _, s: to_placements(s, mesh),
                         param_specs(params, mesh, fsdp))


# ---------------------------------------------------------------------------
# inputs and caches
# ---------------------------------------------------------------------------

def batch_spec(mesh, batch: int) -> Any:
    """Batch axes for the leading dim; falls back to unsharded when batch
    is smaller than the data-parallel extent (long_500k's batch=1)."""
    sizes = axis_sizes(mesh)
    dp = dp_axes(mesh)
    extent = math.prod(sizes[a] for a in dp) if dp else 1
    return dp if batch % max(extent, 1) == 0 and batch >= extent else None


def input_spec(mesh, batch: int, ndim: int) -> Spec:
    """tokens/labels (B, T) or embeds (B, T, D): batch over data axes."""
    b = batch_spec(mesh, batch)
    return sanitize(Spec(b, *([None] * (ndim - 1))),
                    (batch,) + (1 << 30,) * (ndim - 1), mesh)


def input_sharding(mesh, batch: int, ndim: int) -> tuple:
    return to_placements(input_spec(mesh, batch, ndim), mesh)


def cache_specs(cache: Any, mesh, batch: int):
    """KV/SSM cache tree: batch over data axes; heads over model; for
    batch=1 long-context, shard the cache *sequence* over data instead."""
    b = batch_spec(mesh, batch)
    seq_axis = None if b is not None else dp_axes(mesh)

    def f(path, leaf):
        shape = tuple(leaf.shape)
        key = [k for k in path if isinstance(k, str)][-1]
        nd = len(shape)
        if nd == 0:  # pos scalar
            return Spec()
        if key in ("k", "v"):
            # KV ring cache (B, S, K, P).  Preferred: kv heads on model.
            # When the kv-head count doesn't divide the axis (GQA/MQA),
            # shard the cache SEQUENCE over model instead — flash-decoding
            # style: per-shard partial softmax + small combines, instead
            # of all-gathering the multi-GB cache.
            if b is None:
                seq2 = tuple(dp_axes(mesh)) + (MODEL_AXIS,)
            else:
                seq2 = MODEL_AXIS
            for cand in (Spec(b, seq_axis, MODEL_AXIS, None),
                         Spec(b, seq2, None, None)):
                s = sanitize(cand, shape, mesh)
                if MODEL_AXIS in s.axes():
                    return s
            return sanitize(Spec(b, seq_axis, None, None), shape, mesh)
        if key == "conv":  # (B, conv_dim, W)
            return sanitize(Spec(b, MODEL_AXIS, None), shape, mesh)
        if key == "ssm":  # (B, H, P, N)
            return sanitize(Spec(b, MODEL_AXIS, None, None), shape, mesh)
        return Spec(*([None] * nd))

    return map_with_path(f, cache)


def cache_shardings(cache: Any, mesh, batch: int):
    """Tree of DTensor placements matching ``cache``."""
    return map_with_path(lambda _, s: to_placements(s, mesh),
                         cache_specs(cache, mesh, batch))
