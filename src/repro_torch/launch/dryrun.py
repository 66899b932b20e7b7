"""Multi-pod dry-run: one rank's work per (architecture x input-shape) on
the production mesh, without the cards (the port of
``repro.launch.dryrun``).

For every combination, the step of the shape's kind runs once on
``launch/steps.py``'s stand-ins (DTensors placed by ``launch/sharding.py``,
local shards that are fake tensors) on the fake process group of the
mesh's size, under ``torch.distributed.tensor.experimental.
implicit_replication`` (the model makes masks and positions as plain
tensors).  ``hlo_analysis.LocalOpCounter`` records rank 0's FLOPs, bytes,
collectives and live bytes; the record gives the roofline terms at an
H100's figures and prints a summary.

The reference compiles with XLA, whose cost analysis does not descend
into loop bodies, so it extrapolates from 2- and 4-layer compiles.  The
port runs its layers as a Python loop and counts the full depth: no
extrapolation.  Attention blocks are the reference's metrics-mode size,
``min(max(T // 8, 512), 8192)``, so a 32k prefill is 8 x 8 blocks a layer.

DTensor's CPU path turns an all-to-all into an all-gather and a chunk, so
on the fake CPU mesh all-to-all traffic counts as all-gather.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all            # 40 single-pod baselines
    python -m repro_torch.launch.dryrun --all --multi-pod
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback

import torch

from ..configs import ARCHS, INPUT_SHAPES, for_shape, get_config
from ..optim import tree_leaves
from .hlo_analysis import HW, LocalOpCounter, collective_bytes, roofline_from
from .mesh import make_production_mesh
from .steps import step_and_specs

__all__ = ["run_one", "main", "model_flops_global", "fake_process_group",
           "step_metrics"]


def model_flops_global(cfg, shape) -> float:
    """Useful FLOPs: 6*N*D (dense) or 6*N_active*D (MoE); D = tokens.

    Training counts fwd+bwd (the classic 6ND); inference steps count 2ND.
    """
    from ..launch.sharding import map_with_path
    from ..models.model import init_params

    shapes = init_params(cfg, torch.Generator(), device="meta")
    total = active = 0
    leaves = []
    map_with_path(lambda path, t: leaves.append((path, t)), shapes)
    for path, leaf in leaves:
        keys = [k for k in path if isinstance(k, str)]
        n = leaf.numel()
        total += n
        if "moe" in keys and keys[-1] != "router":
            active += n * cfg.top_k / max(cfg.n_experts, 1)
        else:
            active += n
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens


def _local_bytes(tree) -> int:
    """Bytes of rank 0's shards of the tensors of a tree of DTensors (or
    plain tensors; other leaves, a step number, hold none)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += t.numel() * t.element_size()
    return total


def _memory_floor_bytes(args, shape) -> float:
    """Analytic per-device HBM floor for one step: every local parameter
    shard is read at least once, plus (decode) one full read of the local
    KV/SSM cache shard — the irreducible traffic of the step."""
    total = _local_bytes(args[0])
    if shape.kind == "train":
        # params read twice (fwd + bwd) + written once; f32 moments read
        # and written once each
        total = total * 3 + _local_bytes(args[1]) * 2
    if shape.kind == "decode":
        total += _local_bytes(args[1])  # one full cache read
    return float(total)


@contextlib.contextmanager
def fake_process_group(world: int):
    """A default process group of ``world`` ranks on the fake backend (this
    process is rank 0; collectives move nothing), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; the "
                           "dry-run makes its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _strided_shard_metadata_unfaked():
    """DTensor computes a ``_StridedShard``'s local size and offsets with a
    small ``torch.arange`` and ``.tolist()``; under an active fake mode that
    arange is fake and ``.tolist()`` raises (a flattened pair of sharded
    dims, e.g. (batch, heads) folded into one batch dim of a ``bmm``).
    While active, that metadata is computed with every dispatch mode off."""
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes

    name = "local_shard_size_and_offset"
    raw = _StridedShard.__dict__[name]
    fn = raw.__func__ if isinstance(raw, staticmethod) else raw

    def unfaked(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)

    setattr(_StridedShard, name,
            staticmethod(unfaked) if isinstance(raw, staticmethod) else unfaked)
    try:
        yield
    finally:
        setattr(_StridedShard, name, raw)


def step_metrics(step_fn, args) -> dict:
    """Run ``step_fn(*args)`` once on stand-ins, under their fake mode, and
    return rank 0's ``flops``, ``bytes``, ``colls`` (bytes by kind) and
    ``mem``: argument bytes plus the peak of live op results (which holds
    the outputs once they are made), or the outputs that are not
    arguments if those are more."""
    from torch.distributed.tensor.experimental import implicit_replication

    locals_ = [t.to_local() if hasattr(t, "to_local") else t
               for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    mode = next(t.fake_mode for t in locals_ if hasattr(t, "fake_mode"))
    arg_ids = {id(t) for t in locals_}
    with mode, implicit_replication(), _strided_shard_metadata_unfaked(), \
            LocalOpCounter() as counter:
        out = step_fn(*args)
    outs = [t.to_local() if hasattr(t, "to_local") else t
            for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    out_bytes = sum(t.numel() * t.element_size() for t in outs
                    if id(t) not in arg_ids)
    mem = _local_bytes(args) + max(counter.peak_live, out_bytes)
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "colls": collective_bytes(counter.collectives), "mem": float(mem),
            "ops": counter.ops}


def _metrics_block(shape) -> int:
    """The attention block of the reference's metrics-mode compiles."""
    T = shape.seq_len if shape.kind != "decode" else 1
    return min(max(T // 8, 512), 8192) if T > 1 else 1


def run_one(arch: str, shape_name, multi_pod: bool = False,
            fsdp: bool = True, verbose: bool = True,
            cfg_override=None, mesh_shape: tuple | None = None) -> dict:
    """Dry-run one combination.  ``shape_name`` names an ``INPUT_SHAPES``
    entry or is an ``InputShape``; ``mesh_shape`` (data, model) replaces
    the production mesh (the tests: smoke configs on a (2, 2) mesh)."""
    shape = (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    shape_name = shape.name
    base_cfg = cfg_override if cfg_override is not None else get_config(arch)
    blk = _metrics_block(shape)
    if blk > 1:
        base_cfg = dataclasses.replace(base_cfg, block_q=blk, block_k=blk)
    if mesh_shape is None:
        dims = (2, 16, 16) if multi_pod else (16, 16)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
    else:
        dims, names = tuple(mesh_shape), ("data", "model")
    chips = math.prod(dims)
    t0 = time.time()
    with fake_process_group(chips):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        else:
            from torch.distributed.device_mesh import init_device_mesh

            mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
        step_fn, args = step_and_specs(base_cfg, shape, mesh, fsdp=fsdp)
        floor_bytes = _memory_floor_bytes(args, shape)
        full = step_metrics(step_fn, args)
    t_run = time.time() - t0
    colls = full["colls"]
    cost = {"flops": full["flops"], "bytes accessed": full["bytes"]}
    cfg_used = for_shape(base_cfg, shape)
    rf = roofline_from(cost, colls, chips,
                       model_flops_global(cfg_used, shape), full["mem"])
    rec = {
        "arch": arch,
        "shape": shape_name,
        "t_memory_floor_s": floor_bytes / HW.hbm_bw,
        "mesh": "x".join(str(d) for d in dims),
        "chips": chips,
        "fsdp": fsdp,
        "compile_s": round(t_run, 1),
        "hbm_bytes": full["bytes"],
        "attn_block": blk,
        "collectives": colls,
        **{k: (float(v) if isinstance(v, (int, float)) else v)
           for k, v in rf.row().items()},
    }
    if verbose:
        print(f"[dryrun] {rec['arch']} x {shape_name} on {rec['mesh']}: "
              f"ran {t_run:.1f}s  mem/dev "
              f"{full['mem']/2**30:.2f} GiB  bottleneck {rf.bottleneck}")
        print(f"  counted: flops={full['flops']:.3e} "
              f"bytes={full['bytes']:.3e} ops={full['ops']}")
        print(f"  collectives: { {k: v for k, v in colls.items() if v} }")
        print(f"  roofline: compute {rf.t_compute:.4f}s  memory "
              f"{rf.t_memory:.4f}s (floor {floor_bytes / HW.hbm_bw:.4f}s)  "
              f"collective {rf.t_collective:.4f}s  useful {rf.useful_ratio:.2%}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCHS), default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all 10 archs x 4 shapes")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    combos = []
    if args.all:
        combos = [(a, s) for a in ARCHS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    elif args.arch:
        combos = [(args.arch, s) for s in INPUT_SHAPES]
    else:
        ap.error("need --arch [--shape] or --all")

    failures = []
    for arch, shape in combos:
        try:
            rec = run_one(arch, shape, multi_pod=args.multi_pod,
                          fsdp=not args.no_fsdp)
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        except Exception as e:  # noqa: BLE001 — report every combo
            failures.append((arch, shape, repr(e)[:300]))
            print(f"[dryrun] FAIL {arch} x {shape}: {e!r}"[:2000], flush=True)
            traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} failures: {failures}")
        return 1
    print(f"[dryrun] all {len(combos)} combinations ran OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
