"""One rank's work in a step: FLOPs, bytes, collective bytes and memory,
and the roofline terms they give on an H100 (the port of
``repro.launch.hlo_analysis``).

The reference reads XLA's cost analysis and the optimized HLO text of a
compiled SPMD program.  The port has neither: the dry-run
(``launch/dryrun.py``) runs the step once on DTensor stand-ins whose local
shards are fake tensors, and :class:`LocalOpCounter`, a dispatch mode,
records what rank 0 runs on its local shards:

* FLOPs of its matrix products and convolutions (the formulas of
  ``torch.utils.flop_counter``), at the local shapes;
* bytes accessed: operand plus result bytes of every local op that is not
  a view, each at the dtype it reads;
* the ``_c10d_functional`` collectives DTensor issued, by kind, at their
  result bytes (:func:`collective_bytes`);
* the peak bytes of live op results.

DTensor also runs the op at its global shapes to infer its output's
metadata; those calls come from ``torch.distributed.tensor``'s sharding
propagation and are not counted (finding: a counter over DTensors sees the
global op, 256x rank 0's work on a 256-rank mesh).

The reference's ``convert_penalty_bytes`` is not carried over: it removes
an artefact of XLA's CPU lowering (bf16 dots upcast to f32 copies), and
the port counts each op at the dtype it reads, so the artefact never
arises.

Hardware model: one NVIDIA H100 SXM, from NVIDIA's data sheet (dense
rates, at the full 700 W power limit they assume): 989 TFLOP/s bf16 on
the tensor cores, 3.35 TB/s of HBM3, NVLink 450 GB/s each way.  A 16-wide
``model`` axis spans two 8-card hosts, whose link (InfiniBand) is far
slower than NVLink; this one-term collective model cannot see that.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["HW", "Hardware", "LocalOpCounter", "collective_bytes",
           "Roofline", "roofline_from"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# _c10d_functional op name -> the reference's collective kind
_KIND_OF = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_to_all", "all-to-all"), ("permute", "collective-permute"))
# ops that move no bytes of their own
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "device"}
_PROPAGATION = "distributed/tensor/_sharding_prop.py"


def _tensors(tree) -> list:
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the call stack (it runs
    ops at global shapes to infer an output's metadata)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.replace("\\", "/").endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


class LocalOpCounter(TorchDispatchMode):
    """Counts the ops run on plain (local, usually fake) tensors while
    active: ``flops``, ``bytes``, ``collectives`` (a list of ``(kind,
    result bytes)``) and ``peak_live`` bytes of op results still
    referenced.  Ops on DTensors are passed on to DTensor (which runs them
    on the local shards, where they are counted)."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self._dtensor = DTensor
        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, int]] = []
        self.live = 0
        self.peak_live = 0
        self.ops = 0
        self._refs: set = set()

    def _release(self, ref, nbytes: int) -> None:
        self._refs.discard(ref)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        name = func.__name__.split(".")[0]
        ns = func.namespace
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if ns.startswith("_c10d_functional"):
            if name != "wait_tensor":
                self.collectives.append(
                    (self.kind_of(name), sum(_nbytes(t) for t in outs)))
            return out
        if name in _FREE:
            return out
        self.ops += 1
        packet = func._overloadpacket
        if packet in self._flops:
            self.flops += int(self._flops[packet](*args, **kwargs,
                                                  out_val=out))
        if func.is_view:
            return out
        self.bytes += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)
        fresh = [t for t in outs if not any(t is a for a in ins)]
        for t in fresh:
            n = _nbytes(t)
            self.live += n
            ref = weakref.ref(t, lambda r, n=n: self._release(r, n))
            self._refs.add(ref)
        self.peak_live = max(self.peak_live, self.live)
        return out

    @staticmethod
    def kind_of(op_name: str) -> str:
        for part, kind in _KIND_OF:
            if part in op_name:
                return kind
        raise ValueError(f"collective {op_name!r} is none of the kinds "
                         f"{_COLLECTIVES}")


def collective_bytes(collectives) -> dict[str, int]:
    """Sum result bytes per collective kind over ``(kind, bytes)`` records
    (``LocalOpCounter.collectives``); every kind present, zeros included."""
    out = {k: 0 for k in _COLLECTIVES}
    for kind, n in collectives:
        out[kind] += int(n)
    return out


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float = 989e12   # bf16 FLOP/s per card, dense
    hbm_bw: float = 3.35e12      # bytes/s per card, HBM3
    link_bw: float = 450e9       # bytes/s per card, NVLink, each way


HW = Hardware()


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Three-term roofline for one (arch, shape, mesh) dry-run.

    ``flops`` / ``hbm_bytes`` / ``coll_bytes`` are PER-DEVICE values: the
    ops rank 0 runs on its local shards.  ``model_flops`` is the GLOBAL
    useful 6*N*D (6*N_active*D for MoE) figure.
    """
    flops: float              # per-device FLOPs
    hbm_bytes: float          # per-device bytes accessed
    coll_bytes: float         # per-device collective bytes moved
    chips: int
    model_flops: float        # global 6*N*D useful FLOPs
    per_device_mem: float     # peak bytes per device

    @property
    def t_compute(self) -> float:
        return self.flops / HW.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HW.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / HW.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / total FLOPs — fraction of the counted compute that
        is useful (catches remat/redundancy/padding waste)."""
        return self.model_flops / (self.flops * self.chips) if self.flops else 0.0

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops": self.flops,
            "useful_ratio": self.useful_ratio,
            "per_device_mem_gb": self.per_device_mem / 2**30,
        }


def roofline_from(cost: dict, colls: dict[str, int], chips: int,
                  model_flops: float, per_device_mem: float) -> Roofline:
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    return Roofline(flops=flops, hbm_bytes=hbm,
                    coll_bytes=float(sum(colls.values())), chips=chips,
                    model_flops=model_flops, per_device_mem=per_device_mem)
