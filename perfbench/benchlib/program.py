"""How the drivers reach the program under test (``repro_torch``): names
from a configuration resolved to the program's objects, and the coded
backend a cell asks for with the configuration's fault pattern.  The
program is imported here when called, never when this module loads."""
from __future__ import annotations

import importlib


def resolve(path: str):
    """``"package.module.name"`` -> the object."""
    mod, _, name = path.rpartition(".")
    return getattr(importlib.import_module(mod), name)


def backend(cfg: dict, name: str):
    """The program's coded backend ``name`` with ``cfg["coded"]``'s faults:
    ``pool``, the real-clock worker pool (a dead worker fails at dispatch,
    a straggler computes at its factor times its measured time), or
    ``mesh``, the one-program backend (dead and straggling lanes arrive
    last, the decode takes the first decodable prefix of the others)."""
    from repro_torch.dist import (CodedExecutor, FaultPlan, MeshExecutor,
                                  RealClock)

    coded = cfg["coded"]
    dead = tuple(int(w) for w in coded["dead"])
    slow = {int(w): float(f) for w, f in coded["stragglers"].items()}
    if name == "pool":
        return CodedExecutor(int(coded["workers"]), clock=RealClock(),
                             fault_plan=FaultPlan(dead=frozenset(dead),
                                                  straggler=slow))
    if name == "mesh":
        return MeshExecutor(dead=dead, stragglers=tuple(sorted(slow)))
    raise ValueError(f"unknown backend {name!r}")
