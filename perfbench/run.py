"""Run one cell of the benchmark of ``repro_torch`` (the PyTorch and CUDA
port of CoCoI) once, on the CUDA devices of this machine:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic, driver and metrics are found by name
(``benchlib/spec.py``).  The run makes its weights and inputs on the card
from ``--seed``, warms every shape the cell's traffic uses, measures for
``--seconds`` seconds, checks what the timed path produced against the
plain reference, and prints as its last line of standard output one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number
compared beside its limit, which also close standard error.

It exits non-zero and prints no result when there is no card or fewer
cards than the cell asks for, when the program is not in the checkout,
and when a module of JAX or of the JAX package ``repro`` is loaded once
the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

from benchlib import guard, spec  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def result_line(cell, out, trace: bool) -> dict:
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.load_module(spec.metric_path(m["name"])).read(
                out["obs"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(out["e2e"][m["name"]]),
                                  "unit": m["unit"]}
    device = dict(out["device"])
    line = {"correct": bool(out["correct"]),
            "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device}
    data = out["obs"].trace
    if trace:
        if data is None:
            raise RuntimeError("the traced run recorded no trace")
        device["busy_s"] = data.busy_s
        device["window_s"] = data.window_s
        line["breakdown"] = {"device_ops": data.device_ops,
                             "idle_gaps": data.idle_gaps}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in out["checks"]}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = spec.load_cell(args.workload, ROOT)
    except (FileNotFoundError, KeyError) as e:
        fail(str(e))
    guard.set_cache_dirs(ROOT)
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"the program is not in this checkout ({src / 'repro_torch'})")
    sys.path.insert(0, str(src))
    import torch

    why = guard.require_cards(torch, cell.chips)
    if why is not None:
        fail(why, 3)
    seed = int(args.seed)
    out = cell.driver.run(cell, seed=seed, seconds=float(args.seconds),
                          trace=bool(args.trace), device="cuda",
                          t_start=T_START)
    found = guard.forbidden_modules()
    if found:
        fail("modules of JAX or of the JAX package were loaded: "
             + ", ".join(found), 4)
    out["device"].update(platform="gpu", kind=torch.cuda.get_device_name(0),
                         count=cell.chips, power_limit=guard.power_limit())
    line = result_line(cell, out, bool(args.trace))
    for c in out["checks"]:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    bad = [k for k, v in line["metrics"].items()
           if not math.isfinite(v["value"])]
    if bad:
        fail(f"metrics that are not finite: {bad}", 5)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
