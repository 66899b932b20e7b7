"""Readings for a cell's correctness limit, on the card, at the cell's own
size: for each seed, one short run of the program (its compared number,
the lower reading) and the control on the same inputs (the reference in
the precision below the configuration's: TF32 operands for an f32
configuration, float8 e4m3 weights for a bf16 one; the upper reading).
The control's answers are put in the program's place and judged by the
run's own comparison and limits.  All seeds run in one process; the exit
code is 1 when a program run is not correct or a control run is.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--out readings.json]
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

from benchlib import guard, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload, ROOT)
    guard.set_cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    why = guard.require_cards(torch, cell.chips)
    if why is not None:
        print(f"control: {why}", file=sys.stderr)
        return 3
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = cell.driver.run(cell, seed=seed, seconds=args.seconds,
                              trace=False, device="cuda", t_start=t0,
                              control=True)
        row = {"seed": seed, "correct": out["correct"],
               "failed": out["failed"], "attempted": out["attempted"],
               "checks": out["checks"],
               "control_correct": out["control"]["correct"],
               "control_checks": out["control"]["checks"],
               "e2e": out["e2e"], "served": out.get("served"),
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"cell": cell.name, "device": torch.cuda.get_device_name(0),
               "power": guard.power_limit(), "rows": rows,
               "program_max": max(max(c["value"] for c in r["checks"])
                                  for r in rows),
               "control_min": min(c["value"] for r in rows
                                  for c in r["control_checks"]),
               "program_correct": all(r["correct"] for r in rows),
               "control_correct": any(r["control_correct"] for r in rows)}
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    return 0 if (summary["program_correct"]
                 and not summary["control_correct"]) else 1


if __name__ == "__main__":
    sys.exit(main())
