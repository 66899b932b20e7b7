"""Serving from the command line:
``python -m repro_torch.launch.serve --arch <id> [--coded n k] [--no-smoke]
[--device cuda|cpu]``.

Serves batched synthetic requests through the Engine; the paper's coded
mode is enabled with --coded N K, which routes every FFN GEMM through the
(n, k)-MDS pipeline.  ``--smoke`` (the default) serves the reduced config,
``--no-smoke`` the full-width one; weights are random, from a seed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import ARCHS, get_config, smoke_config
from ..serving import Engine, Request

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCHS), default="gemma-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--coded", nargs=2, type=int, default=None,
                    metavar=("N", "K"))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                        dtype=np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    eng = Engine(cfg, coded=tuple(args.coded) if args.coded else None,
                 device=args.device)
    t0 = time.time()
    completions = eng.generate(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(c.tokens) for c in completions)
    print(f"{cfg.name}: served {len(completions)} requests, "
          f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s) on {eng.device}"
          + (f"  [coded (n={args.coded[0]}, k={args.coded[1]})]"
             if args.coded else ""))
    for c in completions[:3]:
        print(f"  req {c.rid}: {c.tokens[:8]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
