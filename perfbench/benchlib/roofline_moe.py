"""The least time of the expert grouped GEMM's work (``repro_torch``'s
``kernels/grouped_gemm.py``), from the rows each expert got in a call.

One call is one projection of the held experts: ``rows`` routed rows, each
multiplied by its expert's (K, N) weight.  Its work is 2 x rows x K x N
operations in bf16; its bytes are each row's K inputs read once and N
outputs written once, plus the weights of only the experts that got rows,
all in bf16.  Held to ``roofline``'s peaks."""
from __future__ import annotations

from benchlib import roofline

ITEM = 2  # bytes of a bf16 value


def expert_gemm_least_s(sizes, k: int, n: int) -> float:
    """Least seconds of one grouped-GEMM call: ``sizes`` the rows of each
    held expert, each multiplied by a (k, n) weight."""
    rows = sum(int(s) for s in sizes)
    active = sum(1 for s in sizes if int(s) > 0)
    flops = 2.0 * rows * k * n
    n_bytes = ITEM * (rows * (k + n) + active * k * n)
    return roofline.bound(n_bytes, flops, "bfloat16")[0]
