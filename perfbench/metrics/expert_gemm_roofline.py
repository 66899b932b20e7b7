"""expert_gemm_roofline: the expert grouped GEMM's share of its roofline
over the traced calls, in %: the least time of every traced grouped-GEMM
call's work (``benchlib/roofline_moe.py``: each routed row in and out
once, the weights of the experts that got rows, bf16 peak) over the device
time of every ``expert_grouped_gemm`` kernel instance in the trace.
Layer: the kernels."""
from benchlib import roofline_moe


def read(obs):
    data = obs.trace
    calls = getattr(obs, "expert_gemms", None)
    if obs.kind != "lm" or data is None or not calls:
        return None
    spent = data.seconds_of("expert_grouped_gemm")
    if spent <= 0.0:
        return None
    least = sum(roofline_moe.expert_gemm_least_s(sizes, k, n)
                for k, n, sizes in calls)
    return 100.0 * least / spent
