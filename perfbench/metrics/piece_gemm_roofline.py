"""piece_gemm_roofline: the piece GEMM kernels' share of their roofline
over the traced calls, in %: the least time of the n lanes each coded
GEMM's program computes (each lane's rows read once, the f32 weight once,
each output written once, at 3.35 TB/s and the TF32 rate) over the device
time of every ``piece_`` kernel instance in the trace.  Layer: the
kernels."""
from benchlib import roofline


def read(obs):
    data = obs.trace
    if obs.kind != "lm" or data is None or not obs.traced_ops:
        return None
    spent = data.seconds_of("piece_")
    if spent <= 0.0:
        return None
    least = 0.0
    for kind, n, x_shape, w_shape in obs.traced_ops:
        if kind != "matmul":
            continue
        _, t_p, d_in = x_shape
        least += roofline.stacked_gemm_least_s(n, t_p, d_in, w_shape[-1])
    return 100.0 * least / spent
