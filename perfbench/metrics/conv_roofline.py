"""conv_roofline: the conv kernel's share of its roofline over the traced
requests, in %: the least time of the conv work the design asks for
(``drivers/cnn_closed_loop.py::conv_work``, at 3.35 TB/s and the TF32
rate) over the device time of every ``conv2d_implicit_gemm`` instance in
the trace.  Pieces computed past the k the decode needs count as time."""


def read(obs):
    data = obs.trace
    if obs.kind != "cnn" or data is None or not obs.traced_requests:
        return None
    spent = data.seconds_of("conv2d_implicit_gemm")
    if spent <= 0.0:
        return None
    return 100.0 * obs.traced_requests * obs.conv_least_s / spent
