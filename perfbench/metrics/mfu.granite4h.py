"""mfu.granite4h: the plain model's matrix FLOPs of the model calls in
the traced window (``drivers/lm_serve_moe.py::matrix_flops``, with the
routed rows the held experts computed) over the window times the bf16
peak, in %.  Layer: the device, whole step."""
from benchlib.readers import mfu


def read(obs):
    return mfu(obs, "lm")
