"""mfu.zamba2: the plain model's matrix FLOPs of the model calls in the
traced window (``drivers/lm_serve.py::matrix_flops``) over the window
times the bf16 peak, in %.  Layer: the device, whole step."""
from benchlib.readers import mfu


def read(obs):
    return mfu(obs, "lm")
