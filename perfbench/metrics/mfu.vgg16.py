"""mfu.vgg16: the uncoded network's matrix FLOPs for the requests
completed in the traced window over the window times the f32 (TF32)
peak, in %.  Layer: the device, whole step."""
from benchlib.readers import mfu


def read(obs):
    return mfu(obs, "cnn")
