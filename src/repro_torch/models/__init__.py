from .model import (
    ModelConfig,
    init_params,
    forward,
    prefill,
    prefill_resume,
    supports_prefill_pack,
    decode_step,
    init_cache,
    param_count,
)
from .ssm import SSMDims, ssd_chunked, ssd_step
from .cnn import (
    LayerInfo,
    vgg16_conv_specs,
    resnet18_conv_specs,
    is_type1,
    type1_threshold,
    init_small_cnn,
    small_cnn_forward,
    small_cnn_layers,
    init_vgg16,
    vgg16_forward,
    init_resnet18,
    resnet18_forward,
    forward_plan,
    init_cnn,
)
from .frontends import synthetic_frames, synthetic_patches

__all__ = [
    "ModelConfig", "init_params", "forward", "prefill", "prefill_resume",
    "supports_prefill_pack", "decode_step", "init_cache", "param_count",
    "SSMDims", "ssd_chunked", "ssd_step",
    "LayerInfo", "vgg16_conv_specs", "resnet18_conv_specs", "is_type1",
    "type1_threshold", "init_small_cnn", "small_cnn_forward",
    "small_cnn_layers", "init_vgg16", "vgg16_forward", "init_resnet18",
    "resnet18_forward", "forward_plan", "init_cnn",
    "synthetic_frames", "synthetic_patches",
]
