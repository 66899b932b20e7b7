"""internvl2-1b [vlm] — InternViT + InternLM2/Qwen2-0.5B language backbone
[arXiv:2404.16821].  The vision encoder + projector are a stub:
input_specs() provides precomputed patch embeddings (B, T, d_model)."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    frontend="vision",
    rope_theta=1e6,
)
