"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1)  [arXiv:2403.08295]."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,      # MQA on the 2b variant
    d_ff=16384,
    vocab=256000,
    head_dim=256,
    act="geglu",
    gated=True,
    rope_theta=1e4,
)
