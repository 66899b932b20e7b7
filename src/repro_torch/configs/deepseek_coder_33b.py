"""deepseek-coder-33b [dense] — llama-arch GQA [arXiv:2401.14196]."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
    act="silu",
    gated=True,
    rope_theta=1e5,
)
