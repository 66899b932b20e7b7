"""qwen3-32b [dense] — qk_norm + GQA [hf:Qwen/Qwen3-8B scaled per brief].
head_dim=128 per the Qwen3 model card (decoupled from d_model/n_heads)."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
)
