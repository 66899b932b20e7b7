"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].  38 Mamba2 layers with one shared-weight attention+FFN
block applied every 6 layers (Zamba2's single shared block, simplified to a
fixed period)."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    block="mamba",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_period=6,
)
