"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality)
[arXiv:2405.21060].  64 Mamba2 layers, d_state=128, expand=2, head_dim=64
(=> 80 SSD heads)."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    n_layers=64,
    d_model=2560,
    n_heads=1,          # attention-free; unused
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    block="mamba",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
)
