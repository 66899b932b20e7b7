"""minicpm-2b [dense] — llama-like arch trained with the WSD schedule
[arXiv:2404.06395].  The schedule belongs to training, which the port does
not have yet (ROADMAP.md, Queue A item 5)."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    act="silu",
    gated=True,
)
