"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE, 384 experts top-8
[arXiv:2501.kimi2].  Fine-grained experts (d_ff=2048 each); ~1.03e12 total
expert params, ~32B active per token."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,           # per-expert hidden
    vocab=163840,
    n_experts=384,
    top_k=8,
)
