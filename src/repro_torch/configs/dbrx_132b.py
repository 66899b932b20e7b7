"""dbrx-132b [moe] — 16 experts top-4, fine-grained MoE
[hf:databricks/dbrx-base]."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    top_k=4,
)
