"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284].  The EnCodec frontend is a stub: input_specs() provides
precomputed frame embeddings (B, T, d_model) per the brief's carve-out."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,          # EnCodec codebook size
    act="gelu",
    gated=False,         # plain 4x GELU MLP
    frontend="audio",
)
