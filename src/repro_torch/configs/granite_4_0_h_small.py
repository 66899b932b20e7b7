"""granite-4.0-h-small [hybrid MoE] — IBM Granite 4.0-H Small, 32B-A9B
[hf:ibm-granite/granite-4.0-h-small]: 40 layers at d 4096, 36 Mamba2
(128 heads x 64, state 128, one B/C group) and GQA attention with no
positional encoding at layers 5, 15, 25 and 35; every layer followed by a
dropless top-10 mixture of 72 SiLU-gated experts 768 wide and a shared
expert 1536 wide.

This configuration is one device's share of a deployment over four: the
router keeps its 72 outputs and this device holds experts 0-17.  The
published SSD chunk is 256; the port's kernel takes at most 128, the same
arithmetic in shorter chunks."""
from ..models.model import HybridMoEConfig

ATTENTION_LAYERS = (5, 15, 25, 35)

CONFIG = HybridMoEConfig(
    name="granite-4.0-h-small",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,
    vocab=100352,
    block="hybrid",
    n_experts=72,
    top_k=10,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=128,
    layer_types=tuple("attn" if i in ATTENTION_LAYERS else "mamba"
                      for i in range(40)),
    experts_held=18,
    shared_d_ff=1536,
    embed_scale=12.0,
    residual_scale=0.22,
    logits_scale=16.0,
    attn_scale=0.0078125,
    positional="nope",
    norm_eps=1e-5,
)
