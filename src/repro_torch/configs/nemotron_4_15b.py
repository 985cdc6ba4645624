"""nemotron-4-15b [dense] — NVIDIA Nemotron-4 15B.

32L d_model=6144, 48H (GQA kv=8, head_dim=128), d_ff=24576, vocab=256000.
Squared-ReLU MLP (non-gated), no-bias linears.  [arXiv:2402.16819]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    d_ff=24576,
    vocab_size=256000,
    attention=AttentionConfig(
        kind="full",
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        causal=True,
        use_rope=True,
        rope_theta=10_000.0,
    ),
    block_pattern=("attn_mlp",),
    norm="layer",          # nemotron uses LayerNorm
    activation="relu2",    # squared ReLU, non-gated
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=64,
    d_ff=256,
    vocab_size=512,
    attention=CONFIG.attention.replace(num_heads=4, num_kv_heads=2, head_dim=16),
    param_dtype="float32",
    activation_dtype="float32",
)
