"""yi-6b [dense] — 01.AI Yi-6B, llama architecture with GQA.

32L d_model=4096, 32H (GQA kv=4, head_dim=128), d_ff=11008, vocab=64000.
[arXiv:2403.04652; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=11008,
    vocab_size=64000,
    attention=AttentionConfig(
        kind="full",
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        causal=True,
        use_rope=True,
        rope_theta=5_000_000.0,
    ),
    block_pattern=("attn_mlp",),
    norm="rms",
    activation="silu_glu",
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=CONFIG.attention.replace(num_heads=4, num_kv_heads=1, head_dim=16),
    param_dtype="float32",
    activation_dtype="float32",
)
