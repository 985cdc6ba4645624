"""granite-8b [dense] — IBM Granite Code 8B, llama architecture.

36L d_model=4096, 32H (GQA kv=8, head_dim=128), d_ff=14336, vocab=49152.
[arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    d_ff=14336,
    vocab_size=49152,
    attention=AttentionConfig(
        kind="full",
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        causal=True,
        use_rope=True,
        rope_theta=10_000_000.0,
    ),
    block_pattern=("attn_mlp",),
    norm="rms",
    activation="silu_glu",
    tie_embeddings=True,  # granite code ties embeddings
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=CONFIG.attention.replace(num_heads=4, num_kv_heads=2, head_dim=16),
    param_dtype="float32",
    activation_dtype="float32",
)
