"""internvl2-2b [vlm] — InternViT frontend (stub) + InternLM2-1.8B backbone.

24L d_model=2048, 16H (GQA kv=8, head_dim=128), d_ff=8192, vocab=92553.
[arXiv:2404.16821; hf]

The vision frontend (InternViT-300M + pixel-shuffle + MLP projector) is a
STUB per the assignment: ``input_specs()`` delivers 256 precomputed patch
embeddings of width d_model which the backbone prepends to the token
embeddings.  The backbone is a standard llama-style GQA decoder.
"""
from repro_torch.configs.base import AttentionConfig, FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=92553,
    attention=AttentionConfig(
        kind="full",
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        causal=True,
        use_rope=True,
        rope_theta=1_000_000.0,
    ),
    frontend=FrontendConfig(kind="patch", num_positions=256, d_frontend=2048),
    block_pattern=("attn_mlp",),
    norm="rms",
    activation="silu_glu",
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=CONFIG.attention.replace(num_heads=4, num_kv_heads=2, head_dim=16),
    frontend=FrontendConfig(kind="patch", num_positions=8, d_frontend=64),
    param_dtype="float32",
    activation_dtype="float32",
)
