"""gemma2-9b [dense] — Google Gemma-2 9B.

42L d_model=3584, 16H (GQA kv=8, head_dim=256), d_ff=14336, vocab=256000.
Alternating local (window 4096) + global attention, attention logit softcap
50.0, final logit softcap 30.0, GeGLU, sandwich (pre+post) norms.
[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab_size=256000,
    attention=AttentionConfig(
        kind="full",
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        window=4096,          # used by the local layers in the pattern
        logit_softcap=50.0,
        causal=True,
        use_rope=True,
        rope_theta=10_000.0,
    ),
    block_pattern=("local_attn_mlp", "attn_mlp"),  # local, global alternating
    norm="rms",
    activation="gelu_glu",
    final_logit_softcap=30.0,
    tie_embeddings=True,
    extra={"post_norm": True, "embed_scale": True},
)

SMOKE = CONFIG.replace(
    num_layers=4,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=CONFIG.attention.replace(
        num_heads=4, num_kv_heads=2, head_dim=16, window=16
    ),
    param_dtype="float32",
    activation_dtype="float32",
)
