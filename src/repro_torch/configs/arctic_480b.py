"""arctic-480b [moe] — Snowflake Arctic dense-MoE hybrid.

35L d_model=7168, 56H (GQA kv=8, head_dim=128), expert d_ff=4864,
vocab=32000, MoE 128 experts top-2 PLUS a dense residual FFN in parallel
with the MoE branch on every layer.  [hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    d_ff=4864,  # dense residual FFN hidden size
    vocab_size=32000,
    attention=AttentionConfig(
        kind="full",
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        causal=True,
        use_rope=True,
        rope_theta=1_000_000.0,
    ),
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        d_ff_expert=4864,
        num_shared_experts=0,
        capacity_factor=1.25,
        dense_residual_d_ff=4864,
    ),
    block_pattern=("moe_layer",),
    norm="rms",
    activation="silu_glu",
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=CONFIG.attention.replace(num_heads=4, num_kv_heads=2, head_dim=16),
    moe=MoEConfig(
        num_experts=8,
        top_k=2,
        d_ff_expert=128,
        # ample capacity so smoke tests are drop-free (drop behaviour is
        # exercised separately in tests/test_moe.py)
        capacity_factor=4.0,
        dense_residual_d_ff=128,
    ),
    param_dtype="float32",
    activation_dtype="float32",
)
