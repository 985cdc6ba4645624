"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

81L d_model=3584, shared attn 32H (MHA, kv=32), d_ff=14336, vocab=32000,
ssm_state=64.  [arXiv:2411.15242]

The Zamba2 design: a stack of Mamba-2 blocks with a single *shared*
attention+MLP block whose weights are reused every few layers (here: every 6
scanned Mamba layers, matching the paper's "shared transformer block"
interleave).  Sub-quadratic in sequence length → runs the long_500k cell.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    d_ff=14336,  # shared block MLP hidden size
    vocab_size=32000,
    attention=AttentionConfig(
        kind="full",
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,  # 3584 / 32
        causal=True,
        use_rope=True,
    ),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    # 81 = 3 prefix mamba layers + 13 scanned groups of 6 mamba layers; the
    # shared attention+MLP block runs once at the start of every group
    # (weights shared across all 13 invocations).
    block_pattern=("mamba2",) * 6,
    prefix_blocks=("mamba2",) * 3,
    shared_attn_every=6,
    norm="rms",
    activation="gelu_glu",
    supports_long_context=True,
)

SMOKE = CONFIG.replace(
    num_layers=5,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=CONFIG.attention.replace(num_heads=4, num_kv_heads=4, head_dim=16),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk_size=32),
    block_pattern=("mamba2",) * 2,
    prefix_blocks=("mamba2",),
    shared_attn_every=2,
    param_dtype="float32",
    activation_dtype="float32",
)
