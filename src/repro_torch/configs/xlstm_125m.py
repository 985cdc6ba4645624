"""xlstm-125m [ssm] — xLSTM with alternating sLSTM + mLSTM blocks.

12L d_model=768, 4H, d_ff=0 (blocks carry their own projections),
vocab=50304.  [arXiv:2405.04517]

mLSTM: matrix-memory block (linear-attention-like, chunkwise-parallel).
sLSTM: scalar-memory recurrent block (sequential scan over time).
Sub-quadratic in sequence length → runs the long_500k cell.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    d_ff=0,
    vocab_size=50304,
    attention=AttentionConfig(  # GQA fields reused for the mLSTM head geometry
        kind="none",
        num_heads=4,
        num_kv_heads=4,
        head_dim=192,
        use_rope=False,
    ),
    xlstm=XLSTMConfig(num_heads=4, m_proj_factor=2.0, m_chunk_size=256,
                      s_proj_factor=4.0 / 3.0, s_conv_kernel=4),
    block_pattern=("mlstm", "slstm"),
    norm="layer",
    activation="gelu",
    tie_embeddings=True,
    supports_long_context=True,
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=64,
    vocab_size=512,
    attention=CONFIG.attention.replace(num_heads=4, num_kv_heads=4, head_dim=16),
    xlstm=XLSTMConfig(num_heads=4, m_proj_factor=2.0, m_chunk_size=16,
                      s_proj_factor=4.0 / 3.0, s_conv_kernel=4),
    param_dtype="float32",
    activation_dtype="float32",
)
