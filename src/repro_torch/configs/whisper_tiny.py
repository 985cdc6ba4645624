"""whisper-tiny [audio] — OpenAI Whisper tiny encoder-decoder.

4L (enc) + 4L (dec), d_model=384, 6H (MHA kv=6, head_dim=64), d_ff=1536,
vocab=51865.  Conv frontend is a STUB: ``input_specs()`` provides 1500
precomputed mel-frame embeddings.  [arXiv:2212.04356]

Encoder: bidirectional self-attention over the 1500 frames.
Decoder: causal self-attention + cross-attention to encoder output.
LayerNorm + GELU (non-GLU), learned positions (no RoPE).
"""
from repro_torch.configs.base import AttentionConfig, EncDecConfig, FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,  # decoder layers; encoder layers in encdec config
    d_model=384,
    d_ff=1536,
    vocab_size=51865,
    attention=AttentionConfig(
        kind="full",
        num_heads=6,
        num_kv_heads=6,
        head_dim=64,
        causal=True,
        use_rope=False,  # whisper uses learned/sinusoidal positions
    ),
    frontend=FrontendConfig(kind="audio", num_positions=1500, d_frontend=384),
    encdec=EncDecConfig(num_encoder_layers=4, encoder_positions=1500),
    block_pattern=("attn_mlp",),
    norm="layer",
    activation="gelu",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=CONFIG.attention.replace(num_heads=4, num_kv_heads=4, head_dim=16),
    frontend=FrontendConfig(kind="audio", num_positions=16, d_frontend=64),
    encdec=EncDecConfig(num_encoder_layers=2, encoder_positions=16),
    param_dtype="float32",
    activation_dtype="float32",
)
