"""deepseek-v2-236b [moe] — DeepSeek-V2 with MLA + fine-grained MoE.

60L d_model=5120, 128H MLA (kv_lora=512, q_lora=1536, qk_nope=128,
qk_rope=64, v_head=128), expert d_ff=1536, vocab=102400,
2 shared + 160 routed experts, top-6.  First layer uses a dense FFN
(d_ff=12288); layers 1..59 are MoE.  [arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    d_ff=12288,  # dense FFN of the first (non-MoE) layer
    vocab_size=102400,
    attention=AttentionConfig(
        kind="mla",
        num_heads=128,
        num_kv_heads=128,   # MLA: all heads share one compressed latent
        head_dim=128,       # = qk_nope_head_dim
        causal=True,
        use_rope=True,
        rope_theta=10_000.0,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_rope_head_dim=64,
        qk_nope_head_dim=128,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        d_ff_expert=1536,
        num_shared_experts=2,
        d_ff_shared=1536,
        capacity_factor=1.25,
    ),
    prefix_blocks=("attn_mlp",),  # dense first layer
    block_pattern=("moe_layer",),
    norm="rms",
    activation="silu_glu",
)

SMOKE = CONFIG.replace(
    num_layers=3,  # 1 dense prefix + 2 MoE
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=CONFIG.attention.replace(
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        kv_lora_rank=32,
        q_lora_rank=48,
        qk_rope_head_dim=8,
        qk_nope_head_dim=16,
        v_head_dim=16,
    ),
    moe=MoEConfig(
        num_experts=8,
        top_k=2,
        d_ff_expert=64,
        num_shared_experts=1,
        d_ff_shared=64,
        capacity_factor=4.0,
    ),
    param_dtype="float32",
    activation_dtype="float32",
)
