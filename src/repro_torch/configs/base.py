"""Configuration dataclasses — a copy of ``repro.configs.base`` for the
port, which reads the architectures' widths from it without importing
the reference.  ``ModelConfig.param_count``/``active_param_count`` count
from the port's model schemas (:mod:`repro_torch.models.counting`).

The config system is deliberately explicit: every architecture in the assigned
pool is expressed as a frozen ``ModelConfig`` built out of small, composable
sub-configs.  Configs are pure data — building a model, a mesh, or a dry-run
plan from a config never mutates it.

Conventions
-----------
* All sizes are in *elements*, never bytes.
* ``block_pattern`` describes one scanned *group* of heterogeneous blocks; the
  model stacks ``num_groups`` copies of the group.
* ``param_dtype`` / ``activation_dtype`` are the dtypes used on the target
  hardware (TPU v5e → bfloat16); smoke tests may override to float32.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


class _Replaceable:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class AttentionConfig(_Replaceable):
    """Configuration of one attention block family.

    kind:
      * ``full``   — dense causal (or bidirectional) softmax attention
      * ``local``  — sliding-window attention (``window`` tokens)
      * ``mla``    — DeepSeek-V2 Multi-head Latent Attention (compressed KV)
    """

    kind: str = "full"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    window: Optional[int] = None  # only for kind == "local"
    logit_softcap: Optional[float] = None  # e.g. gemma-2 uses 50.0
    causal: bool = True
    rope_theta: float = 10_000.0
    use_rope: bool = True
    # --- MLA-specific (DeepSeek-V2) -------------------------------------
    kv_lora_rank: int = 0          # compressed KV dim (512 for DSv2)
    q_lora_rank: int = 0           # compressed Q dim (1536 for DSv2; 0 = dense Q)
    qk_rope_head_dim: int = 0      # decoupled RoPE key dim (64 for DSv2)
    qk_nope_head_dim: int = 0      # non-RoPE head dim (128 for DSv2)
    v_head_dim: int = 0            # value head dim (128 for DSv2)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)


@dataclass(frozen=True)
class MoEConfig(_Replaceable):
    """Mixture-of-experts FFN configuration (GShard/DeepSeek style)."""

    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 1024
    num_shared_experts: int = 0      # DeepSeek-V2: 2 shared experts
    d_ff_shared: int = 0             # hidden dim of the shared expert(s)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # arctic-style: dense residual FFN applied in parallel with the MoE FFN
    dense_residual_d_ff: int = 0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig(_Replaceable):
    """Mamba-2 (SSD) block configuration."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    ngroups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class XLSTMConfig(_Replaceable):
    """xLSTM block configuration (sLSTM + mLSTM blocks)."""

    num_heads: int = 4
    # mLSTM: matrix-memory block with qkv projections
    m_proj_factor: float = 2.0
    m_chunk_size: int = 256
    # sLSTM: scalar-memory recurrent block
    s_proj_factor: float = 4.0 / 3.0
    s_conv_kernel: int = 4


@dataclass(frozen=True)
class FrontendConfig(_Replaceable):
    """Modality frontend stub ([vlm] / [audio] archs).

    The frontend itself is a STUB: ``input_specs`` provides precomputed
    frame/patch embeddings with shape ``(batch, num_positions, d_frontend)``;
    the config only records the geometry so the backbone can fold them in.
    """

    kind: str = "none"  # none | patch | audio
    num_positions: int = 0        # patches per image / encoder frames
    d_frontend: int = 0           # embedding dim delivered by the stub


@dataclass(frozen=True)
class EncDecConfig(_Replaceable):
    """Encoder-decoder geometry (whisper)."""

    num_encoder_layers: int = 0
    encoder_positions: int = 1500  # whisper: 30 s of audio at 50 Hz


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int = 2
    d_model: int = 128
    d_ff: int = 512
    vocab_size: int = 1024

    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    encdec: Optional[EncDecConfig] = None

    # Heterogeneous layer pattern: the model body is ``scan`` over
    # ``num_groups`` copies of this group.  Valid block ids:
    #   "attn_mlp"        — standard pre-norm attention + FFN layer
    #   "local_attn_mlp"  — sliding-window attention + FFN layer
    #   "moe_layer"       — attention + MoE FFN layer
    #   "mamba2"          — Mamba-2 (SSD) block
    #   "mamba2_shared_attn" — Mamba-2 block w/ shared-attention interleave
    #   "slstm" / "mlstm" — xLSTM blocks
    block_pattern: Tuple[str, ...] = ("attn_mlp",)
    # Blocks *outside* the scan (e.g. DeepSeek's dense first layer).
    prefix_blocks: Tuple[str, ...] = ()
    # zamba2: shared attention block is invoked every `shared_attn_every`
    # scanned layers (weights shared across invocations).
    shared_attn_every: int = 0

    norm: str = "rms"            # rms | layer
    activation: str = "silu_glu"  # silu_glu | gelu_glu | gelu | relu2
    final_logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    max_seq_len: int = 8192

    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    # Skip long-context cells for pure quadratic-attention archs.
    supports_long_context: bool = False

    extra: Mapping[str, Any] = field(default_factory=dict)

    # ----- derived -------------------------------------------------------
    @property
    def num_groups(self) -> int:
        pat = len(self.block_pattern)
        body = self.num_layers - len(self.prefix_blocks)
        assert body % pat == 0, (
            f"{self.name}: {body} body layers not divisible by pattern of {pat}"
        )
        return body // pat

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + body), exact for our defs."""
        from repro_torch.models.counting import config_param_count

        return config_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.counting import config_active_param_count

        return config_active_param_count(self)


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set for the LM pool)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = InputShape("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = InputShape("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = InputShape("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = InputShape("long_500k", seq_len=524_288, global_batch=1, kind="decode")

ALL_SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ModelConfig) -> Tuple[InputShape, ...]:
    """The runnable shape cells for an architecture.

    ``long_500k`` requires sub-quadratic attention: it runs only for
    SSM/hybrid archs (zamba2, xlstm); pure full-attention archs skip it
    (recorded in DESIGN.md §Arch-applicability).
    """
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return tuple(out)


# ---------------------------------------------------------------------------
# Training/runtime config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig(_Replaceable):
    name: str = "adamw"
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip_norm: float = 1.0
    moment_dtype: str = "float32"   # huge archs override to bfloat16
    # gradient compression for the cross-pod all-reduce ("none"|"bf16"|"int8")
    grad_compression: str = "none"


@dataclass(frozen=True)
class RunConfig:
    """One training / serving run: model + shape + parallelism + optimizer."""

    model: ModelConfig = field(default_factory=ModelConfig)
    shape: InputShape = TRAIN_4K
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    # parallelism
    microbatches: int = 1          # gradient-accumulation chunks per step
    remat: str = "full"            # none | full | dots  (activation ckpt policy)
    scan_layers: bool = True
    # attention lowering knobs (see repro.models.layers.blockwise_attention)
    attn_impl: str = "chunked_scan"  # chunked_scan | chunked_tri
    q_chunk: int = 512
    kv_chunk: int = 1024
    moe_impl: str = "scatter"        # scatter | a2a (shard_map EP dispatch)
    sharding_preset: str = "tp_fsdp"  # tp_fsdp | fsdp_only (ZeRO-3, no TP)
    # fault tolerance
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    max_step_retries: int = 2
    straggler_slack: float = 2.0   # × predicted step time before flagged
    seed: int = 0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
