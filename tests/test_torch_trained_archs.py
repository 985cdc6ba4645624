"""Training every architecture as the card does, on the CPU.

``launch.train.step_launches`` against the kernel custom ops one train
step dispatches, forward and backward and by operand dtype, for every
architecture under remat ``full`` and ``none``, and at the cuts
``chip_smoke.py`` trains; whisper-tiny in bf16 with f32 frames trained
one step against the reference's ``jax.value_and_grad`` on carried
weights; ``chip_smoke.py``'s training cuts (``LM_TRAINED``: every block
kind kept, the training state inside the card) and its step bound (an
encoder-decoder's encoder and cross-attention counted).
"""
import importlib.util
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape, OptimizerConfig, RunConfig
from repro_torch.launch import serve, steps
from repro_torch.launch.presets import make_run_config
from repro_torch.launch.train import step_launches
from repro_torch.models import counting, lm
from repro_torch.models.blocks import effective_pattern, effective_prefix
from repro_torch.models.param import carry, tree_leaves, tree_map
from repro_torch.optim import adamw
from test_torch_train_models import leaf, make_batch, np_leaves, to_torch

ROOT = Path(__file__).resolve().parents[1]
BF16 = dict(param_dtype="bfloat16", activation_dtype="bfloat16")
# tests/test_kernels.py's bf16 tolerance, of each gradient leaf's max |g|
# and of the loss
BF16_REL = 2e-2
GiB = 2 ** 30


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


class _OpSpy(TorchDispatchMode):
    """Counts every call of the port's kernel custom ops, by the launch
    counter its kernel reports to on the card (``chip_smoke.KERNEL_OPS``)
    and the dtype of its first tensor operand, and records the dtypes of
    all its tensor operands."""

    def __init__(self, kernel_ops):
        super().__init__()
        self.counter = {op: name for name, ops in kernel_ops.items()
                        for op in ops}
        self.calls = Counter()
        self.operand_dtypes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if func.namespace == "repro_torch" and name in self.counter:
            dts = [str(a.dtype).split(".")[1] for a in args
                   if isinstance(a, torch.Tensor)]
            self.calls[(self.counter[name], dts[0])] += 1
            self.operand_dtypes.append((name, tuple(dts)))
        return func(*args, **(kwargs or {}))


def _one_step(cfg, remat, microbatches=2, batch=2, seq=24, kernel_ops=None):
    """One ``make_train_step`` call at ``cfg`` under the spy."""
    run = RunConfig(model=cfg, shape=InputShape("t", seq, batch, "train"),
                    optimizer=OptimizerConfig(learning_rate=1e-3,
                                              warmup_steps=1),
                    microbatches=microbatches, remat=remat)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        params = tree_map(lambda t: t.requires_grad_(), lm.init(gen, cfg))
    opt = adamw.init_opt_state(params, run.optimizer)
    from repro_torch.data import make_batch_iterator
    data = next(make_batch_iterator(cfg, run.shape, seed=1, device="cpu"))
    with _OpSpy(kernel_ops) as spy:
        _, _, metrics = steps.make_train_step(run)(params, opt, data)
    assert np.isfinite(float(metrics["loss"]))
    return spy


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_launches_counts_a_train_steps_kernel_calls(arch, remat):
    """``step_launches(cfg, 2, remat)`` is what one train step of 2
    microbatches calls, kernel by kernel forward and backward, and by
    the dtype of the operands: the smoke config in bf16 with f32 frames
    (whisper's encoder and cross-attention f32, the rest of the
    attention bf16, the SSD and the sLSTM f32)."""
    cs = _chip_smoke()
    cfg = get_smoke_config(arch).replace(**BF16)
    spy = _one_step(cfg, remat, kernel_ops=cs.KERNEL_OPS)
    for dtype in ("float32", "bfloat16"):
        got = {k: spy.calls[(k, dtype)] for k in step_launches(cfg, 2)}
        assert got == step_launches(cfg, 2, remat, dtype), (arch, dtype)
    assert {k for k, _ in spy.calls} <= set(step_launches(cfg, 2))
    assert sum(spy.calls.values()) == sum(step_launches(cfg, 2,
                                                        remat).values()) > 0
    # every call meets operands of one dtype (the card's kernels take no
    # mix)
    assert all(len(set(d)) == 1 for _, d in spy.operand_dtypes), \
        spy.operand_dtypes


def test_step_launches_at_the_trained_cuts():
    """The counts phases 16 (b) and 17 (b) held the card to, as they were
    listed by hand: gemma2-9b 64 + 32, zamba2-7b's and xlstm-125m's."""
    cs = _chip_smoke()
    zero = dict.fromkeys(step_launches(configs.get_config("gemma2-9b"), 1),
                         0)
    want = {
        "gemma2-9b": {"flash_attention": 8 * 4 * 2,
                      "flash_attention_bwd": 8 * 4},
        "zamba2-7b": {"mamba2_ssd": (3 + 6 * 2) * 8, "mamba2_ssd_bwd": 9 * 8,
                      "flash_attention": 2 * 8, "flash_attention_bwd": 8},
        "xlstm-125m": {"slstm_cell": 6 * 2, "slstm_cell_bwd": 6},
        "whisper-tiny": {"flash_attention": 160, "flash_attention_bwd": 96},
        "deepseek-v2-236b": {"flash_attention": 24,
                             "flash_attention_bwd": 16},
    }
    for arch, n in want.items():
        assert cs.trained_launches(configs, arch) == {**zero, **n}, arch
    whisper = cs.trained_config(configs, "whisper-tiny")
    assert step_launches(whisper, 8, "full", "float32") \
        == {**zero, "flash_attention": 96, "flash_attention_bwd": 64}


def test_whisper_bf16_train_step_matches_reference():
    """whisper-tiny's smoke config with bf16 parameters and f32 frames:
    the loss and every gradient leaf (within ``BF16_REL`` × its max |g|)
    of the reference's ``jax.value_and_grad`` on its weights, and every
    kernel call, forward and backward, on operands of one dtype."""
    jcfg = jget_smoke("whisper-tiny").replace(**BF16)
    cfg = get_smoke_config("whisper-tiny").replace(**BF16)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    batch = make_batch(cfg)
    assert batch["frontend"].dtype == np.float32
    fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, jcfg, b)[0]))
    want_loss, jgrads = fn(jparams,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    want = np_leaves(jax.tree.map(lambda g: g.astype(jnp.float32), jgrads))
    params = tree_map(lambda t: t.requires_grad_(),
                      carry(jax.tree.map(np.asarray, jparams), "cpu"))
    run = RunConfig(model=cfg, shape=InputShape("t", 32, 2, "train"),
                    optimizer=OptimizerConfig())
    with _OpSpy(_chip_smoke().KERNEL_OPS) as spy:
        loss, _, grads = steps.value_and_grad(steps.make_loss_fn(run),
                                              params, to_torch(batch))
    assert len(tree_leaves(grads)) == len(want)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=BF16_REL)
    for path, w in want:
        g = leaf(grads, path)
        assert g.dtype == torch.bfloat16, path
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g.double().numpy() - w.astype(np.float64)).max())
        assert err <= BF16_REL * scale, (path, err / scale)
    assert all(len(set(d)) == 1 for _, d in spy.operand_dtypes)
    assert Counter(d[0] for _, d in spy.operand_dtypes) \
        == {dt: sum(step_launches(cfg, 1, run.remat, dt).values())
            for dt in ("float32", "bfloat16")}


def _kinds(cfg):
    return set(effective_prefix(cfg)) | set(effective_pattern(cfg))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_trained_cuts_keep_every_block_kind_and_fit_the_card(arch):
    """``LM_TRAINED``'s cut of each architecture keeps the published
    widths, every block kind and the experts' top-k; its training state
    — bf16 parameters, the accumulated and the microbatch's gradients,
    two moments in the preset's dtype — from ``lm.abstract_params``
    leaves at least ``TRAIN_ACTIVATIONS_GIB`` of the card's 80 GB."""
    cs = _chip_smoke()
    full = configs.get_config(arch)
    cut = cs.trained_config(configs, arch)
    assert _kinds(cut) == _kinds(full)
    assert (cut.d_model, cut.attention, cut.vocab_size, cut.d_ff,
            cut.param_dtype) == (full.d_model, full.attention,
                                 full.vocab_size, full.d_ff, "bfloat16")
    if full.moe is not None:
        assert cut.moe.top_k == full.moe.top_k
        assert cut.moe.d_ff_expert == full.moe.d_ff_expert
    layers, experts, seq, batch = cs.LM_TRAINED[arch]
    run = make_run_config(arch, "train_4k", model_config=cut)
    assert batch % run.microbatches == 0 and seq <= 4096
    moment = torch.tensor([], dtype=getattr(
        torch, run.optimizer.moment_dtype)).element_size()
    state = sum(p.numel() * (3 * p.element_size() + 2 * moment)
                for p in tree_leaves(lm.abstract_params(cut)))
    assert state == cs.training_state_bytes(cut, run)
    assert state <= 80 * 1e9 - cs.TRAIN_ACTIVATIONS_GIB * GiB, \
        (arch, state / GiB)


def test_trained_list_covers_every_architecture():
    cs = _chip_smoke()
    assert sorted(cs.LM_TRAINED) == sorted(ARCH_IDS)
    assert sorted({cs.TRAIN_ARCH, *cs.RECURRENT_TRAIN, *cs.TRAIN_MORE}) \
        == sorted(ARCH_IDS)
    assert set(cs.TRAIN_MORE_WHOLE) <= set(cs.TRAIN_MORE)


def _token_and_frame_params(cfg):
    """(token, frame) parameter counts of ``cfg``'s parameter tree: an
    encoder-decoder's encoder, frontend projection and cross-attention
    K/V projections run on its frames, every other leaf on its tokens."""
    split = [0, 0]

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        on_frames = cfg.encdec is not None and (
            path[0] in ("encoder", "frontend_proj")
            or "cross" in path and path[-1] in ("wk", "wv"))
        split[on_frames] += tree.numel()

    walk(lm.abstract_params(cfg))
    return tuple(split)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_bound_counts_an_encoders_work(arch):
    """A train step's bound is 6 × the parameters that run on the tokens
    a token, the attention's ``attention_flops``, and for an
    encoder-decoder three times (forward and backward) the work on its
    frames: 2 × the encoder's, the frontend's and the cross K/V
    parameters a frame, the encoder's non-causal and the cross scores; a
    served prefill counts each once.  For every other architecture the
    bound is ``model_flops + attention_flops``, as before."""
    cs = _chip_smoke()
    cfg = cs.trained_config(configs, arch)
    _, _, seq, batch = cs.LM_TRAINED[arch]
    shape = InputShape("t", seq, batch, "train")
    pshape = InputShape("p", seq + serve.front_positions(cfg), batch,
                        "prefill")
    bound = cs.train_step_flops(counting, cfg, shape)
    prefill = cs.served_prefill_flops(counting, InputShape, cfg, batch, seq)
    if cfg.encdec is None:
        assert bound == counting.model_flops(cfg, shape) \
            + counting.attention_flops(cfg, shape)
        assert prefill == counting.model_flops(cfg, pshape) \
            + counting.attention_flops(cfg, pshape)
        return
    tokens, frames = _token_and_frame_params(cfg)
    assert tokens + frames == counting.config_active_param_count(cfg)
    a, T = cfg.attention, cfg.encdec.encoder_positions
    dq = a.num_heads * a.head_dim
    scores = 4 * batch * T * dq * (cfg.encdec.num_encoder_layers * T
                                   + cfg.num_layers * seq)
    on_frames = 2 * batch * T * frames + scores
    want = 6 * tokens * batch * seq + counting.attention_flops(cfg, shape) \
        + 3 * on_frames
    assert bound == pytest.approx(want, rel=1e-12)
    assert prefill == pytest.approx(
        2 * tokens * batch * seq + counting.attention_flops(cfg, pshape)
        + on_frames, rel=1e-12)
    # whisper-tiny: 4 encoder layers of 1.77 M and 4 decoder layers'
    # cross K/V of 0.29 M run on the frames, not on the tokens
    assert frames > 8e6 and bound < counting.model_flops(cfg, shape) \
        + counting.attention_flops(cfg, shape) + 3 * on_frames


def test_backward_cases_routes_and_timed_layers():
    """Phase 16 (a)'s cases: each bf16 case on the route ``route`` names
    (the kernel's count must agree on the card), the seven cases of the
    trained shapes among them; its timed layers are the main path's
    (the first case, in bf16, first: the kernels line's row), then
    deepseek-v2-236b's MLA and whisper-tiny's f32 encoder as the trained
    cuts shape them (a microbatch's rows, every head)."""
    from repro_torch.kernels.flash_attention import route
    cs = _chip_smoke()
    assert len(cs.ATTN_BWD_CASES) == len(cs.ATTN_BWD_ROUTES) == 13
    for case, want in zip(cs.ATTN_BWD_CASES, cs.ATTN_BWD_ROUTES):
        assert route(torch.bfloat16, case[6], case[7]) == want, case[0]
    groups = {c[4] // c[5] for c in cs.ATTN_BWD_CASES}
    assert {4, 6, 7} <= groups
    mla = configs.get_config("deepseek-v2-236b").attention
    whisper = cs.trained_config(configs, "whisper-tiny")
    _, _, seq, batch = cs.LM_TRAINED["deepseek-v2-236b"]
    w_batch = cs.LM_TRAINED["whisper-tiny"][3]
    main = cs.ATTN_BWD_CASES[0]
    assert cs.ATTN_BWD_TIMED[0][0] == main[0]
    assert cs.ATTN_BWD_TIMED[0][9:12] == main[9:12]
    want = {
        main[0]: (*main[1:9], "bfloat16"),
        "deepseek-v2-236b MLA": (
            batch // make_run_config("deepseek-v2-236b",
                                     "train_4k").microbatches, seq, seq,
            mla.num_heads, mla.num_heads,
            mla.qk_nope_head_dim + mla.qk_rope_head_dim, mla.v_head_dim,
            True, "bfloat16"),
        "whisper-tiny encoder": (
            w_batch // make_run_config("whisper-tiny",
                                       "train_4k").microbatches,
            whisper.encdec.encoder_positions,
            whisper.encdec.encoder_positions, whisper.attention.num_heads,
            whisper.attention.num_kv_heads, whisper.attention.head_dim,
            whisper.attention.head_dim, False, "float32")}
    assert {c[0]: (*c[1:9], c[12]) for c in cs.ATTN_BWD_TIMED} == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stream_permutes_exactly_where_its_map_is_a_bijection(arch):
    """``stream_permutes``: the synthetic stream's map x → a·x + b mod V
    hits every word (a permutation) or folds the vocabulary onto V / a
    of them; phase 20 gives the streams that permute more steps."""
    from repro_torch.data import SyntheticLMDataset
    cs = _chip_smoke()
    cfg = configs.get_config(arch)
    ds = SyntheticLMDataset(cfg, 8, 1)
    V = cfg.vocab_size
    image = np.unique((ds.a * np.arange(V, dtype=np.int64) + ds.b) % V).size
    assert cs.stream_permutes(cfg) == (image == V)
    if not cs.stream_permutes(cfg):
        assert image == V // ds.a


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_more_steps_by_stream(arch):
    """Phase 20 trains 4 steps, 12 where the stream permutes the
    vocabulary (granite-8b and internvl2-2b), whose loss needs the
    steps to learn the map itself; every run's last loss must be below
    its first."""
    cs = _chip_smoke()
    cfg = configs.get_config(arch)
    want = cs.TRAIN_PERMUTED_STEPS if arch in ("granite-8b", "internvl2-2b") \
        else cs.TRAIN_MORE_STEPS
    assert cs.stream_permutes(cfg) == (arch in ("granite-8b", "internvl2-2b",
                                                "xlstm-125m"))
    if arch in cs.TRAIN_MORE:
        assert cs.train_more_steps(cfg) == want
    assert cs.TRAIN_PERMUTED_STEPS > cs.TRAIN_MORE_STEPS == 4
