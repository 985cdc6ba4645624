"""Serving every architecture as the card does, on the CPU.

whisper-tiny in bf16 with the reference launcher's f32 frames: its
cross-attention's operands are promoted to one dtype before the kernel
(the card's kernel refuses mixed dtypes; the plain version on the host
does not), and its logits match the reference's on carried weights.
``launch.serve.prefill_launches`` against the attention, SSD and sLSTM
calls a prefill makes, for every architecture; the init's slice-by-slice
draws; and ``chip_smoke.py``'s phase 15 helpers: the recorder's
attention signature and the whole-model configs.
"""
import importlib.util
import math
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import lm, param
from repro_torch.models.blocks import effective_pattern, effective_prefix
from repro_torch.models.param import ParamSpec, carry, init_stacked

ROOT = Path(__file__).resolve().parents[1]
# tests/test_kernels.py's bf16 tolerance
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
B, S, S_CACHE = 2, 9, 16
BF16 = dict(param_dtype="bfloat16", activation_dtype="bfloat16")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _batch(cfg, seed=3):
    """Tokens, and the frontend's inputs in f32 as the launcher draws
    them."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if cfg.frontend.kind != "none":
        batch["frontend"] = rng.standard_normal(
            (B, cfg.frontend.num_positions, cfg.frontend.d_frontend)
        ).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


class _Spy:
    """Records every call of the model-layer wrappers of ``ops``: the
    attention's operand dtypes, and each call by kernel."""

    KERNEL = {"flash_attention": "flash_attention",
              "mamba2_ssd": "mamba2_ssd", "mamba2_ssd_state": "mamba2_ssd",
              "slstm_cell": "slstm_cell", "slstm_cell_state": "slstm_cell"}

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(serve.KERNELS, 0)
        self.dtypes = []
        for name, kernel in self.KERNEL.items():
            monkeypatch.setattr(ops, name, self._wrap(kernel,
                                                      getattr(ops, name)))

    def _wrap(self, kernel, fn):
        def call(*args, **kw):
            self.calls[kernel] += 1
            if kernel == "flash_attention":
                self.dtypes.append(tuple(t.dtype for t in args[:3]))
            return fn(*args, **kw)
        return call


def test_whisper_bf16_with_f32_frames_matches_reference(monkeypatch):
    """The reference launcher's f32 frames keep whisper's encoder in f32,
    so its cross-attention meets bf16 queries with f32 keys and values:
    every attention call reaches the kernel with one dtype (the mix
    promoted to f32, as the reference's einsums promote it), and the
    prefill's and the decode step's logits are the reference's on its
    weights within the bf16 tolerance."""
    jcfg = jget_smoke("whisper-tiny").replace(**BF16)
    cfg = get_smoke_config("whisper-tiny").replace(**BF16)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pre = dict(jb, tokens=jb["tokens"][:, :S - 1])
    jcache, w_pre = jlm.prefill(jparams, jcfg,
                                jlm.zero_cache(jcfg, B, S_CACHE), pre)
    _, w_dec = jlm.decode_step(jparams, jcfg, jcache, jb["tokens"][:, S - 1:],
                               jnp.asarray(S - 1, jnp.int32))

    spy = _Spy(monkeypatch)
    params = carry(jax.tree.map(np.asarray, jparams), "cpu")
    tb = _torch(batch)
    assert tb["frontend"].dtype == torch.float32
    with torch.inference_mode():
        cache, pre_logits = lm.prefill(
            params, cfg, lm.zero_cache(cfg, B, S_CACHE),
            dict(tb, tokens=tb["tokens"][:, :S - 1]))
        _, dec_logits = lm.decode_step(params, cfg, cache,
                                       tb["tokens"][:, S - 1:], S - 1)
    # encoder (f32), decoder self-attention (bf16) and cross-attention
    # (bf16 queries on f32 keys and values, promoted) in each layer
    assert spy.calls["flash_attention"] == 2 + 2 * 2
    assert all(len(set(d)) == 1 for d in spy.dtypes), spy.dtypes
    assert Counter(d[0] for d in spy.dtypes) \
        == {torch.bfloat16: 2, torch.float32: 4}
    for got, want in ((pre_logits, w_pre), (dec_logits, w_dec)):
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_launches_counts_a_prefills_kernel_calls(arch, monkeypatch):
    """``prefill_launches(cfg)`` is what a prefill calls: each kernel's
    calls through ``ops`` (each a launch on the card), at the smoke
    config and one group deeper."""
    spy = _Spy(monkeypatch)
    base = get_smoke_config(arch)
    depths = [base.num_layers]
    step = len(base.block_pattern)
    depths.append(base.num_layers + step)
    for layers in depths:
        cfg = base.replace(num_layers=layers)
        gen = torch.Generator().manual_seed(1)
        with torch.inference_mode():
            params = lm.init(gen, cfg)
            req = serve.make_request(cfg, 1, 6, gen, "cpu")
            front = serve.front_positions(cfg)
            spy.calls = dict.fromkeys(serve.KERNELS, 0)
            lm.prefill(params, cfg, lm.zero_cache(cfg, 1, 6 + front + 2),
                       req)
        assert spy.calls == serve.prefill_launches(cfg), (arch, layers)
        assert sum(spy.calls.values()) > 0


def test_prefill_launches_at_the_served_depths():
    """The counts phase 15 holds the card to (the launches listed by hand
    before): gemma2-9b's 42 layers, zamba2-7b's 9 (the shared block once),
    xlstm-125m's six sLSTM blocks, whisper-tiny's 4 encoder + 4 × 2
    decoder calls, and the MoE models at their cuts."""
    want = {
        ("gemma2-9b", None): {"flash_attention": 42},
        ("zamba2-7b", 9): {"flash_attention": 1, "mamba2_ssd": 9},
        ("xlstm-125m", None): {"slstm_cell": 6},
        ("whisper-tiny", None): {"flash_attention": 12},
        ("internvl2-2b", None): {"flash_attention": 24},
        ("nemotron-4-15b", None): {"flash_attention": 32},
        ("arctic-480b", 2): {"flash_attention": 2},
        ("deepseek-v2-236b", 8): {"flash_attention": 8},
    }
    for (arch, layers), n in want.items():
        cfg = configs.get_config(arch)
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        assert serve.prefill_launches(cfg) \
            == {**dict.fromkeys(serve.KERNELS, 0), **n}, arch


def test_init_draws_one_layer_at_a_time(monkeypatch):
    """``init_stacked`` draws no f32 tensor holding more than one layer of
    a stacked leaf, and a leaf past ``DRAW_ELEMENTS`` a slice of its
    leading axis at a time (an expert bank one expert at a time); the
    draws stay deterministic for a seed, each copy N(0, 1/fan_in)."""
    schema = {"experts": ParamSpec((16, 64, 48), ("experts", "embed", "ff")),
              "w": ParamSpec((64, 32), ("embed", "ff")),
              "norm": ParamSpec((64,), ("norm",), init="ones")}
    num = 3
    draws = []
    randn = torch.randn

    def spy(*args, **kw):
        out = randn(*args, **kw)
        draws.append((tuple(out.shape), out.dtype))
        return out

    monkeypatch.setattr(torch, "randn", spy)
    a = init_stacked(torch.Generator().manual_seed(5), schema, num,
                     "bfloat16")
    assert draws and all(dt == torch.float32 for _, dt in draws)
    assert sorted(shape for shape, _ in draws) \
        == sorted([(16, 64, 48)] * num + [(64, 32)] * num)
    # a small draw budget: slices of the leading axes, never a layer's
    # whole expert bank
    monkeypatch.setattr(param, "DRAW_ELEMENTS", 64 * 48 * 2)
    draws.clear()
    b = init_stacked(torch.Generator().manual_seed(5), schema, num,
                     "bfloat16")
    c = init_stacked(torch.Generator().manual_seed(5), schema, num,
                     "bfloat16")
    assert max(math.prod(shape) for shape, _ in draws) <= 64 * 48 * 2
    assert (2, 64, 48) in [shape for shape, _ in draws]
    for t in (a, b, c):
        assert t["experts"].shape == (num, 16, 64, 48)
        assert t["experts"].dtype == torch.bfloat16
        assert torch.equal(t["norm"], torch.ones(num, 64,
                                                 dtype=torch.bfloat16))
    assert all(torch.equal(b[k], c[k]) for k in schema)
    for layer in range(num):
        # each copy scaled by the spec's own fan-in (16 and 64)
        assert 0.9 / 4 < float(b["experts"][layer].float().std()) < 1.1 / 4
        assert 0.85 / 8 < float(b["w"][layer].float().std()) < 1.15 / 8


def test_init_tree_draws_a_large_leaf_in_slices(monkeypatch):
    """An unstacked leaf past the budget (nemotron-4-15b's 256000-row
    embedding) is drawn in blocks of rows."""
    monkeypatch.setattr(param, "DRAW_ELEMENTS", 1000)
    spec = {"embed": ParamSpec((300, 16), ("vocab", "embed"),
                               init="small_normal")}
    a = param.init_tree(torch.Generator().manual_seed(2), spec, "float32")
    b = param.init_tree(torch.Generator().manual_seed(2), spec, "float32")
    assert torch.equal(a["embed"], b["embed"])
    assert 0.018 < float(a["embed"].std()) < 0.022
    assert not torch.equal(a["embed"][:62], a["embed"][62:124])


def test_recorder_separates_whispers_three_kinds_of_attention():
    """phase 15's recorder keeps the first call of each attention
    signature: whisper's f32 encoder, f32 cross-attention (Sq ≠ Skv) and
    bf16 causal decoder self-attention are three, each with the route
    ``flash_attention.route`` names from its operands."""
    from repro_torch.kernels import flash_attention
    cs = _chip_smoke()
    cfg = get_smoke_config("whisper-tiny").replace(**BF16)
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        params = lm.init(gen, cfg)
        req = serve.make_request(cfg, 2, 8, gen, "cpu")
        with cs.KernelRecorder(ops, flash_attention.route) as rec:
            lm.prefill(params, cfg, lm.zero_cache(cfg, 2, 10), req)
    hd = cfg.attention.head_dim
    keys = {k[1:] for k in rec.first if k[0] == "flash_attention"}
    assert keys == {("float32", False, None, True, hd, hd),
                    ("float32", False, None, False, hd, hd),
                    ("bfloat16", True, None, True, hd, hd)}
    # two encoder, two cross (fma) and two decoder calls (wgmma: 16-wide
    # heads are a multiple of 8)
    assert rec.want_routes == {"wgmma": 2, "mma_sync": 0, "fma": 4}
    assert set(rec.first) >= {("flash_attention", *k) for k in keys}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_whole_model_configs_keep_every_block_kind(arch):
    """phase 15 (c)'s cut: full width, f32, every block kind of the
    published config (the encoder too), and at most ``LM_WHOLE_EXPERTS``
    experts with top-k kept, at the reference smoke configs' capacity
    factor."""
    cs = _chip_smoke()
    full = configs.get_config(arch)
    cut = cs.whole_model_config(configs, arch)
    kinds = lambda c: set(effective_prefix(c)) | set(effective_pattern(c))  # noqa: E731
    assert kinds(cut) == kinds(full)
    assert (cut.d_model, cut.attention, cut.vocab_size) \
        == (full.d_model, cut.attention if arch == "gemma2-9b"
            else full.attention, full.vocab_size)
    assert cut.param_dtype == cut.activation_dtype == "float32"
    assert (cut.encdec is None) == (full.encdec is None)
    launches = serve.prefill_launches(cut)
    assert {k for k, v in launches.items() if v} \
        == {k for k, v in serve.prefill_launches(full).items() if v}
    if full.moe is not None:
        assert cut.moe.num_experts == cs.LM_WHOLE_EXPERTS
        assert cut.moe.top_k == full.moe.top_k
        # the reference's smoke configs' capacity factor, under which
        # tests/test_serving.py holds decode to the forward
        assert cut.moe.capacity_factor \
            == jget_smoke(arch).moe.capacity_factor
    assert cs.LM_SERVING_TOL[arch] > 0 and cs.LM_WHOLE_REL[arch] > 0


def test_served_list_covers_every_architecture():
    cs = _chip_smoke()
    assert sorted(a for a, *_ in cs.LM_SERVED) == sorted(ARCH_IDS)
