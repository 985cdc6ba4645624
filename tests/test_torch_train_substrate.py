"""The port's training substrate (``repro_torch.{optim, data, checkpoint,
runtime}`` and ``launch.{train, train_lm}``) on the CPU.

Mirrors the reference's ``tests/test_substrate.py`` (its 13 tests, the
slow failure-recovery test run at its tiny size, elastic reshard a test
that ``reshard`` raises until the mesh is ported),
``tests/test_runtime.py`` (7) and ``tests/test_checkpoint_property.py``
(2), parametrised alike; then against the reference itself: AdamW's
update and schedule on the same numpy params and grads for each
gradient compression within 1e-6, the synthetic stream bit for bit, and
checkpoints written by either package restored by the other bit for bit.
"""
import itertools
import json
import tempfile
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_tree as jrestore_tree
from repro.checkpoint import save_tree as jsave_tree
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.data.pipeline import SyntheticLMDataset as JSyntheticLMDataset
from repro.optim import adamw as jadamw
from repro.testing.proptest import hypothesis, st
from repro_torch.checkpoint import (CheckpointManager, atomic_write_json,
                                    restore_tree, save_tree)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape, OptimizerConfig, RunConfig
from repro_torch.data import SyntheticLMDataset, make_batch_iterator
from repro_torch.launch import train as train_cli
from repro_torch.launch import train_lm
from repro_torch.optim import adamw
from repro_torch.profiles import profile
from repro_torch.runtime import StragglerMonitor, Trainer
from repro_torch.runtime.trainer import TrainState

CPU = "cpu"


# ---------------------------------------------------------------------------
# optimizer (tests/test_substrate.py)
# ---------------------------------------------------------------------------


def test_adamw_minimizes_quadratic():
    ocfg = OptimizerConfig(learning_rate=0.1, warmup_steps=1,
                           total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_opt_state(params, ocfg)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.apply_updates(params, grads, state, ocfg)
    assert float(params["w"].abs().max()) < 0.3


def test_lr_schedule_shape():
    ocfg = OptimizerConfig(learning_rate=1.0, warmup_steps=10,
                           total_steps=100)
    lrs = [float(adamw.lr_schedule(ocfg, torch.tensor(s))) for s in
           (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(0.1, rel=1e-3)  # floor = 10% of peak


def test_grad_clip_bounds_update():
    ocfg = OptimizerConfig(learning_rate=1e-3, grad_clip_norm=1.0,
                           warmup_steps=0, total_steps=10, weight_decay=0.0)
    params = {"w": torch.zeros((4,))}
    state = adamw.init_opt_state(params, ocfg)
    grads = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw.apply_updates(params, grads, state, ocfg)
    assert metrics["grad_norm"] > 1e5  # reported raw


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_grad_compression_modes(mode):
    ocfg = OptimizerConfig(grad_compression=mode, warmup_steps=0,
                           total_steps=10)
    params = {"w": torch.ones((8,))}
    state = adamw.init_opt_state(params, ocfg)
    grads = {"w": torch.linspace(-1, 1, 8)}
    p2, _, _ = adamw.apply_updates(params, grads, state, ocfg)
    assert bool(torch.isfinite(p2["w"]).all())


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_data_deterministic_per_step():
    cfg = get_smoke_config("yi-6b")
    ds = SyntheticLMDataset(cfg, seq_len=16, global_batch=4, seed=3)
    a = ds.batch_at(7)
    b = ds.batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = ds.batch_at(8)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_data_learnable_structure():
    cfg = get_smoke_config("yi-6b")
    ds = SyntheticLMDataset(cfg, seq_len=64, global_batch=8, seed=0)
    b = ds.batch_at(0)
    x, y = b["tokens"], b["targets"]
    pred = (ds.a * x + ds.b) % cfg.vocab_size
    agree = float(np.mean(pred == y))
    assert agree > 0.8  # 10% noise rate → ~90% affine-predictable


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def _abstract(tree):
    return {k: _abstract(v) if isinstance(v, dict)
            else torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3).to(torch.bfloat16),
            "b": {"c": torch.ones((4,), dtype=torch.float32)}}
    save_tree(tree, tmp_path / "ck")
    back = restore_tree(tmp_path / "ck", _abstract(tree))
    np.testing.assert_array_equal(back["a"].float().numpy(),
                                  tree["a"].float().numpy())
    np.testing.assert_array_equal(back["b"]["c"].numpy(),
                                  tree["b"]["c"].numpy())


def test_checkpoint_manager_retention_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones((3,))}
    for s in (5, 10, 15, 20):
        mgr.save(s, tree, blocking=True)
    assert mgr.all_steps() == [15, 20]
    assert mgr.latest_step() == 20
    abstract = {"w": torch.empty((3,), dtype=torch.float32, device="meta")}
    back = mgr.restore(20, abstract)
    np.testing.assert_array_equal(back["w"].numpy(), tree["w"].numpy())


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"w": torch.zeros((2,))}, blocking=True)
    assert not list(tmp_path.glob("*.tmp"))


def test_checkpoint_save_snapshots_before_an_in_place_update(tmp_path):
    """The port's optimizer updates tensors in place: a save must copy
    them before it returns, whatever the writer thread does later."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    w = torch.ones((1000,))
    mgr.save(1, {"w": w})
    w.mul_(5.0)
    mgr.wait()
    back = mgr.restore(1, {"w": torch.empty((1000,), device="meta")})
    assert float(back["w"].max()) == 1.0


# ---------------------------------------------------------------------------
# trainer: fault tolerance + straggler monitor (+ reshard, not yet)
# ---------------------------------------------------------------------------


def _tiny_run(tmp_path, **kw):
    cfg = get_smoke_config("yi-6b")
    shape = InputShape("tiny", seq_len=32, global_batch=8, kind="train")
    kw.setdefault("checkpoint_every", 5)
    return RunConfig(
        model=cfg, shape=shape,
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=5,
                                  total_steps=100),
        microbatches=2, checkpoint_dir=str(tmp_path / "ckpt"),
        max_step_retries=3, **kw)


def test_trainer_failure_recovery(tmp_path):
    run = _tiny_run(tmp_path)
    fails = {7: True}
    tr = Trainer(run, failure_hook=lambda s: fails.pop(s, False),
                 device=CPU)
    state = tr.train(tr.restore_or_init(), 12, log_every=0)
    tr.ckpt.wait()
    assert state.step == 12
    events = [m for m in tr.metrics_log if m.get("event") == "restored"]
    assert len(events) == 1
    losses = [m["loss"] for m in tr.metrics_log if "loss" in m]
    assert losses[-1] < losses[0]
    # cold resume picks up the latest checkpoint
    tr2 = Trainer(run, device=CPU)
    assert tr2.restore_or_init().step >= 10


def test_straggler_monitor_flags():
    mon = StragglerMonitor(slack=2.0, predicted_step_s=0.1)
    assert mon.observe(1, 0.12) is None
    ev = mon.observe(2, 0.5)
    assert ev is not None and ev.ratio == pytest.approx(5.0)


def test_straggler_monitor_median_fallback():
    mon = StragglerMonitor(slack=3.0)
    for i in range(6):
        mon.observe(i, 0.1)
    assert mon.observe(7, 1.0) is not None


def test_reshard_and_a_mesh_raise_until_the_mesh_is_ported(tmp_path):
    """The reference's elastic reshard moves state onto a new mesh; the
    port has no mesh yet (ROADMAP queue A item 5) and says so."""
    run = _tiny_run(tmp_path)
    tr = Trainer(run, device=CPU)
    state = tr.train(tr.restore_or_init(), 1, log_every=0)
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        tr.reshard(state, object())
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        Trainer(run, mesh=object(), device=CPU)
    assert train_cli.main(["--arch", "yi-6b", "--smoke",
                           "--model-parallel", "2", "--device", CPU]) == 2


# ---------------------------------------------------------------------------
# StragglerMonitor (tests/test_runtime.py)
# ---------------------------------------------------------------------------


def test_predicted_expectation_mode():
    mon = StragglerMonitor(slack=2.0, predicted_step_s=0.1)
    assert mon.expectation() == 0.1         # model prediction, immediately
    assert mon.observe(1, 0.15) is None
    ev = mon.observe(2, 0.3)
    assert ev is not None
    assert ev.step == 2
    assert ev.expected_s == 0.1
    assert ev.ratio == pytest.approx(3.0)
    assert mon.events == [ev]


def test_median_fallback_needs_five_samples():
    mon = StragglerMonitor(slack=2.0)
    for i in range(4):
        assert mon.observe(i, 10.0) is None  # no expectation yet
    assert mon.expectation() is None
    mon.observe(4, 10.0)
    assert mon.expectation() == pytest.approx(10.0)
    assert mon.observe(5, 25.0) is not None


def test_median_fallback_uses_windowed_median():
    mon = StragglerMonitor(slack=2.0, window=4)
    for i, t in enumerate([1.0, 1.0, 1.0, 1.0, 1.0]):
        mon.observe(i, t)
    for i, t in enumerate([0.2, 0.2, 0.2, 0.2], start=5):
        mon.observe(i, t)
    assert mon.expectation() == pytest.approx(0.2)


def test_flagged_samples_stay_out_of_the_window():
    mon = StragglerMonitor(slack=3.0)
    for i in range(5):
        mon.observe(i, 0.1)
    for i in range(5, 15):
        ev = mon.observe(i, 1.0)
        assert ev is not None, f"straggler at step {i} was masked"
        assert ev.expected_s == pytest.approx(0.1)
    assert mon.expectation() == pytest.approx(0.1)
    assert len(mon._times) == 5             # window holds clean samples only
    assert len(mon.events) == 10


def test_on_straggler_callback_fires_per_event():
    seen = []
    mon = StragglerMonitor(slack=2.0, predicted_step_s=0.1,
                           on_straggler=seen.append)
    mon.observe(1, 0.1)
    mon.observe(2, 0.5)
    mon.observe(3, 0.12)
    mon.observe(4, 0.9)
    assert [e.step for e in seen] == [2, 4]
    assert seen == mon.events


def test_trainer_flags_slow_step_against_model_prediction(
        tmp_path, monkeypatch):
    run = _tiny_run(tmp_path, straggler_slack=3.0, checkpoint_every=0)
    tr = Trainer(run, predicted_step_s=0.01, device=CPU)
    flagged = []
    tr.monitor.on_straggler = flagged.append
    loss = torch.tensor(1.0)

    def fake_step(params, opt_state, batch):
        # Trainer increments step AFTER the call: this executes step 3
        # when state.step == 2, i.e. on the third call
        if fake_step.calls == 2:
            time.sleep(0.08)                # 8× prediction: a straggler
        fake_step.calls += 1
        return params, opt_state, {"loss": loss}

    fake_step.calls = 0
    monkeypatch.setattr(tr, "_train_step", fake_step)
    monkeypatch.setattr("repro_torch.runtime.trainer.make_batch_iterator",
                        lambda *a, **kw: itertools.repeat(None))

    state = tr.train(TrainState({}, {}, 0), 5, log_every=0)
    assert state.step == 5
    assert [e.step for e in flagged] == [3]
    assert flagged == tr.monitor.events
    assert flagged[0].expected_s == 0.01
    assert flagged[0].ratio > 3.0
    walls = [m["wall_s"] for m in tr.metrics_log if "wall_s" in m]
    assert len(walls) == 5
    assert walls[2] > 0.05


def test_trainer_wires_slack_and_prediction_into_monitor(tmp_path):
    run = _tiny_run(tmp_path, straggler_slack=4.5, checkpoint_every=0)
    tr = Trainer(run, predicted_step_s=0.25, device=CPU)
    assert tr.monitor.slack == 4.5
    assert tr.monitor.predicted_step_s == 0.25
    tr2 = Trainer(run, device=CPU)
    assert tr2.monitor.predicted_step_s is None
    assert tr2.monitor.expectation() is None


# ---------------------------------------------------------------------------
# checkpoint properties (tests/test_checkpoint_property.py)
# ---------------------------------------------------------------------------


@hypothesis.given(
    st.sampled_from(["float32", "bfloat16", "int32", "float16"]),
    st.lists(st.integers(1, 5), min_size=1, max_size=3),
    st.integers(0, 2 ** 31 - 1),
)
@hypothesis.settings(max_examples=25, deadline=None)
def test_roundtrip_bit_exact(dtype, shape, seed):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(seed)
    if dtype == "int32":
        arr = torch.randint(-1000, 1000, shape, generator=gen).to(dt)
    else:
        arr = torch.randn(shape, generator=gen).to(dt)
    tree = {"x": arr, "nested": {"y": arr * 2}}
    with tempfile.TemporaryDirectory() as d:
        save_tree(tree, Path(d) / "ck")
        back = restore_tree(Path(d) / "ck", _abstract(tree))
    for a, b in ((tree["x"], back["x"]),
                 (tree["nested"]["y"], back["nested"]["y"])):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_atomic_write_json_concurrent_same_path_never_tears(tmp_path):
    """Each rename publishes one complete document: concurrent writers of
    one path leave exactly one writer's full JSON and no tmp files (the
    checkpoint manifest goes through the same writer)."""
    assert atomic_write_json is profile.atomic_write_json
    path = tmp_path / "shared_profile.json"
    n_threads, rounds = 8, 5
    payloads = [{"writer": i, "blob": [i] * 4096, "tag": f"w{i}" * 64}
                for i in range(n_threads)]
    for _ in range(rounds):
        barrier = threading.Barrier(n_threads)
        errors = []

        def write(i):
            try:
                barrier.wait()
                atomic_write_json(path, payloads[i])
            except Exception as e:          # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=write, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        loaded = json.loads(path.read_text())
        assert loaded in payloads
        assert loaded["blob"] == [loaded["writer"]] * 4096
    assert list(tmp_path.glob("*.tmp")) == []


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def _tree(rng):
    """A parameter tree with matrices (decayed) and vectors (not), and
    gradients of several scales, as numpy float32."""
    params = {"embed": rng.standard_normal((16, 8)).astype(np.float32),
              "body": {"w": rng.standard_normal((3, 8, 8)).astype(np.float32),
                       "norm": rng.standard_normal((8,)).astype(np.float32)}}
    grads = {"embed": rng.standard_normal((16, 8)).astype(np.float32) * 3,
             "body": {"w": rng.standard_normal((3, 8, 8)).astype(np.float32),
                      "norm": rng.standard_normal((8,)).astype(
                          np.float32) * 1e-3}}
    return params, grads


def _np_map(fn, tree):
    return {k: _np_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    """Leaves in sorted-key order, as ``jax.tree.leaves`` walks a dict."""
    return [x for k in sorted(tree)
            for x in (_leaves(tree[k]) if isinstance(tree[k], dict)
                      else [tree[k]])]


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_apply_updates_matches_reference(mode, moment_dtype):
    """Four AdamW steps from the same numpy params and grads (clipping
    active: the grads' norm is above 1): parameters, both moments, the
    count and the metrics within 1e-6."""
    rng = np.random.default_rng(0)
    params, grads = _tree(rng)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              grad_compression=mode, moment_dtype=moment_dtype)
    jcfg, tcfg = JOptimizerConfig(**kw), OptimizerConfig(**kw)
    jp = _np_map(jnp.asarray, params)
    js = jadamw.init_opt_state(jp, jcfg)
    tp = _np_map(lambda a: torch.from_numpy(a.copy()), params)
    ts = adamw.init_opt_state(tp, tcfg)
    for step in range(4):
        g = _np_map(lambda a: a * (1 + step), grads)
        jp, js, jm = jadamw.apply_updates(jp, _np_map(jnp.asarray, g), js,
                                          jcfg)
        tp, ts, tm = adamw.apply_updates(
            tp, _np_map(torch.from_numpy, g), ts, tcfg)
    for want, got in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        for w, t in zip(_leaves(want), _leaves(got)):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(w, np.float32),
                                       rtol=1e-6, atol=1e-6)
    assert int(ts.count) == int(js.count) == 4
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


def test_lr_schedule_and_global_norm_match_reference():
    ocfg = dict(learning_rate=3e-4, warmup_steps=7, total_steps=50)
    for s in (0, 1, 3, 7, 8, 20, 49, 50, 80):
        np.testing.assert_allclose(
            float(adamw.lr_schedule(OptimizerConfig(**ocfg), s)),
            float(jadamw.lr_schedule(JOptimizerConfig(**ocfg),
                                     jnp.asarray(s))), rtol=1e-6)
    _, grads = _tree(np.random.default_rng(1))
    np.testing.assert_allclose(
        float(adamw.global_norm(_np_map(torch.from_numpy, grads))),
        float(jadamw.global_norm(_np_map(jnp.asarray, grads))), rtol=1e-6)


@pytest.mark.parametrize("arch,seq", [("yi-6b", 48), ("internvl2-2b", 64),
                                      ("whisper-tiny", 40)])
def test_batch_at_is_bit_identical_to_reference(arch, seq):
    """The same numpy stream per (seed, step), frontend arrays included;
    the iterator puts exactly it on the device, tokens as int64."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    for seed, step in ((0, 0), (3, 7), (11, 1000)):
        want = JSyntheticLMDataset(jcfg, seq, 4, seed=seed).batch_at(step)
        got = SyntheticLMDataset(cfg, seq, 4, seed=seed).batch_at(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it = make_batch_iterator(cfg, InputShape("t", seq, 4, "train"), seed=3,
                             start_step=7, device=CPU)
    first = next(it)
    want = JSyntheticLMDataset(jcfg, seq, 4, seed=3).batch_at(7)
    assert first["tokens"].dtype == torch.int64
    for k in want:
        np.testing.assert_array_equal(first[k].numpy(), want[k])
    np.testing.assert_array_equal(
        next(it)["tokens"].numpy(),
        JSyntheticLMDataset(jcfg, seq, 4, seed=3).batch_at(8)["tokens"])


def _mixed_tree(rng):
    """A {"params", "opt"} tree as the trainer saves it: bf16 params,
    f32 moments, an int32 count, as numpy (ml_dtypes bf16)."""
    bf = lambda *s: rng.standard_normal(s).astype(ml_dtypes.bfloat16)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"embed": bf(16, 8), "body": {"b0": {"w": bf(2, 8, 8)},
                                           "norm": bf(8)}}
    mu = _np_map(lambda a: f32(*a.shape), params)
    nu = _np_map(lambda a: np.abs(f32(*a.shape)), params)
    return params, mu, nu


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    params, mu, nu = _mixed_tree(np.random.default_rng(2))
    jp = _np_map(jnp.asarray, params)
    jopt = jadamw.OptState(_np_map(jnp.asarray, mu), _np_map(jnp.asarray, nu),
                           jnp.asarray(5, jnp.int32))
    jsave_tree({"params": jp, "opt": jopt}, tmp_path / "ck")
    ocfg = OptimizerConfig(moment_dtype="float32")
    abs_params = _np_map(lambda a: torch.empty(
        a.shape, dtype=torch.bfloat16, device="meta"), params)
    back = restore_tree(tmp_path / "ck", {
        "params": abs_params,
        "opt": adamw.abstract_opt_state(abs_params, ocfg)}, device=CPU)
    for want, got in zip(_leaves(params), _leaves(back["params"])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy()
                                      .view(np.uint16), _bits(want))
    for want, got in zip(_leaves(mu) + _leaves(nu),
                         _leaves(back["opt"].mu) + _leaves(back["opt"].nu)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert back["opt"].count.dtype == torch.int32
    assert int(back["opt"].count) == 5


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    params, mu, nu = _mixed_tree(np.random.default_rng(3))
    to_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) if a.dtype == ml_dtypes.bfloat16 \
        else torch.from_numpy(a)
    opt = adamw.OptState(_np_map(to_t, mu), _np_map(to_t, nu),
                         torch.tensor(9, dtype=torch.int32))
    save_tree({"params": _np_map(to_t, params), "opt": opt}, tmp_path / "ck")
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    keys = [e["key"] for e in manifest["keys"]]
    assert keys == sorted(keys) and "opt/.count" in keys \
        and "opt/.mu/body/b0/w" in keys and "params/embed" in keys
    sds = lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype)
    abs_params = _np_map(sds, params)
    back = jrestore_tree(tmp_path / "ck", {
        "params": abs_params,
        "opt": jadamw.abstract_opt_state(abs_params, JOptimizerConfig())})
    for want, got in zip(_leaves(params), jax.tree.leaves(back["params"])):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    for want, got in zip(_leaves(mu) + _leaves(nu),
                         jax.tree.leaves(back["opt"].mu)
                         + jax.tree.leaves(back["opt"].nu)):
        np.testing.assert_array_equal(np.asarray(got), want)
    assert int(back["opt"].count) == 9


@pytest.mark.parametrize("cli,argv", [
    (train_cli, ["--arch", "gemma2-9b", "--smoke", "--steps", "3",
                 "--seq-len", "32", "--batch", "4"]),
    (train_lm, ["--preset", "small", "--steps", "2", "--seq-len", "32",
                "--batch", "2"]),
])
def test_training_clis_on_the_host(cli, argv, tmp_path, capsys):
    """The launchers run on the host with ``--device cpu``, print the
    reference's lines, and leave a resumable checkpoint; without it they
    ask for the card and raise here."""
    argv = argv + ["--ckpt-dir", str(tmp_path / "ck")]
    assert cli.main(argv + ["--device", CPU]) == 0
    out = capsys.readouterr().out
    if cli is train_cli:
        assert "mesh={'data': 1, 'model': 1}" in out
        assert "done at step 3" in out
    else:
        assert "loss: first=" in out
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
