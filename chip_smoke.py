#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the hand-written kernels (``src/repro_torch/kernels/csrc``) with
   ``nvcc`` for sm_90a, print the seconds and the ptxas report, hold the
   ``matmul_tiled``, ``flash_attention`` (and its backward), ``dg_diff``,
   ``stream_strided``, ``slstm_cell`` and ``mamba2_ssd`` kernels (the
   SSD's passes) and both recurrent backward kernels to no register
   spills (``NO_SPILLS``), fail if ptxas serialized any ``wgmma`` of the
   attention backward's wgmma path,
   and hold the SASS (``cuobjdump -sass``) of
   ``madd_throughput``'s chain loop to 8 FFMAs per step, so the compiler
   folded nothing;
2. hold every kernel against its plain PyTorch version on the card, at
   the reference test shapes (``tests/test_kernels.py`` tolerances) and
   at the main path's sizes, with TF32 off (float32 kernels against the
   plain version evaluated in float64); the model-layer kernels
   (``flash_attention``, ``mamba2_ssd``, ``slstm_cell``) also at the
   widths of the port's gemma2-9b, zamba2-7b and xlstm-125m configs, and
   each beside plain variants that drop one point of its semantics
   (softcap, window, GQA head map, carried state, recurrence) or carry
   the fault its design invites (the SSD's state one chunk late, the
   sLSTM's peers' h one step stale), which must fail the same check;
   attention logs the kv tiles it visits per layer against a full sweep;
   ``dg_diff`` also at the DG node counts N = 10, 20, 35, 56 (M = 3,
   K = 8192), which the kernel runs at its next instantiated width, each
   against its plain version, and N = 56 timed beside N = 64 at K = 8192
   and at the main path's K: one ``{"dg_diff_node_counts": ...}`` line;
3. calibrate the default battery on the card through
   ``python -m repro_torch.calibrate`` (3 trials, one CUDA-graph replay
   per timing) into a temporary profile;
4. predict the three §8 kernels from the reloaded profile — CLI
   ``predict`` at the reference target shapes, ``PerfSession`` at the
   real sizes — with zero timings;
5. time each of them at the real sizes (CUDA events) and print the base
   model's prediction against the measurement;
6. the model-zoo study: ``python -m repro_torch.calibrate --zoo`` on the
   card (the reference's ``STUDY_TAGS``, 18 kernels, 3 trials) and on the
   synthetic device ``apex``, then ``compare --sweep`` of the two;
7. predict all five kernels at real size from the card's zoo profile
   with each rung (zero timings), time them beside their plain versions,
   one library call and their bounds, and print predicted ÷ measured per
   kernel per rung;
8. the model-layer kernels: CLI ``predict`` at the reference target
   shapes from phase 3's profile, ``PerfSession`` at the real sizes under
   the base fit and each zoo rung (zero timings, the unmodeled features
   printed), then each kernel timed beside its plain version and its
   bound, attention also beside ``torch.compile``'d ``flex_attention``;
9. time ``dg_diff`` and ``stream_strided`` (stride 1 and 4) in turns
   with their library call (:func:`time_in_turns`: 5 rounds of kernel,
   library, library, kernel) and log the median ratio, three lines; time
   ``slstm_cell``'s step-latency floor (the same kernel at B = 1, H = 1,
   dh = 4, S as the real size: S × (gating, exchange of h)) and each of
   ``mamba2_ssd``'s three passes once at the real size, and log both
   kernels' time as a share of their bound (the sLSTM's also of its
   floor, the SSD's of its bytes' time) with the sLSTM's cluster plan;
   log
   ``matmul_tiled``'s, ``flash_attention``'s, ``dg_diff``'s and
   ``stream_strided``'s time ÷ their library call's, their TFLOP/s on
   the needed work and their share of the bound; print one
   ``{"kernels": [...]}`` line (all eight kernels; ``ms`` and
   ``library_ms`` are phase 7's and 8's :func:`time_ms`; the in-turns
   median rides along as ``in_turns_ratio``, the sLSTM's floor as
   ``step_floor_ms``, the SSD's passes as ``pass_ms``), the card's name
   and power limit, and the ``{"ok": true, "device": ...}`` line last;
10. (before that ``kernels`` line) the paper's own evaluation from
   :mod:`repro_torch.studies.paper_figures`: Figs 1, 2 and 5 calibrate
   and predict, Figs 7–9 and Table 3 read phase 3's profile (3 trials,
   TF32 off); every CSV row printed, each figure's seconds, gmre and
   top-1 rank logged, one ``{"figures": ...}`` line; a figure that times
   another number of kernels than the reference's tags select, times one
   twice, or measures a time that is not finite and positive fails; then
   the longest loop of each loop generator (``sync_loop_pattern``,
   ``overlap_pattern``, ``onchip_pattern``): eager call, capture and
   replay, each per step (:func:`loop_costs`);
11. (after phase 10, before that ``kernels`` line) the measurement cache,
   the count engine and retiming (:func:`amortization_path`): the base
   battery (3 trials) into a fresh ``--cache-dir``, cold then warm —
   the warm run must perform 0 timings and 0 counting passes and write a
   byte-identical profile; host seconds to count the base battery and
   the seven figures' kernels per shape (``count_fn``), through the
   engine cold and warm, every count equal; the zoo study with
   ``--retime-rel-std 0.05`` (re-timed rows, held-out gmre per rung
   beside phase 6's); and ``PerfSession(cache=...)`` pricing all eight
   hand kernels at phases 7–8's real sizes twice (the second pass, and a
   second session over the same cache, count nothing).  One
   ``{"amortization": ...}`` line.
12. (after phase 11, before that ``kernels`` line) predictor-guided
   autotuning and the static audit: (a) :func:`tuning_path` — the three
   §8 spaces (``dg_diff`` K 32768, the stencil at 4096², ``matmul_sq``
   n 768) priced by phase 3's ``base`` fit and confirmed with the card's
   graph timer: a cold ``python -m repro_torch.tune search --save``
   (margin 0, at most 3 of 11 variants timed), a warm re-tune of the
   saved profile that must time nothing, count nothing and evaluate
   nothing, :mod:`repro_torch.studies.autotune`'s pruned search against
   the exhaustive baseline over the 14 lattice points, and the synthetic
   ``citra`` search with ``--verify-optimum``; one ``{"tuning": ...}``
   line (a pruned winner other than the exhaustive one is logged as a
   finding, not a failure); (b) :func:`audit_path` — ``PerfSession.audit``
   of phase 11's ten hand-kernel items on fake ``cuda`` tensors,
   ``predict --audit`` of the eight targets and
   ``python -m repro_torch.lint --kernels`` against
   ``torch_lint_baseline.json``; one ``{"audit": ...}`` line with the
   codes found per target.
13. (after phase 12, before that ``kernels`` line) serving and fleet
   routing (:func:`serving_path`): (a) ``python -m repro_torch.serve
   --smoke --burst 64 --expect-zero-timings`` on phase 3's profile with
   a four-machine fleet (phase 6's card and ``apex`` zoo profiles, exact
   ``bulk`` and ``citra``): every reply 200, 0 timings, at most 8 count
   lookups, fewer batched evaluations than requests, the burst in one
   batch, routes over 4 machines, no load left; (b) a ``FleetRouter``
   over the same four routes phase 11's ten items and completes each one
   placed on the card with the card's time from phases 7–8, logging the
   price tables and the card's health (skew, weight, flag) without
   gating on them; routing times nothing; (c) ``recalibrate`` re-studies
   the card (``STUDY_TAGS``, 3 trials, no cache) — the fresh fingerprint
   must be the slot's, its health cleared, the routing sessions' timers
   at 0 — and logs the fresh held-out gmre per rung beside phase 6's;
   (d) ``python -m repro_torch.fleet simulate`` and ``health
   --recalibrate`` must exit 0, then ``studies.serve_bench`` (synthetic
   and phase 3's profile) and ``studies.fleet_bench``; one
   ``{"serving": ...}`` line.
14. (after phase 13, before that ``kernels`` line) work removal and the
   host benches (:func:`workremoval_path`): the battery kernel
   ``matmul_sq`` (n 1024, f32, prefetch, tile 64) stripped of its first
   operand by :func:`repro_torch.core.workremoval.remove_work` must
   return Σb on the card and count 0 madds and only b's loads; it is
   timed as a CUDA graph beside the unstripped kernel
   (``MeasurementKernel.time_stats``); then ``python -m
   repro_torch.studies.run calibration study predict counting`` runs in
   process (host seconds; no ``.FAILED`` row, the batched fit within
   1e-4 of the row-by-row reference).  One ``{"workremoval": ...}`` and
   one ``{"benches": ...}`` line.

15. (after phase 14, before that ``kernels`` line) the port's language
   models served on the card (:func:`lm_path`): gemma2-9b at its full
   published size (batch 2, a prompt of 4608 past the local layers'
   4096 window, so they prefill into and decode from their ring
   buffers), xlstm-125m (prompt 4096) and zamba2-7b at full width cut to
   9 layers (prompt 4608), each through ``python -m
   repro_torch.launch.serve`` in process, 16 tokens: prefill and decode
   ms between CUDA events after a warm-up, tokens per second, peak
   memory, and each hand kernel's launches in prefill (exactly
   ``LM_PREFILL_LAUNCHES``) and decode (none); each kernel's first call
   (attention's first with a window and first without) on the model's
   own inputs, and the SSD's and sLSTM's final states, against their
   plain versions in float64; the whole model at full width and the
   smallest depth with every block kind (gemma2's window cut below the
   prompt), f32, card against host, and the card's prefill-then-decode
   against its forward.  One ``{"lm": ...}``
   line.  Memory is freed between models.
16. (after phase 15, before that ``kernels`` line) training on the
   card: (a) the attention backward kernel (``csrc/flash_attention_bwd
   .cu``, through ``ops.flash_attention`` under autograd) against the
   plain version's autograd in float64 at ``ATTN_BWD_CASES`` (gemma2-9b's
   global and local layers at seq 4096, a window of 128, yi-6b's G = 8,
   Dk 192 / Dv 128 non-causal with Sq ≠ Skv, head dims 100 / 60 on the
   bf16 mma.sync route, the rest on its wgmma route), f32 and bf16, each
   run twice bit for bit, then timed at gemma2-9b's global layer, each
   pass's kernel from a ``torch.profiler`` trace of full calls, beside
   the forward with lse, the plain vjp,
   ``torch.compile``'d ``flex_attention`` forward alone and forward +
   backward, its bound and its TFLOP/s
   (:func:`check_attention_backward`); (b) gemma2-9b at full width
   (8 layers, seq 4096, batch 4 in 4 microbatches, bf16, remat full)
   trained 6 steps through ``Trainer.train``: per step s, tokens/s,
   loss (falling), grad_norm, lr, share of the bound, and peak memory,
   the counters set to 0 before and read after, exactly 64 forward and 32
   backward attention launches a step (:func:`train_path`); (c) the
   failure injected after step 5 at the smoke width, restored from step
   4 and replayed, bit for bit against an uninterrupted run
   (:func:`fault_tolerance_path`); (d) one train step of the whole model
   at full width, f32, card against host (:func:`whole_train_check`).
   One ``{"train": ...}`` line; the ``kernels`` line gains the
   backward's row.
17. (after phase 16, before that ``kernels`` line) training the
   recurrent models on the card: (a) the SSD and sLSTM backward kernels
   (``csrc/mamba2_ssd_bwd.cu``, ``csrc/slstm_cell_bwd.cu``, through
   ``ops.mamba2_ssd`` and ``ops.slstm_cell`` under autograd) against the
   plain versions' autograd in float64 at ``SSD_BWD_CASES`` (zamba2-7b's
   layer, P = N of 16 and 32, chunk 32, a strong decay, B 2, P 20 / N 12
   at chunk 48; each on its ``SSD_BWD_ROUTES`` route, zamba2-7b's twice
   bit for bit) and
   ``SLSTM_BWD_CASES`` (xlstm-125m's layer, dh 256, dh 4, the n floor
   biting; xlstm-125m's twice bit for bit), every gradient within 1e-4 ×
   its max |g|, with plain
   variants (the SSD without its carried state gradient or with it one
   chunk late, the sLSTM without its recurrent dh) that must fail; then
   both at the model's layer timed beside the forward (the sLSTM's with
   and without its trajectory), the plain vjp and the bound, the SSD's
   two chained-scan passes each from a profiler trace
   (:func:`ssd_bwd_pass_ms`) beside its design's floors
   (:func:`ssd_bwd_floors_ms`), the sLSTM's three gradients beside dg_in
   alone and its step-latency floor beside the forward's
   (:func:`check_recurrent_backward`); (b)
   zamba2-7b at full width (9
   layers) and xlstm-125m as published trained 4 steps each through
   ``Trainer.train`` (seq 4096, batch 8, bf16, remat full): per step s,
   tokens/s, loss (falling), share of the bound, peak memory, and
   exactly ``RECURRENT_STEP_LAUNCHES`` a step, the SSD backward's
   calls each on its ``RECURRENT_STEP_SSD_ROUTES`` route
   (:func:`train_path`); (c)
   one step of each at full width, f32, the smallest depth with every
   block kind, card against host (:func:`recurrent_whole_check`).  One
   ``{"train_recurrent": ...}`` line; the ``kernels`` line gains the two
   backward kernels' rows.
18. (after phase 17, before that ``kernels`` line) the mesh: (a)
   phase 16 (b)'s gemma2-9b run for ``MESH_STEPS`` steps without a mesh
   and under ``make_host_mesh()``'s 1 × 1 mesh on a one-rank NCCL group
   (parameters and moments DTensors), the counters set to 0 before each
   and read after: exactly ``TRAIN_STEP_LAUNCHES`` a step in both, every
   loss within ``MESH_LOSS_REL``, the step times side by side
   (:func:`mesh_train_path`); (b) at the smoke width, a failure restored
   under the mesh's placements and replayed, and a mesh-less state
   ``reshard``ed onto the mesh bit for bit, training on
   (:func:`mesh_checkpoint_path`); (c) deepseek-v2-236b's MoE layer at
   full width through ``moe_impl="a2a"``'s all-to-all dispatch on the
   mesh against the scatter, within ``MOE_REL`` × max |y|, nothing
   dropped (:func:`moe_a2a_path`); (d) the ``DRYRUN_CELLS`` dry-runs,
   each in its own process started before (b) and collected after (c),
   each ``status: ok``.  One ``{"mesh": ...}`` line.

Phase 3 also prints its 43-row feature table as one
``{"base_feature_table": ...}`` line.

Launch counters are set to 0 before phase 3 and read after phase 5 (the
three §8 kernels must have launched), set to 0 again before phase 6 and
read after phase 7 (the five kernels of the zoo study), and again before
phase 8 and read after it (the three model-layer kernels), logged
around phase 10 (the figures run aten ops, no hand kernel), and set to 0
before phase 11 and read after it, which fails if pricing launched any;
logged around phase 12's tuning (aten generators, no hand kernel) and
set to 0 before its audit and read after it, which fails if the audit
launched any; set to 0 before phase 13 and read after it, which fails
if serving, routing or the card's recalibration (aten generators)
launched any; and set to 0 before phase 14 and read after it, which
fails if work removal or the benches launched any; and set to 0
before each served model of phase 15 and read after it, which fails
unless every kernel launched exactly twice a prefill's count (warm-up
and timed request); and set to 0 before phase 16 (b)'s steps and read
after them, which fails unless the attention kernels launched exactly
``TRAIN_STEP_LAUNCHES`` a step; and set to 0 before each of phase 17
(b)'s runs and read after it, which fails unless every model-layer
kernel, forward and backward, launched exactly
``RECURRENT_STEP_LAUNCHES`` a step.  Without a
card (or without the repository beside this file) it exits non-zero and
prints no result.
"""
from __future__ import annotations

import ast
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# reference test shapes (tests/test_kernels.py) and tolerances
TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MATMUL_SHAPES = [(128, 128, 128, 128, 128, 128),
                 (256, 128, 512, 128, 128, 64),
                 (512, 512, 256, 256, 128, 256)]
STENCIL_SHAPES = [(256, 256, 128, 128), (256, 512, 256, 256),
                  (128, 128, 64, 128)]
DG_SHAPES = [(3, 64, 1024, 256), (1, 32, 512, 512)]
# the DG node counts of tetrahedra of order 2-5 (paper §8.4), which the
# kernel runs at its next instantiated width; M = 3, K = 8192
DG_NODE_COUNTS = (10, 20, 35, 56)
DG_NODE_SHAPE = (3, 8192)

STREAM_SHAPES = [(8192, 256, stride, n_arrays) for stride in (1, 2, 4)
                 for n_arrays in (1, 3)] + [
    # more inputs than one launch sums (8): groups of launches
    (8192, 256, 1, 9), (8192, 256, 2, 17)]
MADD_SHAPE = (4096, 32, 1024)       # S, iters, block

# main-path sizes: each larger than the 50 MB L2
REAL_MATMUL = (4096, 4096, 4096)
REAL_STENCIL = (8192, 8192)
REAL_DG = (3, 64, 262144)
REAL_STREAM = (2 ** 26, 2, 512)     # S, n_arrays, block; strides 1 and 4
REAL_STREAM_STRIDES = (1, 4)
REAL_MADD = (2 ** 24, 256, 2048)    # S, iters, block
# f32 sums of 4096 products (elements ~64): the kernel's rounding alone
# reaches ~2e-4 absolute, above the reference's atol of 2e-5
REAL_MATMUL_TOL = dict(rtol=2e-4, atol=1e-3)
# 8 chains of 256 f32 steps: f32 cannot add b = 1e-7 to y ≈ 8 (half an
# ulp is 4.8e-7), so each output drops up to 8·256·b ≈ 2e-4 that the
# float64 plain version keeps, and each chain's 256 roundings add a few
# 1e-4 more — above the reference's atol of 2e-5 near zero outputs
REAL_MADD_TOL = dict(rtol=2e-4, atol=2e-3)
# the reference's a and b move each output by ~2e-4 of itself over 256
# steps, inside that tolerance: a kernel running half the chain, or none
# of it, would pass.  With these each step is visible (a^256 ≈ 0.77 and
# the chains head for b / (1 - a) = 10), while f32 rounding stays far
# inside the reference tolerance
MADD_VISIBLE = dict(a=0.999, b=0.01)
ZOO = ("lin_flop", "lin_flop_mem", "ovl_flop_mem")

# H100 SXM dense bf16 and TF32 tensor-core peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
# q scaled so the scores reach tens: with unit inputs softcap 50 moves a
# score by ~1e-4 of itself and a kernel ignoring it would pass
ATTN_Q_SCALE = 8.0
# real sizes: the widths of the port's configs, sequence and batch cut
# for time (the plain sLSTM loops in Python over every step: S = 4096 of
# prefill_32k's 32768)
REAL_ATTN_S = 8192      # gemma2-9b, batch 1
REAL_SSD_S = 8192       # zamba2-7b, batch 1
REAL_SLSTM = (8, 4096)  # xlstm-125m, batch 8, S
# the real-size SSD: the chunked form takes exp(la_i − la_j) from a
# 256-long f32 cumsum where the plain version multiplies exp(da) step by
# step, and y reaches ~150: the reference's own Pallas kernel at chunk
# 256 (S = 1024, interpret mode) misses atol 2e-5 on 4e-5 of its outputs,
# by up to 1.4e-4
REAL_SSD_TOL = dict(rtol=2e-4, atol=1e-3)
# bf16 attention at q × 8 (the check that carries the variants):
# against the plain version in bf16, the reference's bf16 tolerance
REAL_ATTN_TOL = TOL["bfloat16"]
# bf16 attention at q × 1 against the plain version in f32 from the same
# bf16 inputs.  Past the first few hundred rows the softmax spreads over
# thousands of keys and |o| is ~0.02, so the element-wise bf16 atol of
# 2e-2 alone would pass a kernel off by tens of percent there.  Each
# output row (one query, one head: 256 values) is also held to a
# relative L2 error of 1e-2, where the bf16 rounding of the output alone
# is ~2e-3.  An element-wise 1e-2 / 1e-3 is not usable: in rows that
# attend to a few keys the values cancel, and the rounding of p to bf16
# before P·V (as the reference kernel rounds it) leaves elements 1.8×
# over it
REAL_ATTN_F32_TOL = dict(TOL["bfloat16"], row_rtol=1e-2)

# phase 16 (a): the attention backward kernel against the plain
# version's autograd in float64 — (label, B, Sq, Skv, Hq, Hkv, D, Dv,
# causal, window, softcap, q scale): gemma2-9b's global and local layers
# at train_4k's 4096 (the local window, 4096, does not bite there), the
# same with a biting window of 128, yi-6b's G = 8 at D = 128,
# deepseek-v2's Dk 192 / Dv 128 non-causal with Sq ≠ Skv, ragged against
# the tiles, and head dims of 100 / 60, which no TMA tensor map describes
# (rows not a multiple of 16 bytes): the bf16 backward's mma.sync route
# (every other case takes its wgmma route; ATTN_BWD_ROUTES)
ATTN_BWD_CASES = (
    ("gemma2-9b global", 1, 4096, 4096, 16, 8, 256, 256, True, None, 50.0,
     ATTN_Q_SCALE),
    ("gemma2-9b local", 1, 4096, 4096, 16, 8, 256, 256, True, 4096, 50.0,
     ATTN_Q_SCALE),
    ("window 128", 1, 4096, 4096, 16, 8, 256, 256, True, 128, 50.0,
     ATTN_Q_SCALE),
    ("yi-6b G=8", 1, 4096, 4096, 32, 4, 128, 128, True, None, None, 1.0),
    ("Dk 192 / Dv 128 cross", 2, 1000, 1544, 16, 16, 192, 128, False, None,
     None, 1.0),
    ("Dk 100 / Dv 60", 1, 1000, 1000, 8, 2, 100, 60, True, 300, 30.0,
     ATTN_Q_SCALE),
)
#: the route each case's bf16 backward takes (the kernel's own count)
ATTN_BWD_ROUTES = ("wgmma",) * 5 + ("mma_sync",)
#: the bf16 backward's passes on its wgmma route by their kernel's name
#: (``bwd_wg_query_kernel<MODE, NS>``: MODE 0 is Δ, 1 dQ)
ATTN_BWD_PASS_KERNELS = (("delta", "bwd_wg_query_kernel<0"),
                         ("dq", "bwd_wg_query_kernel<1"),
                         ("dkv", "bwd_wg_key_kernel"))
# f32: each of dq, dk, dv within 1e-4 × its max |g| of the float64 vjp;
# bf16: P and dS are rounded to bf16 before their products, as the
# forward rounds P, so each element is held within 1e-2 of itself plus
# 2e-2 × its row's rms (phase 15's form) plus 1e-4 × max |g| (the f32
# tolerance): a causal dq's first row is exactly 0 (one visible key, so
# dS = P·(dP − Δ) = 0), and in rows that attend to one or two keys dq
# nearly cancels, so no rounding passes a test relative to the row alone
ATTN_BWD_F32_REL = 1e-4
ATTN_BWD_BF16_TOL = dict(rtol=1e-2, row_atol=2e-2, floor=1e-4)

# phase 16 (b): gemma2-9b at full width trained on the card — depth cut to
# 8 of its 42 layers (4 local + 4 global), train_4k's seq 4096, global
# batch 4 of its 256 in the preset's 4 microbatches, bf16 params, f32
# moments, remat "full", 6 AdamW steps (lr 1e-3, warmup 1) on the
# synthetic stream,
# checkpointing off (one checkpoint of this state is ~25 GB of .npy)
TRAIN_ARCH = "gemma2-9b"
TRAIN_LAYERS = 8
TRAIN_SEQ = 4096
TRAIN_BATCH = 4
TRAIN_STEPS = 6
# hand-kernel launches of one step: each attention layer once per
# microbatch forward, once more in remat's recompute, once backward
TRAIN_STEP_LAUNCHES = {"flash_attention": TRAIN_LAYERS * 4 * 2,
                       "flash_attention_bwd": TRAIN_LAYERS * 4}
# (c) fault tolerance at the smoke width: seq 256, batch 4 in 2
# microbatches, a checkpoint every 2 steps, a failure injected after the
# fifth step (the trainer restores step 4 and replays), 8 steps
FT_SEQ, FT_BATCH, FT_STEPS, FT_FAIL_AT = 256, 4, 8, 4
# the losses must agree bit for bit, else within 1e-6 relative (logged,
# with the steps before the failure showing whether two runs differ at
# all without one)
FT_REL = 1e-6
# (d) one train step of the whole model (full width, f32, a local and a
# global layer, whole_model_config), card against host: loss within 1e-5
# relative, each gradient leaf within 2e-3 × its max |g|, the parameters
# after the AdamW step within 1e-5 × max |p| — plus 2·lr where a nonzero
# |g| is inside the gradient tolerance (2e-3 × max |g|): AdamW's first
# step is lr·g/(|g| + eps), about ±lr, and where two gradients agree only
# to the tolerance their signs may differ (at 1e-6 × max |g|, below the
# 6e-6 the card and host gradients agree to, elements flip and miss by
# 38×); and the card's AdamW against the host's from the same (the
# card's) gradients within 1e-5 × max |p| everywhere
TRAIN_WHOLE_LOSS_REL = 1e-5
TRAIN_WHOLE_GRAD_REL = 2e-3
TRAIN_WHOLE_PARAM_REL = 1e-5

# phase 18: the mesh.  (a) phase 16 (b)'s gemma2-9b run (TRAIN_*) for
# MESH_STEPS steps without a mesh, then under make_host_mesh()'s 1 × 1
# mesh (a one-rank NCCL group; parameters and moments DTensors): losses
# within MESH_LOSS_REL, TRAIN_STEP_LAUNCHES a step in each
MESH_STEPS = 3
MESH_LOSS_REL = 1e-5
# (c) deepseek-v2-236b's MoE layer at full width (d_model 5120, 160
# routed experts of d_ff 1536 + 2 shared, top-6), f32, on 2 × 2048 tokens
# at the drop-free capacity factor 8: the experts are 15.1 GB; the
# all-to-all path on one rank holds its send and receive buffers (196608
# rows of 5120, 4.0 GB each), the local expert buffers (160 × 2464 rows:
# 8.1 GB in, 8.1 GB out, 2.4 GB each hidden product) and the way back
# (4.0 GB × 3), ~47 GB at most beside the weights, under 80 GB
MOE_ARCH = "deepseek-v2-236b"
MOE_TOKENS = (2, 2048)
MOE_CAPACITY = 8.0
MOE_REL = 1e-4
# (d) the dry-run cells, each in its own process (the fake group is per
# process), started before (b) and collected after (c)
DRYRUN_CELLS = (("gemma2-9b", "train_4k", "single"),
                ("xlstm-125m", "train_4k", "pod2"))
DRYRUN_TIMEOUT_S = 600
#: the kernels' custom ops each cell's FLOP count must hold (counted at
#: the global shapes, ``launch/dryrun.py``)
DRYRUN_KERNEL_OPS = {
    "gemma2-9b": ("repro_torch.flash_attention",
                  "repro_torch.flash_attention_bwd"),
    "xlstm-125m": ("repro_torch.slstm_cell_traj",
                   "repro_torch.slstm_cell_bwd")}

# phase 17 (a): the SSD and sLSTM backward kernels (through ops under
# autograd) against the plain versions' autograd in float64, each
# gradient within ATTN_BWD_F32_REL × its max |g|.  SSD (label, B, S, H,
# P, N, chunk, decay shift: dt·A = −(shift + 0.1·|randn|)): zamba2-7b's
# layer at train_4k's 4096, P and N of 16 and 32, a chunk of 32 (the
# kernel's own chunk below 64), a strong decay (dt·A ≈ −5: exp(la_i −
# la_j) underflows inside a chunk), B 2.  sLSTM (label, B, S, H, dh, n
# floor): xlstm-125m's layer (6-block clusters, 2 batch rows a cluster),
# dh 256 (8-block clusters), dh 4, and half the input gates 30 below the
# rest, where n stays under its 1e-6 floor
SSD_BWD_CASES = (("zamba2-7b", 1, 4096, 112, 64, 64, 256, 0.0),
                 ("P = N = 16", 1, 1024, 8, 16, 16, 256, 0.0),
                 ("P = N = 32", 1, 1024, 8, 32, 32, 128, 0.0),
                 ("chunk 32", 1, 1024, 8, 64, 64, 32, 0.0),
                 ("strong decay", 1, 1024, 8, 64, 64, 256, 5.0),
                 ("B 2", 2, 1024, 8, 64, 64, 256, 0.0),
                 ("P 20 / N 12, chunk 48", 1, 960, 8, 20, 12, 48, 0.0))
# each case's SSD backward route (``mamba2_ssd.bwd_route``): the chained
# scans where the kernel's chunk is 64 and P, N are multiples of 8, else
# the five passes
SSD_BWD_ROUTES = ("chain", "chain", "chain", "passes", "chain", "chain",
                  "passes")
# the chained-scan route's kernels, by pass, as a profiler names them
SSD_BWD_PASS_KERNELS = (("F", "ssd_chain_state_kernel"),
                        ("R", "ssd_chain_grad_kernel"))
SLSTM_BWD_CASES = (("xlstm-125m", 8, 4096, 4, 192, False),
                   ("dh 256", 2, 512, 4, 256, False),
                   ("dh 4", 2, 512, 2, 4, False),
                   ("n floor", 2, 512, 2, 64, True))
# (b): zamba2-7b at full width cut to phase 15's 9 layers (3 prefix
# Mamba-2 blocks, one group of 6 and the shared attention, 1.137 B
# params) and xlstm-125m as published (12 layers, 6 sLSTM blocks), each
# at train_4k's seq 4096, global batch 8 in its preset's microbatches (8
# and 1), bf16 params, f32 moments, remat "full", 4 AdamW steps
RECURRENT_TRAIN = (("zamba2-7b", 9), ("xlstm-125m", None))
RECURRENT_BATCH = 8
RECURRENT_STEPS = 4
# hand-kernel launches of one step: remat runs each group's forward
# twice (the prefix blocks, outside it, once) and its backward once;
# zamba2: 3 + 6·2 SSD forwards, 9 backwards, the shared attention 2 + 1,
# per each of 8 microbatches; xlstm: 6·2 sLSTM forwards, 6 backwards
RECURRENT_STEP_LAUNCHES = {
    "zamba2-7b": {"mamba2_ssd": (3 + 6 * 2) * 8, "mamba2_ssd_bwd": 9 * 8,
                  "flash_attention": 2 * 8, "flash_attention_bwd": 8,
                  "slstm_cell": 0, "slstm_cell_bwd": 0},
    "xlstm-125m": {"slstm_cell": 6 * 2, "slstm_cell_bwd": 6,
                   "mamba2_ssd": 0, "mamba2_ssd_bwd": 0,
                   "flash_attention": 0, "flash_attention_bwd": 0},
}
# and the routes the SSD backward's calls take a step: zamba2-7b's layer
# (chunk 256 → 64, P = N = 64) only the chained scans
RECURRENT_STEP_SSD_ROUTES = {
    "zamba2-7b": {"chain": 9 * 8, "passes": 0},
    "xlstm-125m": {"chain": 0, "passes": 0},
}

# phase 10: kernels each figure times (calibration + test), as the
# reference's tags select them (tests/test_torch_paper_figures.py)
FIGURE_KERNELS = {"fig1": 6, "fig2": 6, "fig5": 7, "fig7": 4, "fig8": 8,
                  "fig9": 4, "table3": 0}
FIGURE_TRIALS = 3

# phase 14: the stripped battery kernel (matmul_sq, prefetch, tile 64)
WR_N = 1024
WR_TRIALS = 20

# phase 15: the served language models — arch, depth (None: the
# published one), batch, prompt; 16 tokens each, greedy
LM_SERVED = (("gemma2-9b", None, 2, 4608),
             ("xlstm-125m", None, 2, 4096),
             ("zamba2-7b", 9, 2, 4608))
LM_TOKENS = 16
# hand-kernel launches of one prefill: every attention layer (zamba2's
# shared block once per group), every Mamba-2 block, every sLSTM block
LM_PREFILL_LAUNCHES = {
    "gemma2-9b": {"flash_attention": 42, "mamba2_ssd": 0, "slstm_cell": 0},
    "zamba2-7b": {"flash_attention": 1, "mamba2_ssd": 9, "slstm_cell": 0},
    "xlstm-125m": {"flash_attention": 0, "mamba2_ssd": 0, "slstm_cell": 6},
}
# the whole model, card (kernels) against host (plain versions): full
# width, f32, the smallest depth that keeps every block kind, a prompt
# of 256 and 4 decode steps, held to 2e-3 × max |logit| (the attention
# tolerance of tests/test_serving.py); then the card's prefill of S − 1
# tokens and decode of token S − 1 against its full forward at S − 1,
# within tests/test_serving.py's TOL
LM_WHOLE_PROMPT = 256
LM_WHOLE_DECODE = 4
LM_WHOLE_REL = 2e-3
LM_WHOLE_SOFTCAP = 2.0
# (b) a served model's bf16 attention against the plain version in
# float64, not rounded back: a few bf16 ulps of each output and of its
# row's rms (chip_smoke.attention_excess)
LM_ATTN_BF16_TOL = dict(rtol=1e-2, row_atol=2e-2)
LM_SERVING_TOL = {"gemma2-9b": 2e-3, "zamba2-7b": 2e-2, "xlstm-125m": 5e-2}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def randn(rng, *shape):
    import torch
    return torch.from_numpy(rng.standard_normal(shape).astype("float32"))


def time_ms(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median device milliseconds of one call, CUDA events around each."""
    import numpy as np
    import torch
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return float(np.median(ts))


def time_in_turns(kernel, library, args, rounds: int = 5) -> dict:
    """Kernel ÷ library timed in turns: both warmed, then ``rounds``
    rounds of kernel, library, library, kernel, each a :func:`time_ms`
    median of 10; a round's ratio is its two kernel times over its two
    library times.  Returns the median ratio and each round's."""
    import numpy as np
    for fn in (kernel, library):
        time_ms(fn, *args)
    ratios = []
    for _ in range(rounds):
        k1, l1, l2, k2 = (time_ms(fn, *args)
                          for fn in (kernel, library, library, kernel))
        ratios.append((k1 + k2) / (l1 + l2))
    return {"median": float(np.median(ratios)), "rounds": ratios}


def excess(got, want, rtol, atol, row_rtol=None) -> float:
    """How far ``got`` lies from ``want``, in units of the tolerance: the
    worst element under |got − want| <= atol + rtol·|want| and, with
    ``row_rtol``, the worst row (last axis) under ||got − want|| <=
    row_rtol·||want||.  At most 1 passes; NaN fails."""
    import torch
    got, want = got.double(), want.double()
    worst = ((got - want).abs() / (atol + rtol * want.abs())).max()
    if row_rtol is not None:
        rows = (got - want).norm(dim=-1) / (row_rtol * want.norm(dim=-1))
        worst = torch.maximum(worst, rows.max())
    return float(worst)


def verify(kernel, plain, args, wrongs=(), **tol) -> float:
    """Assert the kernel's result is within the tolerance of the plain
    version's on the same inputs (:func:`excess`), then hold every plain
    variant in ``wrongs`` ((label, fn) pairs) to failing that check;
    return the kernel's max absolute error.  Float32 kernels are held
    against the plain version evaluated on float64 copies, so the error
    measured is the kernel's own and not the difference of two f32
    summation orders; bf16 against the plain version in the dtype
    ``plain`` computes in."""
    import torch
    got = kernel(*args)
    if got.dtype == torch.float32:
        args = tuple(x.double() for x in args)
    want = plain(*args)
    err = float((got.double() - want.double()).abs().max())
    worst = excess(got, want, **tol)
    if not worst <= 1:
        raise SystemExit(f"kernel disagrees with its plain version: max "
                         f"|err| {err:.3g}, {worst:.3g}× the tolerance "
                         f"({tol})")
    log(f"  kernel within the tolerance (worst {worst:.3g}× it)")
    for label, wrong in wrongs:
        over = excess(got, wrong(*args), **tol)
        if over <= 1:
            raise SystemExit(f"the check cannot fail: the plain variant "
                             f"'{label}' passes it too")
        log(f"  variant '{label}' fails the check (worst {over:.3g}× the "
            f"tolerance)")
    return err


def check_madd_rejects_short_chains(ref, x, iters) -> None:
    """The visible-step madd check must reject a kernel that runs half
    the chain or none of it: the plain version with ``iters // 2`` and 0
    steps has to fall outside the float32 tolerance on every element."""
    x = x.double()
    want = ref.madd_ref(x, iters=iters, **MADD_VISIBLE)
    room = TOL["float32"]["atol"] + TOL["float32"]["rtol"] * want.abs()
    for short in (iters // 2, 0):
        excess = (ref.madd_ref(x, iters=short, **MADD_VISIBLE)
                  - want).abs() / room
        inside = int((excess <= 1).sum())
        if inside:
            raise SystemExit(f"madd check: a kernel of {short} of {iters} "
                             f"steps would pass on {inside} elements")
        log(f"madd check: a kernel of {short} of {iters} steps fails on "
            f"every element, by at least {float(excess.min()):.3g}× the "
            f"tolerance")


def check_kernels(ops, ref, dev) -> dict:
    """Phase 2: every kernel against its plain version; returns the max
    absolute error at the main path's sizes per kernel."""
    import functools

    import numpy as np
    import torch
    rng = np.random.default_rng(7)
    for m, k, n, bm, bn, bk in MATMUL_SHAPES:
        for dt, tdt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
            a = randn(rng, m, k).to(dev, tdt)
            b = randn(rng, k, n).to(dev, tdt)
            mm = functools.partial(ops.matmul, block_m=bm, block_n=bn,
                                   block_k=bk)
            err = verify(mm, ref.matmul_ref, (a, b), **TOL[dt])
            log(f"matmul_tiled {dt} {(m, k, n)} blocks {(bm, bn, bk)}: "
                f"max|err| {err:.3g} (rtol {TOL[dt]['rtol']}, "
                f"atol {TOL[dt]['atol']})")
    for m, n, bm, bn in STENCIL_SHAPES:
        u = randn(rng, m, n).to(dev)
        st = functools.partial(ops.stencil5, block_m=bm, block_n=bn)
        err = verify(st, ref.stencil5_ref, (u,), **TOL["float32"])
        log(f"stencil5 {(m, n)} blocks {(bm, bn)}: max|err| {err:.3g}")
    for mm_, nn, kk, be in DG_SHAPES:
        d, ut = randn(rng, mm_, nn, nn).to(dev), randn(rng, nn, kk).to(dev)
        dg = functools.partial(ops.dg_diff, block_e=be)
        err = verify(dg, ref.dg_diff_ref, (d, ut), **TOL["float32"])
        log(f"dg_diff {(mm_, nn, kk)} block_e {be}: max|err| {err:.3g}")

    for size, block, stride, n_arrays in STREAM_SHAPES:
        arrs = [randn(rng, size).to(dev) for _ in range(n_arrays)]
        st = functools.partial(ops.stream_strided, block=block,
                               stride=stride)
        err = verify(lambda *a: st(list(a)),
                    lambda *a: ref.stream_ref(list(a), block=block,
                                              stride=stride),
                    tuple(arrs), **TOL["float32"])
        log(f"stream_strided S={size} n_arrays={n_arrays} block {block} "
            f"stride {stride}: max|err| {err:.3g}")
    size, iters, block = MADD_SHAPE
    x = randn(rng, size).to(dev)
    for kw in ({}, MADD_VISIBLE):
        err = verify(functools.partial(ops.madd_throughput, iters=iters,
                                      block=block, **kw),
                    functools.partial(ref.madd_ref, iters=iters, **kw),
                    (x,), **TOL["float32"])
        log(f"madd_throughput S={size} iters={iters} block {block} {kw}: "
            f"max|err| {err:.3g}")
    check_madd_rejects_short_chains(ref, x, iters)

    m, k, n = REAL_MATMUL
    mm_, nn, kk = REAL_DG
    size, n_arrays, block = REAL_STREAM
    stream_arrs = tuple(randn(rng, size).to(dev) for _ in range(n_arrays))
    madd_s, madd_iters, madd_block = REAL_MADD
    errs = {
        "matmul_tiled": verify(
            ops.matmul, ref.matmul_ref,
            (randn(rng, m, k).to(dev), randn(rng, k, n).to(dev)),
            **REAL_MATMUL_TOL),
        "stencil5": verify(ops.stencil5, ref.stencil5_ref,
                          (randn(rng, *REAL_STENCIL).to(dev),),
                          **TOL["float32"]),
        "dg_diff": verify(ops.dg_diff, ref.dg_diff_ref,
                         (randn(rng, mm_, nn, nn).to(dev),
                          randn(rng, nn, kk).to(dev)), **TOL["float32"]),
        "madd_throughput": verify(
            functools.partial(ops.madd_throughput, iters=madd_iters,
                              block=madd_block),
            functools.partial(ref.madd_ref, iters=madd_iters),
            (randn(rng, madd_s).to(dev),), **REAL_MADD_TOL),
    }
    madd_x = randn(rng, madd_s).to(dev)
    err = verify(functools.partial(ops.madd_throughput, iters=madd_iters,
                                  block=madd_block, **MADD_VISIBLE),
                functools.partial(ref.madd_ref, iters=madd_iters,
                                  **MADD_VISIBLE),
                (madd_x,), **TOL["float32"])
    log(f"madd_throughput S={madd_s} iters={madd_iters} {MADD_VISIBLE}: "
        f"max|err| {err:.3g} ({TOL['float32']})")
    check_madd_rejects_short_chains(ref, madd_x, madd_iters)
    errs["stream_strided"] = max(
        verify(lambda *a, s=stride: ops.stream_strided(list(a), block=block,
                                                      stride=s),
              lambda *a, s=stride: ref.stream_ref(list(a), block=block,
                                                  stride=s),
              stream_arrs, **TOL["float32"])
        for stride in REAL_STREAM_STRIDES)
    log(f"main-path sizes, max|err| vs plain: {errs} (matmul "
        f"{REAL_MATMUL_TOL}, madd_throughput {REAL_MADD_TOL}, others "
        f"{TOL['float32']})")
    return errs


def check_dg_node_counts(ops, ref, dev) -> dict:
    """``dg_diff`` at the DG node counts between its instantiated widths,
    each against its plain version (f32 tolerance); then N = 56 timed
    beside N = 64 with :func:`time_ms`, at M = 3 and K = 8192 and at the
    main path's K.  Returns each N's max |err| and the times, with the
    bound of each timed shape."""
    import numpy as np
    rng = np.random.default_rng(21)
    mm_, kk = DG_NODE_SHAPE
    out = {"max_abs_err": {}, "ms": {}, "bound_ms": {}}
    for nn in DG_NODE_COUNTS:
        d, ut = randn(rng, mm_, nn, nn).to(dev), randn(rng, nn, kk).to(dev)
        err = verify(ops.dg_diff, ref.dg_diff_ref, (d, ut), **TOL["float32"])
        out["max_abs_err"][nn] = err
        log(f"dg_diff at N = {nn} {(mm_, nn, kk)}: max|err| {err:.3g} "
            f"({TOL['float32']})")
    for k in (kk, REAL_DG[2]):
        for nn in (56, 64):
            d, ut = randn(rng, mm_, nn, nn).to(dev), \
                randn(rng, nn, k).to(dev)
            ms = time_ms(ops.dg_diff, d, ut)
            bound = max(2 * mm_ * nn * nn * k / PEAK_F32_FLOPS,
                        4 * (mm_ * nn * nn + nn * k + mm_ * nn * k)
                        / PEAK_HBM_BYTES) * 1e3
            key = f"N{nn}_K{k}"
            out["ms"][key], out["bound_ms"][key] = ms, bound
            log(f"dg_diff {(mm_, nn, k)}: {ms:.4g} ms (bound {bound:.4g} "
                f"ms)")
            del d, ut
    return out


def model_layer_sizes(configs) -> dict:
    """The real sizes of the model-layer kernels: the widths of the
    port's gemma2-9b, zamba2-7b and xlstm-125m configs."""
    att = configs.get_config("gemma2-9b").attention
    zamba = configs.get_config("zamba2-7b")
    xl = configs.get_config("xlstm-125m")
    batch, steps = REAL_SLSTM
    return {
        "attention": dict(B=1, S=REAL_ATTN_S, Hq=att.num_heads,
                          Hkv=att.num_kv_heads, D=att.head_dim),
        # the local layer (the row) and the global layer (its variant)
        "local": dict(causal=True, window=att.window,
                      softcap=att.logit_softcap),
        "global": dict(causal=True, softcap=att.logit_softcap),
        "ssd": dict(B=1, S=REAL_SSD_S, H=zamba.ssm.num_heads(zamba.d_model),
                    P=zamba.ssm.head_dim, N=zamba.ssm.d_state,
                    chunk=zamba.ssm.chunk_size),
        "slstm": dict(B=batch, S=steps, H=xl.xlstm.num_heads,
                      dh=xl.d_model // xl.xlstm.num_heads),
    }


def attn_inputs(gen, dev, dtype, B, S, Hq, Hkv, D, q_scale=1.0):
    import torch
    q = torch.randn(B, S, Hq, D, generator=gen, device=dev) * q_scale
    k = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
    return tuple(t.to(dtype) for t in (q, k, v))


def ssd_inputs(gen, dev, B, S, H, P, N, chunk=None):
    """x·dt, dt·A (negative), B and C; ``chunk`` is ignored, so a size
    dict from :func:`model_layer_sizes` can be passed whole."""
    import torch
    return (torch.randn(B, S, H, P, generator=gen, device=dev),
            -torch.randn(B, S, H, generator=gen, device=dev).abs() * 0.1,
            torch.randn(B, S, H, N, generator=gen, device=dev),
            torch.randn(B, S, H, N, generator=gen, device=dev))


def slstm_inputs(gen, dev, B, S, H, dh):
    import torch
    return (torch.randn(B, S, 4, H, dh, generator=gen, device=dev) * 0.5,
            torch.randn(H, dh, 4, dh, generator=gen, device=dev) * 0.1,
            torch.randn(4, H, dh, generator=gen, device=dev) * 0.1)


def attention_f32(ref, kw, q, k, v):
    """The plain attention in f32 from (bf16) inputs."""
    return ref.attention_ref(q.float(), k.float(), v.float(), **kw)


def flex_library(kw, seq, dev):
    """One PyTorch call computing the same attention:
    ``torch.compile``'d ``flex_attention`` (the tanh softcap as its
    score_mod, the causal and window masks as its block mask, GQA through
    ``enable_gqa``) on [B, S, H, D] tensors viewed as [B, H, S, D].  Used
    only to time the library here; the port never calls it."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    cap, window = kw.get("softcap"), kw.get("window")

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki if kw.get("causal", True) else qi >= 0
        if window is not None:
            keep = keep & (qi - ki < window)
        return keep

    def softcap(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    mask = create_block_mask(mask_mod, None, None, seq, seq, device=dev)
    flex = torch.compile(flex_attention, dynamic=False)

    def call(q, k, v):
        return flex(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    score_mod=softcap if cap is not None else None,
                    block_mask=mask, scale=kw.get("scale"),
                    enable_gqa=True).transpose(1, 2)
    return call


def ssd_variants(variants, chunk):
    """The SSD's plain variants, each of which a check must reject; where
    the kernel runs at a shorter chunk than the caller's, also the state
    one of its own chunks late."""
    import functools

    from repro_torch.kernels.mamba2_ssd import inner_chunk
    wrongs = [("no carried state", variants.ssd_without_carried_state,
               chunk),
              ("state one chunk late", variants.ssd_state_one_chunk_late,
               chunk)]
    if inner_chunk(chunk) != chunk:
        wrongs.append((f"state one kernel chunk ({inner_chunk(chunk)}) "
                       f"late", variants.ssd_state_one_chunk_late,
                       inner_chunk(chunk)))
    return [(label, functools.partial(fn, chunk=c)) for label, fn, c in wrongs]


def slstm_variants(variants):
    """The sLSTM's plain variants, each of which a check must reject."""
    return [("r = 0", variants.slstm_without_recurrence),
            ("peers' h one step stale", variants.slstm_peer_h_stale)]


def check_model_kernels(ops, ref, variants, dev, sizes) -> dict:
    """Phase 2 for the model-layer kernels: each against its plain
    version at every ``tests/test_kernels.py`` case and at the real
    sizes, with each plain variant held to failing; returns the max
    absolute error at the real sizes per kernel."""
    import functools

    import torch
    gen = torch.Generator(device=dev).manual_seed(13)
    for dt, tdt in (("float32", torch.float32),
                    ("bfloat16", torch.bfloat16)):
        for kw in variants.ATTN_KW:
            for shape in variants.ATTN_SHAPES:
                fa = functools.partial(ops.flash_attention, block_q=64,
                                       block_k=64, **kw)
                plain = functools.partial(ref.attention_ref, **kw)
                err = verify(fa, plain, attn_inputs(gen, dev, tdt, *shape),
                             **TOL[dt])
                log(f"flash_attention {dt} {shape} {kw}: max|err| "
                    f"{err:.3g}; q×{ATTN_Q_SCALE}:")
                verify(fa, plain, attn_inputs(gen, dev, tdt, *shape,
                                              q_scale=ATTN_Q_SCALE),
                       variants.attention_variants_for(kw, shape[2],
                                                       shape[3]),
                       **TOL[dt])
    for b, s, h, p, n, chunk in variants.SSD_SHAPES:
        err = verify(functools.partial(ops.mamba2_ssd, chunk=chunk),
                     ref.ssd_ref, ssd_inputs(gen, dev, b, s, h, p, n),
                     ssd_variants(variants, chunk), **TOL["float32"])
        log(f"mamba2_ssd {(b, s, h, p, n)} chunk {chunk}: max|err| {err:.3g}")
    for shape in variants.SLSTM_SHAPES:
        err = verify(ops.slstm_cell, ref.slstm_cell_ref,
                     slstm_inputs(gen, dev, *shape),
                     slstm_variants(variants), **TOL["float32"])
        log(f"slstm_cell {shape}: max|err| {err:.3g}")

    from repro_torch.kernels import flash_attention as fa_module
    a = sizes["attention"]
    errs = {"flash_attention": 0.0}
    tile_q = fa_module.TILE_Q[torch.bfloat16]
    for layer in ("local", "global"):
        kw = sizes[layer]
        heads = a["B"] * a["Hq"]
        visited = heads * fa_module.kv_tiles_visited(
            a["S"], a["S"], kw["causal"], kw.get("window"), tile_q)
        full = heads * -(-a["S"] // tile_q) * -(-a["S"] // fa_module.TILE_K)
        log(f"flash_attention {layer}: the kernel visits {visited} kv tiles "
            f"({tile_q} query × {fa_module.TILE_K} key rows) of a full "
            f"sweep's {full} ({visited / full:.1%})")
        fa = functools.partial(ops.flash_attention, **kw)
        skip = functools.partial(variants.attention_skip_last_kv_tile,
                                 block_k=128, **kw)
        # q × 1 against the plain version in f32: late rows, |o| ~ 0.02
        err = verify(fa, functools.partial(attention_f32, ref, kw),
                     attn_inputs(gen, dev, torch.bfloat16, **a),
                     [("last kv tile skipped",
                       lambda *t: skip(*(x.float() for x in t)))],
                     **REAL_ATTN_F32_TOL)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        log(f"flash_attention bf16 {a} {layer} {kw} q×1: max|err| "
            f"{err:.3g} vs f32 ({REAL_ATTN_F32_TOL})")
        # q × 8 against the plain version in bf16, with the variants
        err = verify(fa, functools.partial(ref.attention_ref, **kw),
                     attn_inputs(gen, dev, torch.bfloat16, **a,
                                 q_scale=ATTN_Q_SCALE),
                     variants.attention_variants_for(kw, a["Hq"], a["Hkv"]),
                     **REAL_ATTN_TOL)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        log(f"flash_attention bf16 {a} {layer} {kw} q×{ATTN_Q_SCALE}: "
            f"max|err| {err:.3g} ({REAL_ATTN_TOL})")
        torch.cuda.empty_cache()
    ssd = sizes["ssd"]
    errs["mamba2_ssd"] = verify(
        functools.partial(ops.mamba2_ssd, chunk=ssd["chunk"]), ref.ssd_ref,
        ssd_inputs(gen, dev, **ssd), ssd_variants(variants, ssd["chunk"]),
        **REAL_SSD_TOL)
    log(f"mamba2_ssd {ssd}: max|err| {errs['mamba2_ssd']:.3g} "
        f"({REAL_SSD_TOL})")
    errs["slstm_cell"] = verify(
        ops.slstm_cell, ref.slstm_cell_ref,
        slstm_inputs(gen, dev, **sizes["slstm"]), slstm_variants(variants),
        **TOL["float32"])
    log(f"slstm_cell {sizes['slstm']}: max|err| {errs['slstm_cell']:.3g} "
        f"({TOL['float32']})")
    return errs


def sass_counts(lib: Path) -> dict:
    """Per kernel function in the library's SASS (``cuobjdump -sass``):
    how many instructions of each opcode it holds, and each loop (a
    backward branch: ``[target, branch]`` addresses) with the opcodes
    inside it.  Empty when the toolkit has no ``cuobjdump``."""
    import re
    from repro_torch.kernels import _build
    opcodes = ("FFMA", "FADD")
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            funcs[fn] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*)", line)
        if fn is not None and m:
            funcs[fn].append((int(m.group(1), 16), m.group(2)))
    result = {}
    for fn, instrs in funcs.items():
        def count(lo=0, hi=float("inf")):
            c = dict.fromkeys(opcodes, 0)
            for addr, text in instrs:
                words = text.replace(";", " ").split()
                for op in opcodes:
                    if lo <= addr <= hi and any(
                            w == op or w.startswith(op + ".") for w in words):
                        c[op] += 1
            return c
        loops = []
        for addr, text in instrs:
            b = re.search(r"\bBRA\s+(?:\S+\s+)?0x([0-9a-f]+)", text)
            if b and int(b.group(1), 16) < addr:
                lo = int(b.group(1), 16)
                loops.append({"loop": f"{lo:#x}-{addr:#x}",
                              **count(lo, addr)})
        result[fn] = {**count(), "loops": loops}
    return result


def check_madd_sass(sass: dict) -> None:
    """The microbench kernels' SASS counts; ``madd_kernel``'s innermost
    chain loop must issue 8 FFMAs per unrolled step (8 chains) and no
    FADD, so nothing of the chain was folded or reassociated."""
    for fn, found in sass.items():
        if "madd" in fn or "stream" in fn:
            log(f"sass {fn}: {found}")
    madd = [found for fn, found in sass.items() if "madd_kernel" in fn]
    if not madd:
        raise SystemExit("cuobjdump found no madd_kernel in the library")
    loops = [lp for lp in madd[0]["loops"] if lp["FFMA"]]
    inner = min(loops, key=lambda lp: lp["FFMA"] + lp["FADD"],
                default=None)
    if inner is None or inner["FFMA"] % 8 or inner["FADD"]:
        raise SystemExit(f"madd_kernel's chain loop is not 8 FFMAs per "
                         f"step: {madd[0]}")
    log(f"sass madd_kernel chain loop: {inner['FFMA']} FFMA = "
        f"{inner['FFMA'] // 8} steps × 8 chains per iteration")


def ptxas_report(text: str) -> dict:
    """Per kernel function in ``nvcc -Xptxas=-v`` output: (registers,
    spill store bytes, spill load bytes)."""
    import re
    report, fn = {}, None
    for line in text.splitlines():
        if line.startswith("== "):   # the next source's report
            fn = None
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w]+)'?", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if fn and m:
            regs, stores, loads = report.get(fn, (0, 0, 0))
            report[fn] = (regs, int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if fn and m:
            _, stores, loads = report.get(fn, (0, 0, 0))
            report[fn] = (int(m.group(1)), stores, loads)
    return report


#: kernel functions held to no register spills, by name fragment
NO_SPILLS = ("matmul_tiled_kernel", "flash_mma_kernel", "flash_kernel",
             "bwd_mma_kernel", "bwd_kernel", "delta_kernel",
             "bwd_wg_query_kernel", "bwd_wg_key_kernel", "wgmma_tile_kernel",
             "dg_diff_kernel", "stream_kernel", "slstm_cluster_kernel",
             "chunk_state_kernel", "state_pass_kernel", "chunk_out_kernel",
             "chunk_grad_kernel", "slstm_bwd_cluster_kernel",
             "ssd_chain_state_kernel", "ssd_chain_grad_kernel",
             "wgmma_tf32_tile_kernel")


#: and the instances each of these must have in the report: the sLSTM
#: backward's dh 64, 128, 192 (clusters of 6) and 256 (of 8), 1 or 2 rows
NO_SPILLS_INSTANCES = {"slstm_bwd_cluster_kernel": 8}


def check_no_spills(text: str) -> None:
    """Log registers and spills of the ``NO_SPILLS`` functions in a ptxas
    report and fail if one spills, or if a ``NO_SPILLS_INSTANCES`` kernel
    has another number of instances there."""
    found = {fn: r for fn, r in ptxas_report(text).items()
             if any(part in fn for part in NO_SPILLS)}
    if not found:
        raise SystemExit(f"the ptxas report names none of {NO_SPILLS}")
    for part, want in NO_SPILLS_INSTANCES.items():
        got = sum(part in fn for fn in found)
        if got != want:
            raise SystemExit(f"the ptxas report has {got} instances of "
                             f"{part}, not {want}")
    for fn, (regs, stores, loads) in sorted(found.items()):
        log(f"ptxas {fn}: {regs} registers, {stores} bytes spill stores, "
            f"{loads} bytes spill loads")
        if stores or loads:
            raise SystemExit(f"{fn} spills registers")


def check_no_serialized_wgmma(text: str) -> None:
    """Fail if ptxas serialized a ``wgmma.mma_async`` anywhere (its
    warning names the function and the reason): a serialized warpgroup
    product gives up the asynchronous issue the bf16 attention backward
    is built on, without any other sign."""
    bad = [line.strip() for line in text.splitlines()
           if "wgmma.mma_async instructions are serialized" in line]
    if bad:
        raise SystemExit("ptxas serialized wgmma products:\n" +
                         "\n".join(bad))
    fns = sorted({m for m in ptxas_report(text) if "wgmma" in m
                  or "bwd_wg_" in m or "ssd_chain_" in m})
    log(f"ptxas: no serialized wgmma in the {len(fns)} functions of the "
        f"wgmma path")


def time_zoo_kernels(ops, ref, dev, preds_by_rung, F):
    """Phase 7's timing: every kernel at its real size, its plain
    version, one library call where there is one, and its bound; returns
    one JSON row per kernel (stream_strided carries its stride-4
    variant) and the cases (callables and inputs) they were timed on."""
    import functools

    import numpy as np
    import torch
    rng = np.random.default_rng(11)
    m, k, n = REAL_MATMUL
    mm, nn, kk = REAL_DG
    size, n_arrays, block = REAL_STREAM
    madd_s, madd_iters, madd_block = REAL_MADD
    lap = torch.tensor([[0., 1., 0.], [1., -4., 1.], [0., 1., 0.]],
                       device=dev)[None, None]
    stream_arrs = tuple(randn(rng, size).to(dev) for _ in range(n_arrays))

    def stream_case(stride):
        n_read = size // stride
        return dict(
            kernel=lambda *a: ops.stream_strided(list(a), block=block,
                                                 stride=stride),
            plain=lambda *a: ref.stream_ref(list(a), block=block,
                                            stride=stride),
            library=lambda x, y: torch.add(x.view(-1, block)[::stride],
                                           y.view(-1, block)[::stride]),
            args=stream_arrs,
            work=((n_arrays - 1) * n_read, 4 * (n_arrays + 1) * n_read))

    cases = {
        "matmul_tiled": dict(
            kernel=ops.matmul, plain=ref.matmul_ref, library=torch.matmul,
            args=(randn(rng, m, k).to(dev), randn(rng, k, n).to(dev)),
            work=(2 * m * n * k, 4 * (m * k + k * n + m * n))),
        "stencil5": dict(
            kernel=ops.stencil5, plain=ref.stencil5_ref,
            library=lambda x: F.conv2d(x[None, None], lap, padding=1),
            args=(randn(rng, *REAL_STENCIL).to(dev),),
            work=(5 * math.prod(REAL_STENCIL),
                  4 * 2 * math.prod(REAL_STENCIL))),
        "dg_diff": dict(
            kernel=ops.dg_diff, plain=ref.dg_diff_ref, library=torch.matmul,
            args=(randn(rng, mm, nn, nn).to(dev), randn(rng, nn, kk).to(dev)),
            work=(2 * mm * nn * nn * kk,
                  4 * (mm * nn * nn + nn * kk + mm * nn * kk))),
        "stream_strided": stream_case(1),
        "madd_throughput": dict(
            kernel=functools.partial(ops.madd_throughput, iters=madd_iters,
                                     block=madd_block),
            plain=functools.partial(ref.madd_ref, iters=madd_iters),
            library=None,
            args=(randn(rng, madd_s).to(dev),),
            # an FMA is two operations
            work=(16 * madd_iters * madd_s + 15 * madd_s, 8 * madd_s)),
    }
    cases["stream_strided"]["variant"] = ("stride4", stream_case(4))

    def measure(case, preds):
        ops_n, nbytes = case["work"]
        t_ops = ops_n / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        ms = time_ms(case["kernel"], *case["args"])
        lib = case["library"]
        return {
            "ms": ms,
            "tflops": ops_n / ms / 1e9,
            "plain_ms": time_ms(case["plain"], *case["args"]),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None if lib is None else time_ms(lib,
                                                           *case["args"]),
            "predicted_ms": {r: p * 1e3 for r, p in preds.items()},
            "pred_over_meas": {r: p * 1e3 / ms for r, p in preds.items()},
        }

    rows = {}
    for name, case in cases.items():
        rows[name] = measure(case, preds_by_rung[name])
        if "variant" in case:
            tag, var = case["variant"]
            rows[name][tag] = measure(var, preds_by_rung[f"{name}_{tag}"])
    return rows, cases


def model_layer_cases(ops, ref, sizes) -> dict:
    """The model-layer kernels at their real sizes: the wrapper, its
    plain version, the input maker, the meta arguments to price, and the
    work these inputs need (operations, bytes, peak rate).  Attention
    counts only the unmasked (q, k) pairs and SSD only the i >= j half of
    each chunk's L × L form, at the chunk the kernel runs at (its result
    does not depend on the chunk; its work shrinks with it); every byte
    once."""
    import functools

    import torch
    from repro_torch.kernels.mamba2_ssd import inner_chunk
    a, ssd, sl = sizes["attention"], sizes["ssd"], sizes["slstm"]
    meta = functools.partial(torch.empty, device="meta")
    b, s, hq, hkv, d = a["B"], a["S"], a["Hq"], a["Hkv"], a["D"]
    attn_bytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)

    def attention(kw):
        w = min(kw.get("window") or s, s)
        pairs = w * (w + 1) // 2 + (s - w) * w
        return dict(
            kernel=functools.partial(ops.flash_attention, **kw),
            plain=functools.partial(ref.attention_ref, **kw),
            inputs=lambda gen, dev: attn_inputs(gen, dev, torch.bfloat16,
                                                **a),
            meta=tuple(meta(b, s, h, d, dtype=torch.bfloat16)
                       for h in (hq, hkv, hkv)),
            work=(2 * b * hq * pairs * 2 * d, attn_bytes, PEAK_BF16_FLOPS),
            plain_iters=5,
            library=functools.partial(flex_library, kw, s),
            library_plain=functools.partial(attention_f32, ref, kw))

    el = inner_chunk(ssd["chunk"])
    n_chunks = ssd["S"] // el
    heads = ssd["B"] * ssd["H"]
    p_, n_ = ssd["P"], ssd["N"]
    sb, ss, sh, dh = sl["B"], sl["S"], sl["H"], sl["dh"]
    return {
        "flash_attention": attention(sizes["local"]),
        "flash_attention_global": attention(sizes["global"]),
        "mamba2_ssd": dict(
            kernel=functools.partial(ops.mamba2_ssd, chunk=ssd["chunk"]),
            plain=ref.ssd_ref,
            inputs=lambda gen, dev: ssd_inputs(gen, dev, **ssd),
            meta=(meta(ssd["B"], ssd["S"], ssd["H"], p_),
                  meta(ssd["B"], ssd["S"], ssd["H"]),
                  meta(ssd["B"], ssd["S"], ssd["H"], n_),
                  meta(ssd["B"], ssd["S"], ssd["H"], n_)),
            work=(2 * heads * n_chunks * (el * (el + 1) // 2 * (n_ + p_)
                                          + 2 * el * p_ * n_),
                  4 * heads * ssd["S"] * (2 * p_ + 2 * n_ + 1),
                  PEAK_F32_FLOPS),
            plain_iters=2),
        "slstm_cell": dict(
            kernel=ops.slstm_cell, plain=ref.slstm_cell_ref,
            inputs=lambda gen, dev: slstm_inputs(gen, dev, **sl),
            meta=(meta(sb, ss, 4, sh, dh), meta(sh, dh, 4, dh),
                  meta(4, sh, dh)),
            work=(2 * sb * ss * sh * dh * 4 * dh,
                  4 * (sb * ss * 4 * sh * dh + sh * dh * 4 * dh + 4 * sh * dh
                       + sb * ss * sh * dh),
                  PEAK_F32_FLOPS),
            plain_iters=2),
    }


def model_layer_path(calibrate_main, PerfSession, cases, dev, base_profile,
                     zoo_profile) -> dict:
    """Phase 8: predict the model-layer kernels with zero timings — CLI
    ``predict`` at the reference target shapes, ``PerfSession`` at the
    real sizes under the base fit and each zoo rung — then run each on
    the card beside its plain version, one library call where there is
    one, and its bound.  Returns one row per
    kernel (flash_attention carries its global layer as a variant)."""
    import math

    import torch
    rc = calibrate_main(["predict", str(base_profile),
                         "--kernel", "kernels.ops.flash_attention",
                         "--kernel", "kernels.ops.mamba2_ssd",
                         "--kernel", "kernels.ops.slstm_cell",
                         "--explain", "3", "--expect-zero-timings"])
    if rc != 0:
        raise SystemExit(f"predict of the model-layer kernels exited {rc}")
    names = list(cases)
    items = [(c["kernel"], c["meta"]) for c in cases.values()]
    preds = {name: {} for name in names}
    for path, rungs in ((base_profile, ("base",)), (zoo_profile, ZOO)):
        session = PerfSession.open(path)
        for rung in rungs:
            for p in session.predict_batch(items, model=rung, names=names):
                if not (math.isfinite(p.seconds) and p.seconds > 0):
                    raise SystemExit(f"{rung} prediction {p.kernel}: "
                                     f"{p.seconds}")
                preds[p.kernel][rung] = p.seconds * 1e3
                log(f"{p.kernel} {rung}: predicted {p.seconds * 1e3:.4g} ms, "
                    f"unmodeled {sorted(p.unmodeled)}")
        if session.timer.calls != 0:
            raise SystemExit(f"model-layer prediction timed "
                             f"{session.timer.calls} kernels")
        log(f"model-layer prediction from {path.name}: timings_performed="
            f"{session.timer.calls} batched_evals={session.eval_calls}")

    gen = torch.Generator(device=dev).manual_seed(17)
    rows = {}
    for name, case in cases.items():
        args = case["inputs"](gen, dev)
        ops_n, nbytes, peak = case["work"]
        t_ops, t_bytes = ops_n / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        ms = time_ms(case["kernel"], *args)
        lib_ms = None
        if "library" in case:
            lib = case["library"](dev)
            t0 = time.perf_counter()
            err = verify(lib, case["library_plain"], args,
                         **REAL_ATTN_F32_TOL)
            log(f"{name} library call agrees with the plain version: max "
                f"|err| {err:.3g} ({REAL_ATTN_F32_TOL}; first call with "
                f"its compile {time.perf_counter() - t0:.1f} s)")
            lib_ms = time_ms(lib, *args)
        rows[name] = {
            "ms": ms,
            "tflops": ops_n / ms / 1e9,
            "plain_ms": time_ms(case["plain"], *args,
                                iters=case["plain_iters"], warmup=1),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
            "predicted_ms": preds[name],
            "pred_over_meas": {r: v / ms for r, v in preds[name].items()},
        }
        del args
        torch.cuda.empty_cache()
    rows["flash_attention"]["global"] = rows.pop("flash_attention_global")
    return rows


def floor_and_passes(slstm_cell, mamba2_ssd, sizes, dev) -> dict:
    """Phase 9 for the recurrent kernels (after the counted paths, so
    these launches count nowhere): the sLSTM kernel's step-latency floor
    — the same kernel at B = 1, H = 1, dh = 4 and the real S, where the
    dot vanishes and S × (gating, exchange of h) is left —
    and each of the SSD's three passes at the real size (scratch filled
    by one run of the passes in order first)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(19)
    floor_ms = time_ms(slstm_cell.slstm_cell_cuda, *slstm_inputs(
        gen, dev, B=1, S=sizes["slstm"]["S"], H=1, dh=4))
    ssd = sizes["ssd"]
    _, calls = mamba2_ssd.pass_calls(*ssd_inputs(gen, dev, **ssd),
                                     ssd["chunk"])
    for _, launch in calls:
        launch()
    pass_ms = {name: time_ms(launch) for name, launch in calls}
    del calls
    torch.cuda.empty_cache()
    return {"step_floor_ms": floor_ms, "pass_ms": pass_ms}


def figures_path(paper_figures, default_timer, profile, dev) -> dict:
    """Phase 10: the paper's figures on the card, from phase 3's profile.
    Each kernel is timed once through a recording timer: a figure that
    times more kernels than the reference's tags select (its predictions
    included), a kernel twice, or reads a time that is not finite and
    positive fails the phase.  Returns each figure's rows and seconds."""
    timed = []

    def timer(kernel, trials):
        stats = default_timer(kernel, trials, device=dev)
        timed.append((kernel.name, stats.median))
        return stats

    out = {}
    for name in paper_figures.FIGURES:
        timed.clear()
        t0 = time.perf_counter()
        rows = paper_figures.run_figure(name, profile, device=dev,
                                        trials=FIGURE_TRIALS, timer=timer)
        secs = time.perf_counter() - t0
        for row in rows:
            print(row, flush=True)
        names = [k for k, _ in timed]
        if len(names) != FIGURE_KERNELS[name] or \
                len(set(names)) != len(names):
            raise SystemExit(f"{name} timed {names}: the reference's tags "
                             f"select {FIGURE_KERNELS[name]} kernels, each "
                             f"timed once")
        bad = [(k, t) for k, t in timed if not (math.isfinite(t) and t > 0)]
        if bad:
            raise SystemExit(f"{name}: measured times not finite and "
                             f"positive: {bad}")
        summary = {}
        for row in rows:
            key, value = row.split(",")[:2]
            stat = key.split(".", 1)[1]
            if stat in ("gmre_percent", "top1_rank_correct", "p_edge",
                        "residual_norm", "converged"):
                summary[stat] = value
        log(f"{name}: {secs:.1f} s, {len(names)} kernels timed, {summary}")
        out[name] = {"seconds": secs, "rows": rows}
    return out


def loop_costs(uipick, dev) -> dict:
    """Phase 10's loops: a step of a reference ``fori_loop``/``scan`` is
    one or two eager launches here, one graph node each.  For the
    longest loop of each loop generator: one eager call, the capture
    (its 3 warm-up calls and the graph's instantiation included) and the
    first replay (the upload) by the host clock, then a replay by
    :func:`time_ms`; each also per step."""
    import torch
    longest = {"loopstep_s32768": 32768,
               "overlap_n16777216_m65536_float32": 65536,
               "onchip_w32768_i1024_float32": 1024}
    kernels = uipick.KernelCollection(uipick.ALL_GENERATORS) \
        .generate_kernels(["sync", "overlap", "lmem"],
                          uipick.MatchCondition.INTERSECT)
    out = {}
    for k in kernels:
        if k.name not in longest:
            continue
        steps = longest[k.name]
        args = k.make_args(dev)
        secs = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k.fn(*args)
        torch.cuda.synchronize()
        secs["eager_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph, res = k.capture(args)
        torch.cuda.synchronize()
        secs["capture_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        secs["first_replay_s"] = time.perf_counter() - t0
        secs["replay_ms"] = time_ms(graph.replay)
        secs["us_per_step"] = {
            "eager": secs["eager_s"] / steps * 1e6,
            "capture": secs["capture_s"] / steps * 1e6,
            "replay": secs["replay_ms"] / steps * 1e3}
        log(f"{k.name} ({steps} steps): eager {secs['eager_s']:.3f} s, "
            f"capture {secs['capture_s']:.3f} s, first replay "
            f"{secs['first_replay_s']:.3f} s, replay "
            f"{secs['replay_ms']:.4g} ms; per step "
            + ", ".join(f"{w} {v:.4g} µs"
                        for w, v in secs["us_per_step"].items()))
        out[k.name] = secs
        del graph, res, args
        torch.cuda.empty_cache()
    if len(out) != len(longest):
        raise SystemExit(f"loop kernels {sorted(longest)} not all built: "
                         f"{sorted(out)}")
    return out


def zoo_items(ops, f32) -> dict:
    """The five zoo-path kernels at their real sizes, as (wrapper, meta
    arguments) predict items (stream_strided at both strides)."""
    import functools
    m, k, n = REAL_MATMUL
    mm, nn, kk = REAL_DG
    size, n_arrays, block = REAL_STREAM
    madd_s, madd_iters, madd_block = REAL_MADD
    stream = [f32(size) for _ in range(n_arrays)]
    return {
        "matmul_tiled": (ops.matmul, (f32(m, k), f32(k, n))),
        "stencil5": (ops.stencil5, (f32(*REAL_STENCIL),)),
        "dg_diff": (ops.dg_diff, (f32(mm, nn, nn), f32(nn, kk))),
        "stream_strided": (functools.partial(
            ops.stream_strided, block=block, stride=1), (stream,)),
        "stream_strided_stride4": (functools.partial(
            ops.stream_strided, block=block, stride=4), (stream,)),
        "madd_throughput": (functools.partial(
            ops.madd_throughput, iters=madd_iters, block=madd_block),
            (f32(madd_s),)),
    }


def echo_run(main, argv, echo: bool = True):
    """One CLI ``main(argv)`` run with its standard output kept (and
    echoed): exit code, the output and the host seconds."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    if echo:
        print(text, end="", flush=True)
    return rc, text, seconds


def run_cli(calibrate_main, argv) -> dict:
    """One ``repro_torch.calibrate`` run with its output echoed: exit
    code, host seconds and the counters it prints."""
    rc, text, seconds = echo_run(calibrate_main, argv)
    counters = {k: int(v) for k, v in re.findall(
        r"(timings_performed|cache_hits|count_traces|count_hits|retimed)="
        r"(\d+)", text)}
    retimed = re.search(r"retimed=\d+ rows above rel-std \S+: (\[.*\])",
                        text)
    return {"rc": rc, "seconds": seconds, **counters,
            "retimed_rows": ast.literal_eval(retimed[1]) if retimed else []}


def amortization_path(calibrate_main, PerfSession, CountEngine, uipick,
                      paper_figures, presets, studies, items, profile_path,
                      zoo_profile, tmp) -> dict:
    """Phase 11: the measurement cache, the count engine and retiming on
    the card.  (a) the base battery (3 trials) into a fresh cache, cold
    then warm: the warm run must time nothing, count nothing and write the
    cold run's profile byte for byte; (b) host seconds to count the base
    battery and the seven figures' kernels three ways — ``count_fn`` per
    shape, the engine cold, the engine warm (no counting pass) — with
    every count equal; (c) the zoo study with ``--retime-rel-std 0.05``,
    its re-timed rows and held-out gmre per rung beside phase 6's;
    (d) ``PerfSession(cache=...)`` prices ``items`` (all eight hand
    kernels at phases 7–8's real sizes) twice, and a second session over
    the same cache once: only the first pricing may count."""
    from repro_torch.core.calibrate import gmre_of
    cache_dir = tmp / "measurement_cache"
    out = {"battery": {}}
    for run, extra in (("cold", []), ("warm", ["--expect-zero-timings"])):
        res = run_cli(calibrate_main, [
            "--out", str(tmp / f"h100_cached_{run}.json"), "--trials", "3",
            "--device", "cuda", "--cache-dir", str(cache_dir), *extra])
        if res["rc"] != 0:
            raise SystemExit(f"{run} cached calibration exited {res['rc']}")
        out["battery"][run] = {k: res[k] for k in (
            "seconds", "timings_performed", "count_traces", "cache_hits")}
        log(f"base battery {run}: {res['seconds']:.2f} s, timings "
            f"{res['timings_performed']}, count traces "
            f"{res['count_traces']}, cache hits {res['cache_hits']}")
    warm = out["battery"]["warm"]
    same = (tmp / "h100_cached_cold.json").read_bytes() == \
        (tmp / "h100_cached_warm.json").read_bytes()
    out["battery"]["profile_bytes_identical"] = same
    if warm["timings_performed"] or warm["count_traces"] or not same:
        raise SystemExit(f"warm recalibration is not free: {warm}, "
                         f"profiles identical: {same}")

    tags = [(presets.CALIBRATION_TAGS, uipick.MatchCondition.INTERSECT)] + [
        (t, uipick.MatchCondition.SUPERSET) for t in (
            paper_figures.FIG1_CAL_TAGS, paper_figures.FIG12_TEST_TAGS,
            paper_figures.FIG2_CAL_TAGS, paper_figures.FIG5_TAGS,
            paper_figures.FIG7_TAGS, paper_figures.FIG8_TAGS,
            paper_figures.FIG9_TAGS)]

    def fresh():
        coll = uipick.KernelCollection(uipick.ALL_GENERATORS)
        return [k for t, match in tags
                for k in coll.generate_kernels(t, match)]

    store = tmp / "count_store"
    ways = {}
    for way in ("count_fn", "engine_cold", "engine_warm"):
        kernels = fresh()
        engine = CountEngine(store=store)
        t0 = time.perf_counter()
        rows = ([k.counts() for k in kernels] if way == "count_fn"
                else engine.counts_batch(kernels))
        ways[way] = {"seconds": time.perf_counter() - t0,
                     "traces": (len(kernels) if way == "count_fn"
                                else engine.trace_count),
                     "rows": rows}
        log(f"counting {len(kernels)} kernels, {way}: "
            f"{ways[way]['seconds']:.3f} s host, "
            f"{ways[way]['traces']} counting passes")
    names = [k.name for k in fresh()]
    for way in ("engine_cold", "engine_warm"):
        for name, want, got in zip(names, ways["count_fn"]["rows"],
                                   ways[way]["rows"]):
            diff = {f: (want[f], got[f]) for f in set(want) | set(got)
                    if want[f] != got[f]}
            if diff:
                raise SystemExit(f"{way} counts of {name} differ: {diff}")
    if ways["engine_warm"]["traces"]:
        raise SystemExit("the warm count engine counted again")
    out["counting"] = {"kernels": len(names), **{
        way: {k: v for k, v in w.items() if k != "rows"}
        for way, w in ways.items()}}

    zoo = tmp / "h100_zoo_retimed.json"
    res = run_cli(calibrate_main, ["--zoo", "--trials", "3", "--device",
                                   "cuda", "--retime-rel-std", "0.05",
                                   "--out", str(zoo)])
    if res["rc"] != 0:
        raise SystemExit(f"retimed zoo study exited {res['rc']}")
    gmre = {}
    for run, path in (("phase6", zoo_profile), ("retimed", zoo)):
        acc = studies.profile_accuracy(studies.load_profiles_any(path)[0])
        gmre[run] = {rung: gmre_of(acc[rung]) for rung in ZOO}
    out["zoo_retime"] = {"rel_std": 0.05, "seconds": res["seconds"],
                         "timings": res["timings_performed"],
                         "retimed_rows": res["retimed_rows"],
                         "holdout_gmre": gmre}
    log(f"zoo study with --retime-rel-std 0.05: {res['seconds']:.2f} s, "
        f"{len(res['retimed_rows'])} rows re-timed "
        f"{res['retimed_rows']}; held-out gmre "
        + "; ".join(f"{rung} {gmre['retimed'][rung]:.2%} (phase 6 "
                    f"{gmre['phase6'][rung]:.2%})" for rung in ZOO))

    pricing = []
    for session_no in (1, 2):
        session = PerfSession.open(profile_path, cache=cache_dir)
        for _ in range(2 if session_no == 1 else 1):
            t0 = time.perf_counter()
            preds = session.predict_batch(list(items.values()),
                                          names=list(items))
            pricing.append({"session": session_no,
                            "seconds": time.perf_counter() - t0,
                            "traces": session.engine.trace_count,
                            "hits": session.engine.hits,
                            "timings": session.timer.calls})
            if not all(math.isfinite(p.seconds) and p.seconds > 0
                       for p in preds):
                raise SystemExit(f"pricing: {[p.seconds for p in preds]}")
            log(f"pricing {len(items)} hand-kernel items, session "
                f"{session_no}: {pricing[-1]['seconds'] * 1e3:.2f} ms host, "
                f"count traces so far {session.engine.trace_count}, "
                f"hits {session.engine.hits}")
    first, again, other = pricing
    if first["traces"] != len(items) or again["traces"] != first["traces"] \
            or other["traces"] != 0 or any(p["timings"] for p in pricing):
        raise SystemExit(f"pricing counted or timed again: {pricing}")
    out["pricing"] = pricing
    return out


def tuning_path(tune_main, autotune, load_profile, profile_path,
                tmp) -> dict:
    """Phase 12 (a): predictor-guided autotuning of the three §8 spaces
    on the card, priced by phase 3's ``base`` fit and confirmed by the
    card's graph timer.  A cold ``tune search --save`` (margin 0, the
    0.2 budget exit-coded), a warm re-tune of the saved profile in a
    fresh session (``--expect-zero-timings``: 0 timings, 0 counting
    passes, 0 batched evaluations), the autotune study's pruned search
    against the exhaustive baseline over the 14 lattice points, and the
    synthetic ``citra`` search with ``--verify-optimum``.  A pruned
    winner that differs from the exhaustive one is logged, not fatal."""
    tuned = tmp / "h100_tuned.json"
    tuned.write_bytes(profile_path.read_bytes())
    runs = {}
    for run, extra in (("cold", ["--save", "--max-timed-fraction", "0.2"]),
                       ("warm", ["--expect-zero-timings"])):
        report = tmp / f"tune_{run}.json"
        rc, _text, seconds = echo_run(tune_main, [
            "search", "--profile", str(tuned), "--model", "base",
            "--margin", "0", "--trials", "3", "--json", str(report),
            *extra])
        if rc != 0:
            raise SystemExit(f"{run} tune search exited {rc}")
        runs[run] = {"seconds": seconds, **json.loads(report.read_text())}
    cold, warm = runs["cold"], runs["warm"]
    n_timed = sum(sp["n_timed"] for sp in cold["spaces"])
    if n_timed > 3 or cold["totals"]["timings"] != n_timed:
        raise SystemExit(f"cold search timed {cold['totals']['timings']} "
                         f"passes for {n_timed} survivors (at most 3)")
    if any(warm["totals"].values()) or \
            not all(sp["warm"] for sp in warm["spaces"]):
        raise SystemExit(f"warm re-tune was not pure cache: "
                         f"{warm['totals']}")
    log(f"tune search cold: {cold['seconds']:.2f} s, {n_timed} of "
        f"{sum(sp['n_variants'] for sp in cold['spaces'])} variants timed, "
        f"winners " + ", ".join(f"{sp['space']} {sp['winner']}"
                                 for sp in cold["spaces"])
        + f"; warm: {warm['seconds']:.2f} s, totals {warm['totals']}")

    t0 = time.perf_counter()
    study = autotune(load_profile(profile_path), trials=3)
    log(f"autotune study (pruned + exhaustive): "
        f"{time.perf_counter() - t0:.2f} s")
    if study["timings"] != {"pruned": 3, "exhaustive": 14}:
        raise SystemExit(f"autotune study timed {study['timings']}, not "
                         f"3 pruned against 14 exhaustive")
    for name, sp in study["spaces"].items():
        times = list(sp["measured_us"].values()) + \
            list(sp["predicted_us"].values())
        if not all(math.isfinite(t) and t > 0 for t in times):
            raise SystemExit(f"autotune {name}: {sp}")
        log(f"{name}: pruned {sp['pruned_winner']} (survivors "
            f"{sp['survivors']}), exhaustive {sp['exhaustive_winner']}, "
            f"regret {sp['regret']:.4g}"
            + ("" if sp["agree"] else " — DISAGREE (a finding)")
            + f"; wall {sp['pruned']['wall_s']:.3f} s pruned "
            f"({sp['pruned']['timer_s']:.3f} s in timing passes, "
            f"{sp['pruned']['replay_s'] * 1e3:.3f} ms replayed) vs "
            f"{sp['exhaustive']['wall_s']:.3f} s exhaustive "
            f"({sp['exhaustive']['timer_s']:.3f} s, "
            f"{sp['exhaustive']['replay_s'] * 1e3:.3f} ms)")
    log(f"winner agreement {study['winner_agreement']}, "
        f"speedup_timings_x {study['speedup_timings_x']:.3g}, "
        f"speedup_wall_x {study['speedup_wall_x']:.3g}")

    rc, _text, seconds = echo_run(tune_main, [
        "search", "--synthetic", "citra", "--smoke", "--trials", "2",
        "--margin", "0", "--verify-optimum", "--max-timed-fraction", "0.2",
        "--profile", str(tmp / "citra_tuned.json"), "--save"])
    if rc != 0:
        raise SystemExit(f"synthetic tune search exited {rc}")
    return {"cli": {run: {"seconds": r["seconds"], "totals": r["totals"],
                          "spaces": {sp["space"]: {
                              k: sp[k] for k in ("winner", "n_timed",
                                                 "n_variants", "survivors",
                                                 "measured", "warm")}
                              for sp in r["spaces"]}}
                    for run, r in runs.items()},
            "study": study, "synthetic_citra_seconds": seconds}


def audit_path(PerfSession, calibrate_main, lint_main, abstract_like,
               items, profile_path) -> dict:
    """Phase 12 (b): the static audit on the card's items, counted
    (the caller zeroes the launch counters before and reads them after).
    ``PerfSession.audit`` of the ten hand-kernel items of phases 7–8 on
    fake ``cuda`` tensors, ``predict --audit`` of the eight targets, and
    ``python -m repro_torch.lint --kernels`` against the port's
    baseline.  Fails on an error-severity finding, a timing, or a
    fake-tensor run count other than two an item.  Returns the codes
    found per target."""
    session = PerfSession.open(profile_path)
    fake = [(fn, abstract_like(args, "cuda")) for fn, args in items.values()]
    t0 = time.perf_counter()
    report = session.audit(fake, model="base")
    seconds = time.perf_counter() - t0
    if report.stats != {"timings": 0, "traces": 2 * len(items)} or \
            report.errors or session.timer.calls:
        raise SystemExit(f"PerfSession.audit: stats {report.stats}, "
                         f"errors {[d.key for d in report.errors]}")
    names = list(items)
    codes = {"session": {}}
    for d in report.sorted():
        idx = int(d.location.rsplit("[", 1)[1].rstrip("]"))
        codes["session"].setdefault(names[idx], []).append(d.code)
    log(f"PerfSession.audit of {len(items)} hand-kernel items on fake "
        f"cuda tensors: {seconds:.3f} s host, stats {report.stats}")

    targets = ["matmul", "stencil5", "dg_diff", "stream_strided",
               "madd_throughput", "flash_attention", "mamba2_ssd",
               "slstm_cell"]
    argv = ["predict", str(profile_path), "--audit", "--model", "base",
            "--expect-zero-timings"]
    for t in targets:
        argv += ["--kernel", f"kernels.ops.{t}"]
    rc, text, _ = echo_run(calibrate_main, argv)
    stats = re.search(r"\[audit\] timings=(\d+) traces=(\d+)", text)
    if rc != 0 or stats is None or stats[1] != "0" or \
            "timings_performed=0" not in text:
        raise SystemExit(f"predict --audit exited {rc}: {stats}")
    codes["predict"] = sorted(set(re.findall(
        r"\[audit\] \w+: (kernel:\S+): \[([\w-]+)\]", text)))

    rc, text, seconds = echo_run(lint_main, [
        "--kernels", "--json", "--baseline",
        str(ROOT / "torch_lint_baseline.json")], echo=False)
    lint = json.loads(text)
    if rc != 0 or lint["stats"]["timings"] or lint["new_errors"]:
        raise SystemExit(f"lint --kernels exited {rc}: new errors "
                         f"{lint['new_errors']}, stats {lint['stats']}")
    from repro_torch.analysis.targets import kernel_targets
    codes["lint"] = {f"kernel:{t.name}": [] for t in kernel_targets()}
    for d in lint["diagnostics"]:
        codes["lint"].setdefault(d["location"], []).append(d["code"])
    log(f"repro_torch.lint --kernels: {seconds:.2f} s host, counts "
        f"{lint['counts']}, stats {lint['stats']}")
    return {"codes": codes, "session_stats": report.stats,
            "predict_stats": {"timings": int(stats[1]),
                              "traces": int(stats[2])},
            "lint_stats": lint["stats"], "lint_counts": lint["counts"],
            "lint_baselined": sorted({d["code"] + "@" + d["location"]
                                      for d in lint["diagnostics"]
                                      if d["severity"] == "error"})}


def measured_ms(measured, name) -> float:
    """The card's time (ms) of one of phase 11's ten items, from phases
    7–8's rows (the ``stride4`` and ``global`` variants ride on their
    kernel's row)."""
    for base, tag in (("stream_strided", "stride4"),
                      ("flash_attention", "global")):
        if name == f"{base}_{tag}":
            return measured[base][tag]["ms"]
    return measured[name]["ms"]


def workremoval_path(uipick, remove_work, count_fn, run_main, dev) -> dict:
    """Phase 14: work removal and the four host benches.  The battery
    kernel ``matmul_sq`` (n 1024, f32, prefetch, tile 64) stripped of its
    first operand: its value on the card must be Σb (float64) within
    1e-5 of Σ|b| (f32 sums of 16 panels of 65536), its counts 0 madds and
    the contiguous loads of b alone (n², against 2n² unstripped); both
    kernels are timed as CUDA graphs through
    ``MeasurementKernel.time_stats``.  Then ``studies.run calibration
    study predict counting`` in process; a ``.FAILED`` row fails the
    phase.  Returns the numbers and the bench rows."""
    import torch
    (kern,) = uipick.KernelCollection(uipick.ALL_GENERATORS) \
        .generate_kernels(["matmul_sq", f"n:{WR_N}", "dtype:float32",
                           "prefetch:True", "tile:64"])
    args = kern.make_args(dev)
    stripped = remove_work(kern.fn, *args, remove_args=(0,))
    value = float(stripped(*args))
    want = float(args[1].double().sum())
    room = 1e-5 * float(args[1].double().abs().sum())
    log(f"stripped {kern.name}: {value!r} against Σb {want!r} "
        f"(|diff| {abs(value - want):.3g}, room {room:.3g})")
    if not abs(value - want) <= room:
        raise SystemExit(f"stripped {kern.name} returned {value}, Σb is "
                         f"{want}")
    meta = kern.make_args("meta")
    cs, co = count_fn(stripped, *meta), count_fn(kern.fn, *meta)
    n2 = WR_N * WR_N
    if cs["f_op_float32_madd"] != 0 or \
            cs["f_mem_contig_float32_load"] != n2 or \
            co["f_mem_contig_float32_load"] != 2 * n2:
        raise SystemExit(f"stripped counts {dict(cs)} against "
                         f"{dict(co)}")
    log(f"stripped counts: madd {cs['f_op_float32_madd']:.0f} (was "
        f"{co['f_op_float32_madd']:.0f}), contiguous f32 loads "
        f"{cs['f_mem_contig_float32_load']:.0f} (was "
        f"{co['f_mem_contig_float32_load']:.0f})")
    strip_kernel = uipick.MeasurementKernel(
        name=f"{kern.name}_stripped", fn=stripped, make_args=kern.make_args,
        tags=dict(kern.tags))
    del args
    times = {}
    for label, k in (("unstripped", kern), ("stripped", strip_kernel),
                     ("unstripped again", kern)):
        st = k.time_stats(trials=WR_TRIALS, device=dev)
        times.setdefault(label.split()[0], []).append(st.to_dict())
        log(f"{label} {kern.name} as a CUDA graph: median "
            f"{st.median * 1e3:.4g} ms, min {st.min * 1e3:.4g} ms, std "
            f"{st.std * 1e3:.3g} ms ({WR_TRIALS} trials)")
    rc, text, seconds = echo_run(
        run_main, ["calibration", "study", "predict", "counting"])
    rows = {}
    for line in text.splitlines()[1:]:
        name, us, derived = line.split(",", 2)
        rows[name] = {"us_per_call": float(us), "derived": derived}
    failed = [n for n in rows if n.endswith(".FAILED")]
    if rc != 0 or failed or len(rows) < 4 * 2:
        raise SystemExit(f"studies.run exited {rc}, failed {failed}")
    log(f"benches took {seconds:.1f} s; the row-by-row reference fit "
        f"{rows['calibration.fit64x3_reference']['us_per_call'] / 1e6:.3f}"
        f" s, param_max_rel_diff "
        f"{rows['calibration.param_max_rel_diff']['us_per_call']:.3g}")
    if not rows["calibration.param_max_rel_diff"]["us_per_call"] < 1e-4:
        raise SystemExit("the batched fit disagrees with the reference "
                         "engine")
    return {"workremoval": {
        "kernel": kern.name, "value": value, "sum_b": want,
        "abs_diff": abs(value - want), "room": room,
        "counts_stripped": dict(cs), "counts_unstripped": dict(co),
        "time_stats": times},
        "benches": {"rows": rows, "seconds": seconds}}


def serving_path(serve_main, fleet_main, FleetRouter, studies, synthdev,
                 save_profile, serve_bench, fleet_bench, load_profile,
                 items, measured, profile_path, tmp) -> dict:
    """Phase 13: serving and fleet routing on the card.  (a) ``python -m
    repro_torch.serve --smoke --burst 64 --expect-zero-timings`` on phase
    3's profile with a four-machine fleet (phase 6's ``h100_zoo`` and
    ``apex_zoo``, exact ``bulk`` and ``citra``); (b) a ``FleetRouter``
    over the same four profiles routes ``items`` (phase 11's ten
    real-size hand-kernel items), and each decision placed on the H100
    completes with the card's own time from phases 7–8 (the others with
    their predicted time), feeding the health layer; routing times
    nothing; (c) ``recalibrate`` re-studies the card (``STUDY_TAGS``, 3
    trials, no cache) and swaps the fresh session in; (d) the fleet
    CLI's ``simulate`` and ``health --recalibrate`` gates, then the two
    benches.  Returns the ``{"serving": ...}`` payload."""
    from repro_torch.core.calibrate import gmre_of
    from repro_torch.studies.zoo import STUDY_TAGS

    out = {}
    fleet_paths = [tmp / "h100_zoo.json", tmp / "apex_zoo.json"]
    for name in ("bulk", "citra"):
        fleet_paths.append(tmp / f"{name}_exact.json")
        save_profile(synthdev.exact_profile(synthdev.fleet_device(name)),
                     fleet_paths[-1])

    # (a) the served burst, with the fleet mounted
    argv = ["--profile", str(profile_path), "--smoke", "--burst", "64",
            "--expect-zero-timings"]
    for path in fleet_paths:
        argv += ["--fleet", str(path)]
    rc, text, seconds = echo_run(serve_main, argv)
    stats = re.search(r"serve smoke: stats (\{.*\})", text)
    routed = re.search(r"routed (\d+) kernels over (\d+) machines", text)
    if rc != 0 or stats is None or routed is None:
        raise SystemExit(f"serve --smoke exited {rc}")
    stats = json.loads(stats[1])
    if stats["timings"] or stats["count_lookups"] > 8 or \
            not 0 < stats["eval_calls"] < 64 or \
            stats["batcher"]["max_batch_size"] != 64 or \
            stats["batcher"]["requests"] != 64 or int(routed[2]) != 4 or \
            stats["fleet"]["timings"] or \
            any(v > 1e-12 for v in stats["fleet"]["outstanding"].values()):
        raise SystemExit(f"serve --smoke gates: {stats}, routed over "
                         f"{routed[2]} machines")
    out["serve_smoke"] = {"seconds": seconds, "stats": stats,
                          "fleet_machines": int(routed[2])}
    log(f"serve --smoke: {seconds:.2f} s host, 64 requests, "
        f"{stats['eval_calls']} batched evaluation(s), "
        f"{stats['count_lookups']} count lookups, {stats['timings']} "
        f"timings, routed over {routed[2]} machines")

    # (b) route the card's real-size items; the card's own times complete
    router = FleetRouter.open([str(p) for p in fleet_paths])
    try:
        short = {load_profile(p).fingerprint.id: label for p, label in
                 zip(fleet_paths, ("H100", "apex", "bulk", "citra"))}
        h100 = router.machines[0]
        t0 = time.perf_counter()
        decisions = router.route_batch(list(items.values()),
                                       names=list(items))
        route_s = time.perf_counter() - t0
        if router.timings():
            raise SystemExit(f"routing timed {router.timings()} kernels")
        placed, observed = [], []
        for name, d in zip(items, decisions):
            on_card = d.machine == h100
            obs = measured_ms(measured, name) / 1e3 if on_card \
                else d.predicted_s
            router.complete(d, observed_s=obs)
            placed.append({"kernel": name, "machine": short[d.machine],
                           "predicted_s": {short[m]: v for m, v
                                           in d.predicted.items()},
                           "observed_s": obs})
            if on_card:
                observed.append({"kernel": name, "predicted_s": d.predicted_s,
                                 "observed_s": obs,
                                 "ratio": obs / d.predicted_s})
            log(f"route {name} -> {short[d.machine]}; prices "
                + ", ".join(f"{short[m]} {v:.4g} s"
                            for m, v in d.predicted.items())
                + (f"; measured on the card {obs:.4g} s "
                   f"({obs / d.predicted_s:.3g}× predicted)"
                   if on_card else ""))
        health = router.health.report()
        # completing drains each predicted cost: float residue, not load
        if any(v > 1e-12 for v in router.outstanding().values()) or \
                router.timings():
            raise SystemExit(f"routing left load {router.outstanding()} or "
                             f"timed {router.timings()} kernels")
        log(f"H100 health under its measured times: "
            f"{health.get(h100, 'no observation')}; flagged "
            f"{[short[m] for m in router.health.needs_recalibration()]}; "
            f"measured ÷ predicted "
            + ", ".join(f"{o['kernel']} {o['ratio']:.3g}" for o in observed))
        out["routing"] = {
            "seconds": route_s, "timings": router.timings(),
            "decisions": placed, "on_card": observed,
            "health": {short[m]: h for m, h in health.items()},
            "flagged": [short[m]
                        for m in router.health.needs_recalibration()]}

        # (c) close the loop on the card
        routing_calls = {m: router.session(m).timer.calls
                         for m in router.machines}
        t0 = time.perf_counter()
        fresh = router.recalibrate(h100, None, tags=STUDY_TAGS, trials=3,
                                   cache=None)
        recal_s = time.perf_counter() - t0
        others = {m: router.session(m).timer.calls for m in router.machines
                  if m != h100}
        if fresh.profile.fingerprint.id != h100 or \
                router.session(h100) is not fresh or \
                router.health.state(h100).n_obs or \
                router.health.needs_recalibration() or \
                any(routing_calls.values()) or any(others.values()):
            raise SystemExit(f"recalibration: fingerprint "
                             f"{fresh.profile.fingerprint.id}, routing "
                             f"timer calls {routing_calls} / {others}")
        gmre = {}
        for run, prof in (("phase6", studies.load_profiles_any(
                fleet_paths[0])[0]), ("recalibrated", fresh.profile)):
            acc = studies.profile_accuracy(prof)
            gmre[run] = {rung: gmre_of(acc[rung]) for rung in ZOO}
        again = router.route_batch(list(items.values()), names=list(items),
                                   dispatch=False)
        out["recalibration"] = {
            "seconds": recal_s, "timings": fresh.timer.calls,
            "holdout_gmre": gmre,
            "placements_after": {n: short[d.machine]
                                 for n, d in zip(items, again)}}
        log(f"recalibrated the card in {recal_s:.2f} s "
            f"({fresh.timer.calls} timings); held-out gmre "
            + "; ".join(f"{rung} {gmre['recalibrated'][rung]:.2%} (phase 6 "
                        f"{gmre['phase6'][rung]:.2%})" for rung in ZOO)
            + f"; placements after: {sum(d.machine == h100 for d in again)}"
            f" of {len(again)} on the card")
    finally:
        router.close()

    # (d) the fleet CLI's gates and the two benches
    out["fleet_cli"] = {}
    for argv in (["simulate", "--synthetic", "4", "--jobs", "120",
                  "--expect-zero-timings"],
                 ["health", "--synthetic", "4", "--degrade-factor", "4",
                  "--recalibrate"]):
        rc, text, seconds = echo_run(fleet_main, argv)
        if rc != 0:
            raise SystemExit(f"fleet {argv[0]} exited {rc}")
        out["fleet_cli"][argv[0]] = {"seconds": seconds}
    out["serve_bench"] = {}
    for label, prof in (("synthetic", None),
                        ("h100_profile", load_profile(profile_path))):
        res = serve_bench.serve_bench(prof)
        if res["timings"]:
            raise SystemExit(f"serve_bench timed {res['timings']} kernels")
        out["serve_bench"][label] = res
        for row in serve_bench.rows(res):
            print(f"serve_bench[{label}] {row}", flush=True)
    res = fleet_bench.fleet_bench()
    if res["route_timings"] or res["sim_timings"]:
        raise SystemExit(f"fleet_bench timed kernels: {res}")
    out["fleet_bench"] = res
    for row in fleet_bench.rows(res):
        print(f"fleet_bench {row}", flush=True)
    return out


def zoo_path(calibrate_main, load_profile, PerfSession, f32, ops, tmp):
    """Phase 6-7's predictions: the zoo study on the card and on the
    synthetic device apex, ``compare --sweep``, and each kernel's
    real-size prediction from the card's profile with each rung.
    Returns {kernel: {rung: seconds}}."""
    import functools
    import torch
    h100 = tmp / "h100_zoo.json"
    apex = tmp / "apex_zoo.json"
    t0 = time.perf_counter()
    rc = calibrate_main(["--zoo", "--trials", "3", "--out", str(h100),
                         "--device", "cuda"])
    if rc != 0:
        raise SystemExit(f"zoo calibration exited {rc}")
    log(f"zoo study on the card took {time.perf_counter() - t0:.1f} s")
    if calibrate_main(["--zoo", "--synthetic", "apex", "--trials", "3",
                       "--out", str(apex)]) != 0:
        raise SystemExit("synthetic zoo calibration failed")
    profile = load_profile(h100)
    if profile.fingerprint.device_kind != torch.cuda.get_device_name(0):
        raise SystemExit(f"zoo profile fingerprint {profile.fingerprint}")
    if len(profile.kernel_names) != 18 or sorted(profile.fits) != \
            sorted(ZOO) or not len(profile.holdout):
        raise SystemExit(f"zoo profile: {len(profile.kernel_names)} "
                         f"kernels, fits {sorted(profile.fits)}")
    for name, mf in profile.fits.items():
        if not all(math.isfinite(v) for v in mf.params.values()):
            raise SystemExit(f"zoo fit {name} not finite: {mf.params}")
    if calibrate_main(["compare", str(h100), str(apex), "--sweep",
                       "--json", str(tmp / "compare.json")]) != 0:
        raise SystemExit("compare failed")

    items = zoo_items(ops, f32)
    session = PerfSession.open(h100)
    preds = {name: {} for name in items}
    for rung in ZOO:
        batch = session.predict_batch(list(items.values()), model=rung,
                                      names=list(items))
        for p in batch:
            if not (math.isfinite(p.seconds) and p.seconds > 0):
                raise SystemExit(f"{rung} prediction {p.kernel}: "
                                 f"{p.seconds}")
            preds[p.kernel][rung] = p.seconds
    if session.timer.calls != 0:
        raise SystemExit(f"zoo prediction timed {session.timer.calls} "
                         f"kernels")
    log(f"zoo prediction: {len(items)} kernels × {len(ZOO)} rungs, "
        f"timings_performed={session.timer.calls} "
        f"batched_evals={session.eval_calls}")
    return preds


class KernelRecorder:
    """Wraps the model-layer wrappers of ``ops`` (the models call them
    through the module) and keeps the first call of each, attention's
    first call with a window and its first without (gemma2's local and
    global layers): its arguments and its result, on the card.  Counts
    nothing: the launch counters stay the kernels' own."""

    NAMES = ("flash_attention", "mamba2_ssd", "mamba2_ssd_state",
             "slstm_cell", "slstm_cell_state")

    def __init__(self, ops):
        self.ops, self.first = ops, {}
        self.real = {name: getattr(ops, name) for name in self.NAMES}

    def __enter__(self):
        for name, fn in self.real.items():
            setattr(self.ops, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.ops, name, fn)

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            key = name
            if name == "flash_attention":
                key = (name, kwargs.get("window") is None)
            self.first.setdefault(key, (name, args, kwargs, out))
            return out
        return call


def attention_excess(got, want, rtol, row_atol, floor=0.0) -> float:
    """How far bf16 attention ``got`` (or its gradient) lies from ``want``
    (float64, not rounded), in units of the tolerance: the worst element
    under |got − want| <= rtol·|want| + row_atol·rms(want's row) +
    floor·max |want|.  The row's rms is the scale of the error of a
    probability-weighted sum of values with the probabilities rounded to
    bf16; a fixed atol would be the size of a typical output over
    thousands of keys.  The floor is for gradient rows whose exact value
    cancels to about zero.  An element equal to ``want`` passes, also
    where the tolerance is 0; NaN fails."""
    got, want = got.double(), want.double()
    rms = want.square().mean(dim=-1, keepdim=True).sqrt()
    diff = (got - want).abs()
    ratio = diff / (rtol * want.abs() + row_atol * rms
                    + floor * want.abs().max())
    return float(ratio.where(diff != 0, diff.new_zeros(())).max())


def check_recorded(first, ref) -> dict:
    """Phase 15 (b): each kernel's first call in a served model against
    its plain version on the same card tensors, computed in float64 and
    not rounded back — attention in bf16 at ``LM_ATTN_BF16_TOL`` (its
    first local and first global call), the SSD and the sLSTM (and
    their final states) at the f32 tolerance.  Returns max |err| per
    kernel and output."""
    import torch
    errs = {}

    def hold(label, got, want, tol, worst=None):
        if worst is None:
            worst = excess(got, want, **tol)
        err = float((got.double() - want.double()).abs().max())
        log(f"  {label}: max|err| {err:.3g}, worst {worst:.3g}× {tol}")
        if not worst <= 1:
            raise SystemExit(f"{label} on the model's inputs disagrees with "
                             f"its plain version ({worst:.3g}× {tol})")
        errs[label] = err

    for name, args, kw, out in first.values():
        if name == "flash_attention":
            q = args[0]
            want = torch.cat([   # one batch row at a time: S² scores in f64
                ref.attention_ref(
                    *(t[i:i + 1].double() for t in args),
                    causal=kw["causal"], window=kw["window"],
                    softcap=kw["softcap"], scale=kw["scale"])
                for i in range(q.shape[0])])
            label = (f"flash_attention {tuple(q.shape)} {q.dtype} window "
                     f"{kw['window']}")
            if q.dtype == torch.float32:
                hold(label, out, want, TOL["float32"])
            else:
                hold(label, out, want, LM_ATTN_BF16_TOL,
                     attention_excess(out, want, **LM_ATTN_BF16_TOL))
            del want
            continue
        wide = tuple(t.double() for t in args)
        if name == "mamba2_ssd_state":
            y, state = ref.ssd_state_ref(*wide)
            hold(f"mamba2_ssd {tuple(args[0].shape)} y", out[0], y,
                 TOL["float32"])
            hold("mamba2_ssd final state", out[1], state, TOL["float32"])
        elif name == "mamba2_ssd":
            hold(f"mamba2_ssd {tuple(args[0].shape)} y", out,
                 ref.ssd_ref(*wide), TOL["float32"])
        elif name == "slstm_cell_state":
            h, cnm = ref.slstm_cell_state_ref(*wide)
            hold(f"slstm_cell {tuple(args[0].shape)} h", out[0], h,
                 TOL["float32"])
            for label, got, want in zip("cnm", out[1], cnm):
                hold(f"slstm_cell final {label}", got, want, TOL["float32"])
        elif name == "slstm_cell":
            hold(f"slstm_cell {tuple(args[0].shape)} h", out,
                 ref.slstm_cell_ref(*wide), TOL["float32"])
    return errs


def whole_model_config(configs, arch):
    """Full width, f32, the smallest depth with every block kind:
    gemma2 a local and a global layer, zamba2 one prefix Mamba-2 block, a
    group of two and the shared attention, xlstm an mLSTM and an sLSTM.
    gemma2's window is cut to half the prompt, so its local layer
    prefills into its ring buffer and decodes from it, and its attention
    softcap to ``LM_WHOLE_SOFTCAP``, so the cap bends scores of O(1)."""
    cfg = configs.get_config(arch).replace(param_dtype="float32",
                                           activation_dtype="float32")
    if arch == "gemma2-9b":
        return cfg.replace(num_layers=2, attention=cfg.attention.replace(
            window=LM_WHOLE_PROMPT // 2, logit_softcap=LM_WHOLE_SOFTCAP))
    if arch == "zamba2-7b":
        return cfg.replace(num_layers=3, prefix_blocks=("mamba2",),
                           block_pattern=("mamba2",) * 2,
                           shared_attn_every=2)
    return cfg.replace(num_layers=2)


def whole_model_check(lm, tree_map, launch_counts, cfg, arch, dev) -> dict:
    """Phase 15 (c): the same weights (drawn on the card, copied to the
    host) served on the card through the kernels and on the host through
    their plain versions, the same prompt and teacher-forced decode
    tokens; then the card's prefill-then-decode against its full
    forward.  Returns the relative differences."""
    import torch
    S, D = LM_WHOLE_PROMPT, LM_WHOLE_DECODE
    gen = torch.Generator(device=dev).manual_seed(22)
    with torch.inference_mode():
        params = lm.init(gen, cfg, dev)
        tokens = torch.randint(0, cfg.vocab_size, (1, S + D), generator=gen,
                               device=dev)

        def serve_on(p, toks, device):
            cache = lm.zero_cache(cfg, 1, S + D, device)
            cache, lg = lm.prefill(p, cfg, cache, {"tokens": toks[:, :S]})
            outs = [lg[:, 0]]
            for i in range(D):
                cache, lg = lm.decode_step(p, cfg, cache,
                                           toks[:, S + i: S + i + 1], S + i)
                outs.append(lg[:, 0])
            return outs

        before = launch_counts()
        card = serve_on(params, tokens, dev)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        host_params = tree_map(lambda t: t.cpu(), params)
        t0 = time.perf_counter()
        host = serve_on(host_params, tokens.cpu(), torch.device("cpu"))
        host_s = time.perf_counter() - t0
        del host_params
        rel = [float((c.cpu().double() - h.double()).abs().max()
                     / h.double().abs().max()) for c, h in zip(card, host)]
        # the card's own invariant: prefill S − 1, decode token S − 1
        full, _, _ = lm.forward(params, cfg, {"tokens": tokens[:, :S]})
        cache = lm.zero_cache(cfg, 1, S, dev)
        cache, _ = lm.prefill(params, cfg, cache,
                              {"tokens": tokens[:, :S - 1]})
        _, dec = lm.decode_step(params, cfg, cache, tokens[:, S - 1:S],
                                S - 1)
        want = full[:, -1].double()
        invariant = float((dec[:, 0].double() - want).abs().max()
                          / want.abs().max())
        finite = all(bool(torch.isfinite(c).all()) for c in card)
    del params, full, cache
    torch.cuda.empty_cache()
    log(f"{arch} whole model ({cfg.num_layers} layers, f32, prompt {S}): "
        f"card kernels {launched}; card vs host rel |Δlogit| prefill "
        f"{rel[0]:.3g}, decode " + " ".join(f"{r:.3g}" for r in rel[1:])
        + f" (host {host_s:.1f} s); card prefill S−1 + decode vs forward "
        f"{invariant:.3g}")
    if not finite or not max(rel) < LM_WHOLE_REL:
        raise SystemExit(f"{arch}: card and host logits differ: {rel}")
    if not invariant < LM_SERVING_TOL[arch]:
        raise SystemExit(f"{arch}: decode after prefill is {invariant:.3g} "
                         f"off the full forward on the card")
    expect = {k: int(v > 0) for k, v in LM_PREFILL_LAUNCHES[arch].items()}
    if {k: int(v > 0) for k, v in launched.items()} != expect:
        raise SystemExit(f"{arch}: the card's run launched {launched}")
    return {"layers": cfg.num_layers, "prompt": S, "decode_steps": D,
            "card_vs_host_rel": rel, "host_s": host_s,
            "invariant_rel": invariant, "card_launches": launched}


def lm_path(serve_main, lm, counting, InputShape, tree_map, configs, ops,
            ref, launch_counts, zero_counts, dev) -> dict:
    """Phase 15: the port's language models served on the card.  For each
    of ``LM_SERVED``: (a) ``python -m repro_torch.launch.serve`` in
    process (one warm-up request, then prefill and 15 decode steps timed
    between CUDA events), the launches of each hand kernel in prefill
    (exactly ``LM_PREFILL_LAUNCHES``) and decode (none), the counters set
    to 0 before and read after (warm-up and timed request: twice a
    prefill's); (b) each kernel's first call held against its plain
    version (:func:`check_recorded`); (c) the whole model at a small
    depth, card against host (:func:`whole_model_check`).  Bounds: decode
    = the parameters' bytes once ÷ 3.35 TB/s, prefill = (model + attention
    FLOPs) ÷ 989 TFLOP/s."""
    import torch
    out = {}
    for arch, layers, batch, prompt in LM_SERVED:
        t0 = time.perf_counter()
        argv = ["--arch", arch, "--batch", str(batch), "--prompt-len",
                str(prompt), "--tokens", str(LM_TOKENS)]
        if layers is not None:
            argv += ["--num-layers", str(layers)]
        zero_counts()
        with KernelRecorder(ops) as rec:
            rc, text, seconds = echo_run(serve_main, argv)
        total = launch_counts()
        if rc != 0:
            raise SystemExit(f"serve {arch} exited {rc}")
        res = json.loads(text.strip().splitlines()[-1])["serve"]
        want = LM_PREFILL_LAUNCHES[arch]
        if res["launches"]["prefill"] != want \
                or any(res["launches"]["decode"].values()) \
                or total != {k: 2 * v for k, v in want.items()}:
            raise SystemExit(f"{arch}: launches prefill "
                             f"{res['launches']['prefill']}, decode "
                             f"{res['launches']['decode']}, in all {total}; "
                             f"a prefill should launch {want}")
        if not res["logits_finite"]:
            raise SystemExit(f"{arch}: served logits not finite")
        res["launches_run"] = total   # warm-up and timed request
        cfg = configs.get_config(arch)
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        shape = InputShape("served", prompt, batch, "prefill")
        flops = counting.model_flops(cfg, shape) \
            + counting.attention_flops(cfg, shape)
        res["prefill_bound_ms"] = flops / PEAK_BF16_FLOPS * 1e3
        res["decode_bound_ms"] = res["param_bytes"] / PEAK_HBM_BYTES * 1e3
        res["layers"] = cfg.num_layers
        res["serve_s"] = seconds
        log(f"{arch} ({cfg.num_layers} layers, {res['params'] / 1e9:.3f} B "
            f"params, batch {batch}, prompt {prompt}): prefill "
            f"{res['prefill_ms']:.4g} ms (bound {res['prefill_bound_ms']:.4g}"
            f" ms, {res['prefill_tokens_per_s']:.0f} tok/s), decode "
            f"{res['decode_ms_per_token']:.4g} ms/token (bound "
            f"{res['decode_bound_ms']:.4g} ms, "
            f"{res['decode_tokens_per_s']:.1f} tok/s), peak "
            f"{res.get('max_memory_allocated', 0) / 2**30:.2f} GiB; launches "
            f"prefill {res['launches']['prefill']}, decode "
            f"{res['launches']['decode']}")
        res["kernel_checks"] = check_recorded(rec.first, ref)
        del rec
        torch.cuda.empty_cache()
        res["whole_model"] = whole_model_check(
            lm, tree_map, launch_counts, whole_model_config(configs, arch),
            arch, dev)
        res["seconds"] = time.perf_counter() - t0
        log(f"{arch} took {res['seconds']:.1f} s")
        out[arch] = res
    return out


def visible_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs attention's mask keeps: query i sees keys
    [max(0, i − window + 1) with a window, min(Skv, i + 1) when causal)."""
    total = 0
    for i in range(sq):
        lo = max(0, i - window + 1) if window is not None else 0
        hi = min(skv, i + 1) if causal else skv
        total += max(0, hi - lo)
    return total


def attention_bwd_bound_ms(B, Sq, Skv, Hq, Hkv, D, Dv, causal, window,
                           dtype) -> tuple:
    """The backward's bound: the vjp's five products over the visible
    pairs, 2·(3·D + 2·Dv) operations each, at the dtype's peak (bf16
    tensor cores, f32 FMA), against every byte of q, k, v, o, dO, lse,
    dq, dk, dv once.  Returns (ms, "operations" or "bytes")."""
    import torch
    ops_n = (2 * B * Hq * visible_pairs(Sq, Skv, causal, window)
             * (3 * D + 2 * Dv))
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * 2 * (B * Sq * Hq * (D + 2 * Dv)
                          + B * Skv * Hkv * (D + Dv)) + 4 * B * Hq * Sq
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = ops_n / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


#: seconds a pass trace (:func:`pass_ms`) keeps clear of other device
#: work on each side of its calls, so that every kernel it holds under a
#: pass's name is a launch of those calls
TRACE_MARGIN_S = 0.25


def traced(call, kernels, launched, reps: int = 10) -> tuple:
    """``reps`` calls of ``call()`` in a ``torch.profiler`` trace,
    ``TRACE_MARGIN_S`` clear of other device work on both sides, after a
    warm-up cycle of the profiler (one call, traced and dropped): how
    much ``launched()`` rose, and per pass (``kernels``: (pass, name
    fragment) pairs) the microseconds of each of its kernels the trace
    holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        call()
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
        prof.step()
        time.sleep(TRACE_MARGIN_S)
        before = launched()
        for _ in range(reps):
            call()
        rose = launched() - before
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
        prof.step()
    found = {name: [] for name, _ in kernels}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, key in kernels:
            if key in ev.name:
                found[name].append(ev.time_range.elapsed_us())
    return rose, found


def pass_ms(call, kernels, what: str, launched, reps: int = 10) -> dict:
    """Each pass ``call()`` launches: its kernel's device milliseconds a
    launch (``kernels``: (pass, name fragment) pairs), from a
    :func:`traced` run of ``reps`` calls.  ``launched()`` (the wrapper's
    count) rises by one for each call, which launches every pass once, so
    the trace must hold each pass exactly ``reps`` times: fails unless
    ``launched()`` rose by exactly ``reps`` and it does.  Late in a long
    process a trace has held only some of them (the SSD backward's 6 and
    7 of 10 after a ``torch.compile``'d ``flex_attention`` backward and
    many other traces: ``tools/trace_loss_probe.py``), so the smoke takes
    its traces in a fresh process (:func:`pass_ms_in_child`)."""
    rose, found = traced(call, kernels, launched, reps)
    held = {name: len(f) for name, f in found.items()}
    if rose != reps or any(n != reps for n in held.values()):
        raise SystemExit(f"{what}: {reps} traced calls counted {rose} "
                         f"launches and the trace holds {held} pass "
                         f"kernels")
    log(f"{what}: {reps} calls launched, the trace holds {held} of their "
        f"pass kernels")
    return {name: sum(f) / len(f) / 1e3 for name, f in found.items()}


def pass_ms_in_child(kind: str) -> dict:
    """:func:`pass_ms` of phase 16 (a)'s attention backward (``kind``
    "attention") or phase 17 (a)'s SSD backward ("ssd") at the model's
    layer, in a fresh process of this script (``--pass-trace kind``, the
    same inputs from the same seeds): its profiler has run no trace and
    no ``torch.compile`` before.  Logs the child's lines; fails with its
    errors."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--pass-trace", kind], capture_output=True,
                          text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"[pass trace child] {line}")
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"{kind} pass trace: the child exited "
                         f"{proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(lines[-1])["pass_ms"]


def pass_trace_main(kind: str) -> int:
    """The child of :func:`pass_ms_in_child`: builds ``kind``'s backward
    call as phase 16 (a) or 17 (a) does and prints ``{"pass_ms": ...}``
    last."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke --pass-trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    dev = torch.device("cuda")
    if kind == "attention":
        label, B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, cap, qs = \
            ATTN_BWD_CASES[0]
        gen = torch.Generator(device=dev).manual_seed(16)
        q, k, v = attn_inputs(gen, dev, torch.bfloat16, B, Sq, Hq, Hkv, D,
                              qs)
        dout = torch.randn(B, Sq, Hq, Dv, generator=gen,
                           device=dev).to(torch.bfloat16)
        scale = 1.0 / math.sqrt(D)
        _, lse = fa.flash_attention_lse_cuda(q, k, v, causal, window, cap,
                                             scale)
        out = attention_bwd_pass_ms(lambda: fa.flash_attention_bwd_cuda(
            dout, q, k, v, lse, causal, window, cap, scale), fa)
    elif kind == "ssd":
        label, B, S, H, P, N, chunk, _ = SSD_BWD_CASES[0]
        gen = torch.Generator(device=dev).manual_seed(17)
        x, da, bm, cm = ssd_inputs(gen, dev, B, S, H, P, N)
        dy = torch.randn(B, S, H, P, generator=gen, device=dev)
        out = ssd_bwd_pass_ms(lambda: ssd.mamba2_ssd_bwd_cuda(
            x, da, bm, cm, dy, chunk), ssd)
    else:
        print(f"chip_smoke --pass-trace: unknown {kind!r}", file=sys.stderr)
        return 2
    print(json.dumps({"pass_ms": out}), flush=True)
    return 0


def attention_bwd_pass_ms(backward, fa, reps: int = 10) -> dict:
    """Each pass of the bf16 backward ``backward()`` launches on the
    wgmma route, from a profiler trace (:func:`pass_ms`)."""
    return pass_ms(backward, ATTN_BWD_PASS_KERNELS, "attention backward",
                   lambda: fa.bwd_routes()["wgmma"], reps)


def ssd_bwd_pass_ms(backward, ssd, reps: int = 10) -> dict:
    """The chained-scan route's two passes (F, the states; R, the state
    gradients and each chunk's gradients) of the SSD backward
    ``backward()``, from a profiler trace (:func:`pass_ms`)."""
    return pass_ms(backward, SSD_BWD_PASS_KERNELS, "SSD backward",
                   lambda: ssd.bwd_route_launches["chain"], reps)


def check_attention_backward(ops, ref, fa, dev) -> dict:
    """Phase 16 (a): the attention backward kernel (through
    ``ops.flash_attention`` under autograd: the forward kernel keeping
    lse, then the backward kernel) against the plain version's autograd
    in float64 on the same inputs, for every ``ATTN_BWD_CASES`` case in
    f32 (max |err| <= ``ATTN_BWD_F32_REL`` × max |g| of each of dq, dk,
    dv) and bf16 (:func:`attention_excess` at ``ATTN_BWD_BF16_TOL``), a
    second run bit for bit the first, and in bf16 through the route of
    ``ATTN_BWD_ROUTES`` (the kernel's count); then gemma2-9b's global
    layer in bf16 timed: the backward alone and each of its passes
    (:func:`attention_bwd_pass_ms`), the forward with lse, forward + backward, the plain vjp, the
    ``torch.compile``'d ``flex_attention`` forward alone and forward +
    backward (their difference the library's backward), the bound and
    the backward's TFLOP/s on the vjp's five products.  Launches here
    count nowhere."""
    import functools

    import torch
    out = {"cases": {}}
    for (label, B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, cap, qs), \
            route in zip(ATTN_BWD_CASES, ATTN_BWD_ROUTES):
        kw = dict(causal=causal, window=window, softcap=cap)
        gen = torch.Generator(device=dev).manual_seed(16)
        base = (torch.randn(B, Sq, Hq, D, generator=gen, device=dev) * qs,
                torch.randn(B, Skv, Hkv, D, generator=gen, device=dev),
                torch.randn(B, Skv, Hkv, Dv, generator=gen, device=dev),
                torch.randn(B, Sq, Hq, Dv, generator=gen, device=dev))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = (t.to(dtype) for t in base)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            routes = fa.bwd_routes()
            t0 = time.perf_counter()
            o = ops.flash_attention(*leaves, block_q=Sq, block_k=Skv, **kw)
            got = torch.autograd.grad(o, leaves, dout)
            torch.cuda.synchronize()
            kernel_s = time.perf_counter() - t0
            taken = {r: n - routes[r] for r, n in fa.bwd_routes().items()}
            again = torch.autograd.grad(
                ops.flash_attention(*leaves, block_q=Sq, block_k=Skv, **kw),
                leaves, dout)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            wide = [t.double().requires_grad_() for t in (q, k, v)]
            want = torch.autograd.grad(
                ref.attention_ref(*wide, **kw), wide, dout.double())
            del wide
            row = {}
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                err = float((g.double() - w).abs().max())
                if dtype == torch.float32:
                    worst = err / (ATTN_BWD_F32_REL * float(w.abs().max()))
                else:
                    worst = attention_excess(g, w, **ATTN_BWD_BF16_TOL)
                row[name] = {"max_abs_err": err, "worst": worst}
            del want, got, o, leaves
            torch.cuda.empty_cache()
            tag = f"{label} {str(dtype).split('.')[1]}"
            log(f"attention backward {tag} ([{B}, {Sq}/{Skv}, {Hq}/{Hkv}, "
                f"{D}/{Dv}] {kw}, kernel {kernel_s:.2f} s, routes {taken}, "
                f"second run bit for bit: {same}): " + ", ".join(
                    f"{n} max|err| {r['max_abs_err']:.3g} worst "
                    f"{r['worst']:.3g}×" for n, r in row.items()))
            bad = [n for n, r in row.items() if not r["worst"] <= 1]
            if bad:
                raise SystemExit(f"attention backward {tag}: {bad} outside "
                                 f"the tolerance: {row}")
            if not same:
                raise SystemExit(f"attention backward {tag}: two runs on "
                                 f"the same inputs differ")
            want_routes = {r: int(dtype == torch.bfloat16 and r == route)
                           for r in taken}
            if taken != want_routes:
                raise SystemExit(f"attention backward {tag}: routes "
                                 f"{taken}, want {want_routes}")
            out["cases"][tag] = dict(row, bitwise=same, routes=taken)

    # the main path's layer, timed
    label, B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, cap, qs = \
        ATTN_BWD_CASES[0]
    kw = dict(causal=causal, window=window, softcap=cap)
    scale = 1.0 / math.sqrt(D)
    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v = attn_inputs(gen, dev, torch.bfloat16, B, Sq, Hq, Hkv, D, qs)
    dout = torch.randn(B, Sq, Hq, Dv, generator=gen,
                       device=dev).to(torch.bfloat16)
    o, lse = fa.flash_attention_lse_cuda(q, k, v, causal, window, cap, scale)

    def backward():
        return fa.flash_attention_bwd_cuda(dout, q, k, v, lse, causal,
                                           window, cap, scale)

    passes = pass_ms_in_child("attention")

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def ours():
        return torch.autograd.grad(
            ops.flash_attention(*leaves, block_q=Sq, block_k=Skv, **kw),
            leaves, dout)

    flex = flex_library(kw, Sq, dev)
    lib_leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def library():
        return torch.autograd.grad(flex(*lib_leaves), lib_leaves, dout)

    def library_forward():
        with torch.no_grad():
            return flex(q, k, v)

    bound, bound_by = attention_bwd_bound_ms(B, Sq, Skv, Hq, Hkv, D, Dv,
                                             causal, window, torch.bfloat16)
    five = (2 * B * Hq * visible_pairs(Sq, Skv, causal, window)
            * (3 * D + 2 * Dv))
    t0 = time.perf_counter()
    library()   # compiles
    library_forward()
    compile_s = time.perf_counter() - t0
    timed = {"ms": time_ms(backward), "passes_ms": passes,
             "forward_lse_ms": time_ms(fa.flash_attention_lse_cuda, q, k, v,
                                       causal, window, cap, scale),
             "fwd_bwd_ms": time_ms(ours),
             "plain_ms": time_ms(functools.partial(ref.attention_bwd_ref,
                                                   **kw), dout, q, k, v,
                                 iters=3),
             "library_ms": time_ms(library),
             "library_fwd_ms": time_ms(library_forward),
             "bound_ms": bound, "bound_by": bound_by,
             "library": "torch.compile(flex_attention) forward + backward",
             "shape": [B, Sq, Hq, Hkv, D], "options": kw}
    timed["library_bwd_ms"] = timed["library_ms"] - timed["library_fwd_ms"]
    timed["tflops"] = five / (timed["ms"] * 1e-3) / 1e12
    log(f"attention backward {label} bf16: {timed['ms']:.4g} ms = "
        f"{bound / timed['ms']:.1%} of its bound ({bound:.4g} ms by "
        f"{bound_by}), {timed['tflops']:.4g} TFLOP/s on the five products' "
        f"{five / 1e9:.4g} GFLOP; passes " + ", ".join(
            f"{n} {t:.4g} ms" for n, t in passes.items()) +
        f"; forward with lse {timed['forward_lse_ms']:.4g} ms, "
        f"forward + backward {timed['fwd_bwd_ms']:.4g} ms against "
        f"flex_attention's {timed['library_ms']:.4g} ms (its forward "
        f"{timed['library_fwd_ms']:.4g}, so its backward "
        f"{timed['library_bwd_ms']:.4g} ms; compiled in {compile_s:.1f} "
        f"s); plain vjp {timed['plain_ms']:.4g} ms")
    out["timed"] = timed
    del flex, lib_leaves, leaves, o, lse
    torch.cuda.empty_cache()
    return out


def train_path(Trainer, make_run_config, InputShape, OptimizerConfig,
               configs, counting, tree_leaves, counts, zero_counts, dev,
               tmp, *, arch, layers, batch, steps, launches,
               routes=None) -> dict:
    """Phase 16 (b) and 17 (b): ``arch`` at full width (cut to ``layers``
    when not None) trained for ``steps`` steps at seq ``TRAIN_SEQ`` and
    global batch ``batch`` in its preset's microbatches through
    ``Trainer.train`` on the card; the counters set to 0 before and read
    after, each of ``launches``' kernels exactly its count a step, and
    where ``routes`` (a read of route counts, their counts a step) is
    given, each route exactly its count a step.  Per
    step: wall s, tokens/s, loss, grad_norm, lr, and the step's share of
    its bound — the work it needs (6·N·tokens + attention forward and
    backward, ``models.counting``) and with remat's recompute (8·N·tokens
    + 4/3 of attention), over 989 TFLOP/s.  Peak memory over the run."""
    import torch
    cfg = configs.get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    run = make_run_config(arch, "train_4k", model_config=cfg)
    shape = InputShape("train_4k_cut", TRAIN_SEQ, batch, "train")
    run = run.replace(shape=shape, checkpoint_every=0,
                      checkpoint_dir=str(tmp / f"train_ckpt_{arch}"),
                      optimizer=OptimizerConfig(learning_rate=1e-3,
                                                warmup_steps=1,
                                                total_steps=100))
    flops = counting.model_flops(cfg, shape)
    attn = counting.attention_flops(cfg, shape)
    bound_ms = (flops + attn) / PEAK_BF16_FLOPS * 1e3
    remat_bound_ms = (flops * 8 / 6 + attn * 4 / 3) / PEAK_BF16_FLOPS * 1e3
    t0 = time.perf_counter()
    trainer = Trainer(run, device=dev)
    state = trainer.init_state(run.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = sum(p.numel() for p in tree_leaves(state.params))
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    routes_before = routes[0]() if routes else {}
    state = trainer.train(state, steps, log_every=0)
    torch.cuda.synchronize()
    launched = {name: counts()[name] for name in launches}
    taken = ({r: n - routes_before[r] for r, n in routes[0]().items()}
             if routes else {})
    want_routes = ({r: n * steps for r, n in routes[1].items()}
                   if routes else {})
    peak = torch.cuda.max_memory_allocated(dev)
    rows = [r for r in trainer.metrics_log if "loss" in r]
    tokens = TRAIN_SEQ * batch
    for r in rows:
        r["tokens_per_s"] = tokens / r["wall_s"]
        r["share_of_bound"] = bound_ms / (r["wall_s"] * 1e3)
        log(f"{arch} train step {r['step']}: {r['wall_s']:.4g} s, "
            f"{r['tokens_per_s']:.0f} tok/s, loss {r['loss']:.5g}, "
            f"grad_norm {r['grad_norm']:.4g}, lr {r['lr']:.3g}, "
            f"{r['share_of_bound']:.1%} of its bound ({bound_ms:.4g} ms; "
            f"{remat_bound_ms:.4g} ms with remat's recompute)")
    want = {k: v * steps for k, v in launches.items()}
    log(f"{arch} ({cfg.num_layers} layers, {params / 1e9:.4g} B params, "
        f"seq {TRAIN_SEQ}, batch {batch} in {run.microbatches} "
        f"microbatches, remat {run.remat}): init {init_s:.1f} s, peak "
        f"{peak / 2**30:.2f} GiB, launches {launched} (want {want})"
        + (f", routes {taken} (want {want_routes})" if routes else ""))
    losses = [r["loss"] for r in rows]
    if len(rows) != steps or any(r.get("event") for r in
                                 trainer.metrics_log):
        raise SystemExit(f"training log: {trainer.metrics_log}")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise SystemExit(f"{arch}: losses {losses} are not finite and "
                         f"falling")
    if launched != want:
        raise SystemExit(f"{arch}: the steps launched {launched}, not "
                         f"{want}")
    if taken != want_routes:
        raise SystemExit(f"{arch}: the steps took the routes {taken}, not "
                         f"{want_routes}")
    del trainer, state
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.num_layers, "params": params,
            "seq": TRAIN_SEQ, "batch": batch,
            "microbatches": run.microbatches, "remat": run.remat,
            "moment_dtype": run.optimizer.moment_dtype, "steps": rows,
            "launches": launched, "launches_per_step": launches,
            "routes": taken,
            "peak_memory_bytes": peak, "bound_ms": bound_ms,
            "remat_bound_ms": remat_bound_ms, "init_s": init_s}


def fault_tolerance_path(Trainer, InputShape, OptimizerConfig, RunConfig,
                         configs, dev, tmp) -> dict:
    """Phase 16 (c): gemma2-9b's pattern at its smoke width (``FT_*``):
    one run with a failure injected after step ``FT_FAIL_AT + 1`` (the
    hook first waits for the step-``FT_FAIL_AT`` checkpoint, so the
    restore point is that step), one uninterrupted run; every step's
    loss must equal the uninterrupted run's bit for bit (or within
    ``FT_REL``, logged as not bit for bit), and one
    ``metrics_log`` row must say ``restored``."""
    import torch
    cfg = configs.get_smoke_config(TRAIN_ARCH)

    def run_for(name):
        return RunConfig(
            model=cfg, shape=InputShape("ft", FT_SEQ, FT_BATCH, "train"),
            optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=2,
                                      total_steps=100),
            microbatches=2, checkpoint_every=2,
            checkpoint_dir=str(tmp / name), max_step_retries=2)

    failing = {}

    def hook(step):
        if step == FT_FAIL_AT and not failing:
            failing["at"] = step
            trainer.ckpt.wait()
            return True
        return False

    trainer = Trainer(run_for("ft_fail"), failure_hook=hook, device=dev)
    trainer.train(trainer.init_state(0), FT_STEPS, log_every=0)
    trainer.ckpt.wait()
    clean = Trainer(run_for("ft_clean"), device=dev)
    clean.train(clean.init_state(0), FT_STEPS, log_every=0)
    clean.ckpt.wait()
    got = {r["step"]: r["loss"] for r in trainer.metrics_log if "loss" in r}
    want = {r["step"]: r["loss"] for r in clean.metrics_log if "loss" in r}
    events = [r for r in trainer.metrics_log if r.get("event") == "restored"]
    rel = {s: abs(got[s] - want[s]) / abs(want[s]) for s in want
           if s in got}
    exact = all(r == 0 for r in rel.values())
    log(f"fault tolerance ({TRAIN_ARCH} smoke, seq {FT_SEQ}): events "
        f"{events}; losses with the failure {got}; uninterrupted {want}; "
        f"relative differences {rel} ("
        + ("bit for bit" if exact else "not bit for bit: the runs differ "
           "run to run, before the failure too where a step's rel is not "
           "0 there") + ")")
    if len(events) != 1 or events[0]["step"] != FT_FAIL_AT:
        raise SystemExit(f"fault tolerance: restore events {events}")
    if set(got) != set(want) or not max(rel.values()) <= FT_REL:
        raise SystemExit("fault tolerance: the replayed losses differ from "
                         "the uninterrupted run's")
    return {"events": events, "losses": got, "uninterrupted": want,
            "relative_differences": rel, "bit_exact": exact}


def whole_train_check(lm, steps, adamw, SyntheticLMDataset, RunConfig,
                      InputShape, OptimizerConfig, tree_map, tree_leaves,
                      configs, counts, dev) -> dict:
    """Phase 16 (d): one train step of the whole model at full width
    (:func:`whole_model_config`: f32, a local and a global layer, the
    window cut to 128 and the attention softcap to 2, so both bite at
    seq 256), the same weights (drawn on the card, copied to the host)
    and batch, on the card through the kernels and on the host through
    their plain versions: loss, every gradient leaf and every parameter
    after the AdamW step (``TRAIN_WHOLE_*``); and the card's AdamW alone
    against the host's applied to the card's gradients, every parameter
    within ``TRAIN_WHOLE_PARAM_REL`` × max |p| with no allowance."""
    import torch
    cfg = whole_model_config(configs, TRAIN_ARCH)
    run = RunConfig(model=cfg, shape=InputShape("whole", LM_WHOLE_PROMPT, 1,
                                                "train"),
                    optimizer=OptimizerConfig(warmup_steps=1))
    loss_fn = steps.make_loss_fn(run)
    batch = SyntheticLMDataset(cfg, LM_WHOLE_PROMPT, 1, seed=16).batch_at(0)
    gen = torch.Generator(device=dev).manual_seed(16)
    with torch.no_grad():
        card_params = lm.init(gen, cfg, dev)
        host_params = tree_map(lambda t: t.to("cpu", copy=True),
                               card_params)
        host_before = tree_map(lambda t: t.to("cpu", copy=True),
                               card_params)

    def one_step(params, device):
        params = tree_map(lambda t: t.requires_grad_(), params)
        b = {k: torch.from_numpy(v).to(device, dtype=torch.long)
             for k, v in batch.items()}
        loss, _, grads = steps.value_and_grad(loss_fn, params, b)
        opt = adamw.init_opt_state(params, run.optimizer)
        _, _, metrics = adamw.apply_updates(params, grads, opt,
                                            run.optimizer)
        return float(loss), grads, params, float(metrics["lr"])

    names = ("flash_attention", "flash_attention_bwd")
    before = counts()
    card_loss, card_g, card_p, lr = one_step(card_params, dev)
    torch.cuda.synchronize()
    launched = {k: counts()[k] - before[k] for k in names}
    t0 = time.perf_counter()
    host_loss, host_g, host_p, _ = one_step(host_params, torch.device("cpu"))
    host_s = time.perf_counter() - t0
    card_g = tree_map(lambda g: g.cpu(), card_g)
    card_p = tree_map(lambda p: p.detach().cpu(), card_p)
    adamw.apply_updates(host_before, card_g,
                        adamw.init_opt_state(host_before, run.optimizer),
                        run.optimizer)
    loss_rel = abs(card_loss - host_loss) / abs(host_loss)
    grad_rel, param_worst, adamw_worst, flippable, total = 0.0, 0.0, 0.0, 0, 0
    for cg, hg, cp, hp, ap in zip(*map(tree_leaves, (
            card_g, host_g, card_p, host_p, host_before))):
        hp = hp.detach()
        gmax = float(hg.abs().max())
        grad_rel = max(grad_rel, float((cg - hg).abs().max())
                       / max(gmax, 1e-30))
        small = (hg.abs() < TRAIN_WHOLE_GRAD_REL * gmax) & (hg != 0)
        flippable += int(small.sum())
        total += hg.numel()
        pmax = float(hp.abs().max())
        tol = TRAIN_WHOLE_PARAM_REL * pmax + torch.where(small, 2 * lr, 0.0)
        param_worst = max(param_worst, float(((cp - hp).abs() / tol).max()))
        adamw_worst = max(adamw_worst, float((cp - ap).abs().max())
                          / (TRAIN_WHOLE_PARAM_REL * pmax))
    del card_params, card_g, card_p, host_before
    torch.cuda.empty_cache()
    log(f"{TRAIN_ARCH} whole model train step ({cfg.num_layers} layers, "
        f"f32, seq {LM_WHOLE_PROMPT}): card loss {card_loss:.8g}, host "
        f"{host_loss:.8g} (rel {loss_rel:.3g}); worst gradient leaf "
        f"{grad_rel:.3g} × its max |g|; parameters after AdamW worst "
        f"{param_worst:.3g}× the tolerance ({flippable} of {total} "
        f"elements with a nonzero |g| inside the gradient tolerance); the "
        f"card's AdamW against the host's on the card's gradients worst "
        f"{adamw_worst:.3g}× {TRAIN_WHOLE_PARAM_REL} × max |p|; card "
        f"launches {launched}; host {host_s:.1f} s")
    if not loss_rel <= TRAIN_WHOLE_LOSS_REL \
            or not grad_rel <= TRAIN_WHOLE_GRAD_REL or not param_worst <= 1 \
            or not adamw_worst <= 1:
        raise SystemExit(f"{TRAIN_ARCH} whole-model train step: card and "
                         f"host differ (loss {loss_rel:.3g}, gradients "
                         f"{grad_rel:.3g}, parameters {param_worst:.3g}×, "
                         f"AdamW {adamw_worst:.3g}×)")
    want = {"flash_attention": 2 * cfg.num_layers,
            "flash_attention_bwd": cfg.num_layers}
    if launched != want:
        raise SystemExit(f"whole-model train step launched {launched}, not "
                         f"{want}")
    return {"layers": cfg.num_layers, "seq": LM_WHOLE_PROMPT,
            "loss_rel": loss_rel, "grad_rel": grad_rel,
            "param_worst": param_worst, "adamw_worst": adamw_worst,
            "sign_free_elements": flippable,
            "elements": total, "card_launches": launched,
            "host_s": host_s}


def grad_excess(names, got, want) -> dict:
    """Per gradient (named by ``names``), its max |err| against the
    float64 ``want`` and that in units of ``ATTN_BWD_F32_REL`` × its max
    |g| (at most 1 passes)."""
    out = {}
    for name, g, w in zip(names, got, want):
        err = float((g.double() - w.double()).abs().max())
        out[name] = {"max_abs_err": err, "worst": err / (
            ATTN_BWD_F32_REL * float(w.double().abs().max()))}
    return out


def hold_gradients(tag, names, got, want, wrongs) -> dict:
    """Fail unless every gradient of ``got`` is within the tolerance of
    ``want``, and unless each plain variant in ``wrongs`` ((label,
    gradients) pairs) lies outside it in at least one gradient."""
    row = grad_excess(names, got, want)
    log(f"{tag}: " + ", ".join(f"{n} max|err| {r['max_abs_err']:.3g} worst "
                               f"{r['worst']:.3g}×" for n, r in row.items()))
    bad = [n for n, r in row.items() if not r["worst"] <= 1]
    if bad:
        raise SystemExit(f"{tag}: {bad} outside the tolerance: {row}")
    for label, wrong in wrongs:
        over = max(r["worst"] for r in grad_excess(names, got,
                                                   wrong).values())
        if over <= 1:
            raise SystemExit(f"{tag}: the check cannot fail: the plain "
                             f"variant '{label}' passes it too")
        log(f"  variant '{label}' fails the check (worst {over:.3g}× the "
            f"tolerance)")
    return row


def ssd_bwd_ops(B, S, H, P, N, chunk) -> int:
    """The SSD backward's needed operations at the kernel's chunk L: per
    chunk the five products over its L(L+1)/2 visible pairs (C·Bᵀ, dy·xᵀ
    over N and P; Mᵀ·dy, Qᵀ·C, Q·B) and four of L·P·N (the chunk's own
    state gradient, dy·S, x·G, B·Gᵀ)."""
    pairs = chunk * (chunk + 1) // 2
    return 2 * B * H * (S // chunk) * (pairs * (2 * P + 3 * N)
                                       + 4 * chunk * P * N)


def ssd_bwd_bound_ms(B, S, H, P, N, chunk) -> tuple:
    """The SSD backward's bound at the kernel's chunk L: its needed
    operations (:func:`ssd_bwd_ops`) at the rate of f32 products on the
    tensor cores — three TF32 products each (the error compensation both
    routes use), TF32 peak / 3 — against x, dt·A, B, C, dy in and dx,
    d(dt·A), dB, dC out, every byte once (the states the kernel
    recomputes are not needed work).  Returns (ms, "operations" or
    "bytes")."""
    t_ops = 3 * ssd_bwd_ops(B, S, H, P, N, chunk) / PEAK_TF32_FLOPS * 1e3
    t_bytes = 4 * B * S * H * (3 * P + 4 * N + 2) / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ssd_bwd_floors_ms(B, S, H, P, N, chunk) -> dict:
    """The chained-scan route's own floors at the kernel's chunk L:
    bytes, what its two passes move once — pass F reads x, dt·A and B and
    writes the state before each chunk, pass R reads x, dt·A, B, C, dy
    and the states and writes dx, d(dt·A), dB and dC — over 3.35 TB/s;
    products, the needed operations as three TF32 products each over the
    495 TFLOP/s of TF32; and, for comparison, the same operations at
    the f32 FMA peak."""
    nc = S // chunk
    state = 4 * B * nc * H * P * N
    tok = 4 * B * S * H
    nbytes = (tok * (P + N + 1) + state          # pass F
              + tok * (2 * P + 2 * N + 1) + state  # pass R reads
              + tok * (P + 2 * N + 1))             # and writes
    ops_n = ssd_bwd_ops(B, S, H, P, N, chunk)
    return {"bytes_ms": nbytes / PEAK_HBM_BYTES * 1e3,
            "products_ms": 3 * ops_n / PEAK_TF32_FLOPS * 1e3,
            "f32_fma_ms": ops_n / PEAK_F32_FLOPS * 1e3,
            "bytes": nbytes, "tf32_ops": 3 * ops_n}


def slstm_bwd_bound_ms(B, S, H, dh, clusters) -> tuple:
    """The sLSTM backward kernel's bound: the transposed recurrence
    R·dgg_t and dR's h_{t−1} ⊗ dgg_t, dh·4dh multiply-adds each a step,
    head and batch row, at f32 FMA, against traj, h and dy in and dgg
    out, every byte once, r once, and the ``clusters`` (a head's) partial
    sums of dR and db written once."""
    ops_n = 2 * 2 * B * S * H * dh * 4 * dh
    nbytes = 4 * (B * S * H * dh * (7 + 1 + 1 + 4) + H * dh * 4 * dh
                  + clusters * H * (dh * 4 * dh + 4 * dh))
    t_ops, t_bytes = ops_n / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mesh_train_path(Trainer, make_run_config, InputShape, OptimizerConfig,
                    configs, make_host_mesh, tree_leaves, counts,
                    zero_counts, smi, dev, tmp) -> dict:
    """Phase 18 (a): phase 16 (b)'s gemma2-9b run for ``MESH_STEPS``
    steps through ``Trainer.train`` without a mesh, then under
    ``make_host_mesh()`` (1 × 1, NCCL), from the same seed; the counters
    set to 0 before each run and read after it.  Fails unless the mesh's
    parameters and moments are DTensors, each run launched exactly
    ``TRAIN_STEP_LAUNCHES`` a step (DTensor dispatch did not route around
    the kernels), and every loss is within ``MESH_LOSS_REL`` of the
    mesh-less run's.  Logs the step times side by side (the DTensor
    overhead) with the card's name and power limit."""
    import torch
    from torch.distributed.tensor import DTensor
    cfg = configs.get_config(TRAIN_ARCH).replace(num_layers=TRAIN_LAYERS)
    run = make_run_config(TRAIN_ARCH, "train_4k", model_config=cfg)
    run = run.replace(
        shape=InputShape("train_4k_cut", TRAIN_SEQ, TRAIN_BATCH, "train"),
        checkpoint_every=0, checkpoint_dir=str(tmp / "mesh_train_ckpt"),
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                                  total_steps=100))
    mesh = make_host_mesh()
    want = {k: v * MESH_STEPS for k, v in TRAIN_STEP_LAUNCHES.items()}
    out = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        trainer = Trainer(run, mesh=m, device=dev)
        state = trainer.init_state(run.seed)
        dtensors = all(isinstance(t, DTensor) for t in
                       tree_leaves(state.params) + tree_leaves(
                           state.opt_state.mu) + tree_leaves(
                           state.opt_state.nu))
        torch.cuda.synchronize()
        zero_counts()
        state = trainer.train(state, MESH_STEPS, log_every=0)
        torch.cuda.synchronize()
        launched = {k: counts()[k] for k in TRAIN_STEP_LAUNCHES}
        rows = [r for r in trainer.metrics_log if "loss" in r]
        out[name] = {"losses": [r["loss"] for r in rows],
                     "wall_s": [r["wall_s"] for r in rows],
                     "launches": launched, "dtensors": dtensors}
        del trainer, state
        torch.cuda.empty_cache()
        if launched != want or len(rows) != MESH_STEPS:
            raise SystemExit(f"mesh ({name}): {len(rows)} steps launched "
                             f"{launched}, not {want}")
    if not out["mesh"]["dtensors"] or out["plain"]["dtensors"]:
        raise SystemExit("mesh: the meshed state is not all DTensors")
    rel = [abs(a - b) / abs(b) for a, b in zip(out["mesh"]["losses"],
                                               out["plain"]["losses"])]
    exact = out["mesh"]["losses"] == out["plain"]["losses"]
    for i, (p, q) in enumerate(zip(out["plain"]["wall_s"],
                                   out["mesh"]["wall_s"])):
        log(f"mesh gemma2-9b step {i + 1}: {q:.4g} s under the 1 × 1 mesh "
            f"beside {p:.4g} s without one ({q / p:.3f}×), loss "
            f"{out['mesh']['losses'][i]:.6g} vs "
            f"{out['plain']['losses'][i]:.6g} ({smi})")
    log(f"mesh gemma2-9b: losses {'bit for bit' if exact else 'not bit '}"
        f"{'' if exact else 'for bit: rel ' + str(rel)}; launches "
        f"{out['mesh']['launches']} (want {want}) under the mesh, "
        f"{out['plain']['launches']} without")
    if not max(rel) <= MESH_LOSS_REL:
        raise SystemExit(f"mesh: losses {out['mesh']['losses']} against "
                         f"{out['plain']['losses']}")
    out.update(mesh_shape=dict(zip(mesh.mesh_dim_names, mesh.shape)),
               relative_differences=rel, bit_exact=exact,
               step_ratio=sorted(q / p for p, q in zip(
                   out["plain"]["wall_s"], out["mesh"]["wall_s"]))[
                   MESH_STEPS // 2])
    return out


def mesh_checkpoint_path(Trainer, InputShape, OptimizerConfig, RunConfig,
                         configs, make_host_mesh, tree_leaves, dev,
                         tmp) -> dict:
    """Phase 18 (b), at gemma2-9b's smoke width (``FT_*``): under the 1 ×
    1 mesh, a run with a failure injected after step ``FT_FAIL_AT + 1``
    restores the step-``FT_FAIL_AT`` checkpoint under the mesh's
    placements and replays (its losses against an uninterrupted meshed
    run, bit for bit or within ``FT_REL``; the restored state DTensors);
    then a mesh-less run's state ``reshard``ed onto the mesh — every
    parameter and moment bit-equal — trains on."""
    import torch
    from torch.distributed.tensor import DTensor
    cfg = configs.get_smoke_config(TRAIN_ARCH)
    mesh = make_host_mesh()

    def run_for(name):
        return RunConfig(
            model=cfg, shape=InputShape("ft", FT_SEQ, FT_BATCH, "train"),
            optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=2,
                                      total_steps=100),
            microbatches=2, checkpoint_every=2,
            checkpoint_dir=str(tmp / name), max_step_retries=2)

    failing = {}

    def hook(step):
        if step == FT_FAIL_AT and not failing:
            failing["at"] = step
            trainer.ckpt.wait()
            return True
        return False

    trainer = Trainer(run_for("mesh_ft_fail"), mesh=mesh, failure_hook=hook)
    state = trainer.train(trainer.init_state(0), FT_STEPS, log_every=0)
    trainer.ckpt.wait()
    restored = all(isinstance(t, DTensor) for t in tree_leaves(state.params))
    clean = Trainer(run_for("mesh_ft_clean"), mesh=mesh)
    clean.train(clean.init_state(0), FT_STEPS, log_every=0)
    got = {r["step"]: r["loss"] for r in trainer.metrics_log if "loss" in r}
    want = {r["step"]: r["loss"] for r in clean.metrics_log if "loss" in r}
    events = [r for r in trainer.metrics_log if r.get("event") == "restored"]
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want if k in got}
    exact = all(r == 0 for r in rel.values())
    log(f"mesh fault tolerance ({TRAIN_ARCH} smoke): events {events}; "
        f"replayed losses {'bit for bit' if exact else rel}; restored "
        f"state DTensors: {restored}")
    if len(events) != 1 or events[0]["step"] != FT_FAIL_AT or not restored \
            or set(got) != set(want) or not max(rel.values()) <= FT_REL:
        raise SystemExit("mesh fault tolerance: the restore under the mesh "
                         "failed")
    plain = Trainer(run_for("reshard"), device=dev)
    state = plain.train(plain.init_state(0), 2, log_every=0)
    before = [t.detach().clone() for t in tree_leaves(state.params)
              + tree_leaves(state.opt_state.mu)
              + tree_leaves(state.opt_state.nu)]
    state = plain.reshard(state, mesh)
    after = tree_leaves(state.params) + tree_leaves(state.opt_state.mu) + \
        tree_leaves(state.opt_state.nu)
    equal = all(isinstance(b, DTensor) and torch.equal(a, b.full_tensor())
                for a, b in zip(before, after))
    state = plain.train(state, 4, log_every=0)
    losses = [r["loss"] for r in plain.metrics_log if "loss" in r]
    log(f"mesh reshard: {len(before)} leaves bit-equal across the reshard: "
        f"{equal}; losses {losses} (steps 3–4 under the mesh)")
    if not equal or state.step != 4 or not all(
            math.isfinite(x) for x in losses):
        raise SystemExit("mesh reshard: the state changed or training "
                         "stopped")
    return {"events": events, "replayed_bit_exact": exact,
            "relative_differences": rel, "reshard_bit_equal": equal,
            "reshard_losses": losses}


def moe_a2a_path(configs, init_tree, moe, moe_a2a, axes_tree, place,
                 make_host_mesh, use_mesh, smi, dev) -> dict:
    """Phase 18 (c): deepseek-v2-236b's MoE layer at full width
    (``MOE_*``), f32, ``moe_impl="a2a"``'s dispatch on the 1 × 1 mesh
    against the scatter on the same weights and tokens: within
    ``MOE_REL`` × max |y|, nothing dropped by either.  Each timed once
    between synchronizations (host clock)."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = configs.get_config(MOE_ARCH)
    cfg = cfg.replace(moe=cfg.moe.replace(capacity_factor=MOE_CAPACITY))
    m = cfg.moe
    gen = torch.Generator(device=dev).manual_seed(18)
    with torch.no_grad():
        p = init_tree(gen, moe.moe_schema(cfg), torch.float32, dev)
        x = torch.randn(*MOE_TOKENS, cfg.d_model, generator=gen, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_sc, aux_sc = moe.apply_moe(p, cfg, x)
        torch.cuda.synchronize()
        scatter_s = time.perf_counter() - t0
        mesh = make_host_mesh()
        pd = place(p, axes_tree(moe.moe_schema(cfg)), mesh)
        del p
        xd = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with use_mesh(mesh), implicit_replication():
            y, aux = moe_a2a.apply_moe_a2a(pd, cfg, xd)
        y = y.full_tensor()
        torch.cuda.synchronize()
        a2a_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        dropped = float(aux["moe_frac_dropped"].full_tensor())
        rel = float((y - y_sc).abs().max() / y_sc.abs().max())
    log(f"moe a2a {MOE_ARCH} (d_model {cfg.d_model}, {m.num_experts} routed "
        f"+ {m.num_shared_experts} shared experts of d_ff {m.d_ff_expert}, "
        f"top-{m.top_k}, {MOE_TOKENS[0]} × {MOE_TOKENS[1]} tokens, "
        f"capacity {MOE_CAPACITY}): max|a2a − scatter| = {rel:.3g} × max|y|,"
        f" dropped {dropped} (scatter "
        f"{float(aux_sc['moe_frac_dropped'])}); a2a {a2a_s * 1e3:.1f} ms, "
        f"scatter {scatter_s * 1e3:.1f} ms, peak {peak / 2**30:.2f} GiB "
        f"({smi})")
    del pd, xd, x, y, y_sc
    torch.cuda.empty_cache()
    if not rel <= MOE_REL or dropped != 0.0 \
            or float(aux_sc["moe_frac_dropped"]) != 0.0:
        raise SystemExit("moe a2a: the all-to-all dispatch disagrees with "
                         "the scatter or dropped tokens")
    return {"rel_err": rel, "frac_dropped": dropped, "a2a_ms": a2a_s * 1e3,
            "scatter_ms": scatter_s * 1e3, "peak_memory_bytes": peak,
            "tokens": list(MOE_TOKENS)}


def start_dryruns(tmp) -> list:
    """Phase 18 (d): each ``DRYRUN_CELLS`` cell's dry-run in its own
    process, started now; :func:`collect_dryruns` waits for them."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", cell[2], "--out",
         str(tmp / "dryrun")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT))
        for cell in DRYRUN_CELLS]


def collect_dryruns(started, tmp) -> dict:
    """Each started dry-run's record; fails unless every one ends
    ``status: ok`` (a process still running at ``DRYRUN_TIMEOUT_S`` is
    killed)."""
    out = {}
    for (arch, shape, mesh), proc in started:
        try:
            _, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise SystemExit(f"dry-run {arch} {shape} {mesh}: timed out")
        path = tmp / "dryrun" / f"{arch}__{shape}__{mesh}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        log(f"dry-run {arch} × {shape} × {mesh}: {rec.get('status')} in "
            f"{rec.get('total_s')} s (trace {rec.get('trace_s')} s), mesh "
            f"{rec.get('mesh_shape')}, memory {rec.get('memory')}, cost "
            f"{rec.get('cost')}")
        if proc.returncode != 0 or rec.get("status") != "ok":
            raise SystemExit(f"dry-run {arch} {shape} {mesh}: "
                             f"{rec.get('traceback', err)[-4000:]}")
        by_op = rec["cost"]["flops_by_op"]
        if not all(by_op.get(op, 0) > 0 for op in DRYRUN_KERNEL_OPS[arch]):
            raise SystemExit(f"dry-run {arch} {shape} {mesh}: the FLOP "
                             f"count lacks {DRYRUN_KERNEL_OPS[arch]}")
        out[f"{arch}__{shape}__{mesh}"] = rec
    return out


def check_recurrent_backward(ops, ref, variants, ssd, sc, dev,
                             forward_floor_ms=None) -> dict:
    """Phase 17 (a): the SSD and sLSTM backward kernels, through
    ``ops.mamba2_ssd`` and ``ops.slstm_cell`` under autograd (the forward
    kernels, the sLSTM's keeping its trajectory, then the backward
    kernels), against the plain versions' autograd in float64 on the same
    inputs at ``SSD_BWD_CASES`` and ``SLSTM_BWD_CASES``; at the first
    case of each (the model's layer) the plain variants must fail the
    same check; every SSD case must take its ``SSD_BWD_ROUTES``
    route (as ``bwd_route`` says), the first twice bit for bit.  Then
    the first cases timed: the backward alone (the SSD's also by pass),
    the forward (the sLSTM's with and without its trajectory), the plain
    vjp, and the bound (the SSD's also its route's floors; the sLSTM's
    also on the SMs its plan uses); the sLSTM's three gradients, dg_in
    alone, and its step-latency floor (the same kernel at B 1, H 1, dh 4
    and the layer's S) beside the forward's, ``forward_floor_ms``.  The
    sLSTM's first case runs twice, bit for bit.  Launches here count
    nowhere."""
    import torch
    out = {"ssd": {}, "slstm": {}, "ssd_routes": {}}
    names = ("dxdt", "dda", "dB", "dC")
    for k, (label, B, S, H, P, N, chunk, shift) in enumerate(SSD_BWD_CASES):
        gen = torch.Generator(device=dev).manual_seed(17)
        x, da, bm, cm = ssd_inputs(gen, dev, B, S, H, P, N)
        da = da - shift
        dy = torch.randn(B, S, H, P, generator=gen, device=dev)
        leaves = [t.clone().requires_grad_() for t in (x, da, bm, cm)]
        before = dict(ssd.bwd_route_launches)
        t0 = time.perf_counter()
        got = torch.autograd.grad(ops.mamba2_ssd(*leaves, chunk=chunk),
                                  leaves, dy)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        taken = [r for r, n in ssd.bwd_route_launches.items()
                 if n != before[r]]
        want_route = SSD_BWD_ROUTES[k]
        if taken != [want_route] or ssd.bwd_route(P, N, chunk) != want_route:
            raise SystemExit(f"mamba2_ssd backward {label}: took {taken}, "
                             f"bwd_route says {ssd.bwd_route(P, N, chunk)}"
                             f", want {want_route}")
        out["ssd_routes"][label] = want_route
        if k == 0:   # no atomics in the sums: a second run, bit for bit
            again = torch.autograd.grad(
                ops.mamba2_ssd(*leaves, chunk=chunk), leaves, dy)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise SystemExit(f"mamba2_ssd backward {label}: a second "
                                 f"run differs")
            out["ssd_bit_for_bit"] = True
            del again
        wide = [t.double() for t in (x, da, bm, cm, dy)]
        want = ref.plain_vjp(ref.ssd_ref, wide[:4], wide[4])
        wrongs = []
        if label == SSD_BWD_CASES[0][0]:
            inner = ssd.inner_chunk(chunk)
            wrongs = [
                ("no carried state gradient",
                 variants.ssd_bwd_without_carried_gradient(*wide, chunk)),
                ("state gradient one chunk late",
                 variants.ssd_bwd_gradient_one_chunk_late(*wide, chunk)),
                (f"state gradient one kernel chunk ({inner}) late",
                 variants.ssd_bwd_gradient_one_chunk_late(*wide, inner))]
        out["ssd"][label] = hold_gradients(
            f"mamba2_ssd backward {label} ([{B}, {S}, {H}, {P}, {N}] chunk "
            f"{chunk}, route {want_route}"
            f"{', second run bit for bit' if k == 0 else ''}, kernel "
            f"{kernel_s:.2f} s)", names, got, want, wrongs)
        del got, want, wide, wrongs, leaves
        torch.cuda.empty_cache()
    label, B, S, H, P, N, chunk, _ = SSD_BWD_CASES[0]
    gen = torch.Generator(device=dev).manual_seed(17)
    x, da, bm, cm = ssd_inputs(gen, dev, B, S, H, P, N)
    dy = torch.randn(B, S, H, P, generator=gen, device=dev)
    inner = ssd.inner_chunk(chunk)
    bound, bound_by = ssd_bwd_bound_ms(B, S, H, P, N, inner)
    out["ssd_timed"] = {
        "ms": time_ms(ssd.mamba2_ssd_bwd_cuda, x, da, bm, cm, dy, chunk),
        "pass_ms": pass_ms_in_child("ssd"),
        "forward_ms": time_ms(ssd.mamba2_ssd_cuda, x, da, bm, cm, chunk),
        "plain_ms": time_ms(ref.plain_vjp, ref.ssd_ref, (x, da, bm, cm), dy,
                            iters=2, warmup=1),
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "route": SSD_BWD_ROUTES[0],
        "floors": ssd_bwd_floors_ms(B, S, H, P, N, inner),
        "shape": [B, S, H, P, N, chunk]}
    t = out["ssd_timed"]
    fl = t["floors"]
    log(f"mamba2_ssd backward {label}: {t['ms']:.4g} ms = "
        f"{bound / t['ms']:.1%} of its bound ({bound:.4g} ms by "
        f"{bound_by}); route {t['route']}, passes "
        + ", ".join(f"{k} {v:.4g}" for k, v in t["pass_ms"].items())
        + f" ms (profiler); its floors: bytes {fl['bytes_ms']:.4g} ms "
        f"({fl['bytes'] / 1e9:.3g} GB), TF32 products "
        f"{fl['products_ms']:.4g} ms (at f32 FMA {fl['f32_fma_ms']:.4g} "
        f"ms); forward {t['forward_ms']:.4g} ms; "
        f"plain vjp {t['plain_ms']:.4g} ms; library: none")
    del x, da, bm, cm, dy
    torch.cuda.empty_cache()

    names = ("dg_in", "dr", "db")
    for k, (label, B, S, H, dh, floor) in enumerate(SLSTM_BWD_CASES):
        gen = torch.Generator(device=dev).manual_seed(17)
        g_in, r, b = slstm_inputs(gen, dev, B, S, H, dh)
        if floor:
            g_in[:, :, 0, :, :dh // 2] -= 30.0
        dy = torch.randn(B, S, H, dh, generator=gen, device=dev)
        leaves = [t.clone().requires_grad_() for t in (g_in, r, b)]
        t0 = time.perf_counter()
        got = torch.autograd.grad(ops.slstm_cell(*leaves), leaves, dy)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        if k == 0:   # no atomics in dR and db: a second run, bit for bit
            again = torch.autograd.grad(ops.slstm_cell(*leaves), leaves, dy)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise SystemExit(f"slstm_cell backward {label}: a second "
                                 f"run differs")
            out["slstm_bit_for_bit"] = True
            del again
        wide = [t.double() for t in (g_in, r, b, dy)]
        want = ref.plain_vjp(ref.slstm_cell_ref, wide[:3], wide[3])
        h, traj = ref.slstm_cell_fwd_traj_ref(*wide[:3])
        n_min = float(traj[:, :, 5].min())
        wrongs = []
        if label == SLSTM_BWD_CASES[0][0]:
            wrongs = [("no recurrent dh", variants.slstm_bwd_without_recurrence(
                traj, h, wide[1], wide[3]))]
        if floor and not n_min < 1e-6:
            raise SystemExit(f"slstm backward {label}: n >= {n_min:.3g}, "
                             f"the floor does not bite")
        out["slstm"][label] = hold_gradients(
            f"slstm_cell backward {label} ([{B}, {S}, {H}, {dh}], min n "
            f"{n_min:.3g}, kernel {kernel_s:.2f} s"
            f"{', second run bit for bit' if k == 0 else ''})", names, got,
            want, wrongs)
        del got, want, wide, wrongs, leaves, h, traj
        torch.cuda.empty_cache()
    label, B, S, H, dh, _ = SLSTM_BWD_CASES[0]
    gen = torch.Generator(device=dev).manual_seed(17)
    floor_in = slstm_inputs(gen, dev, 1, S, 1, 4)
    floor_dy = torch.randn(1, S, 1, 4, generator=gen, device=dev)
    floor_h, floor_traj = sc.slstm_cell_traj_cuda(*floor_in)
    floor_ms = time_ms(sc.slstm_cell_bwd_cuda, floor_traj, floor_h,
                       floor_in[1], floor_dy)
    del floor_in, floor_dy, floor_h, floor_traj
    gen = torch.Generator(device=dev).manual_seed(17)
    g_in, r, b = slstm_inputs(gen, dev, B, S, H, dh)
    dy = torch.randn(B, S, H, dh, generator=gen, device=dev)
    h, traj = sc.slstm_cell_traj_cuda(g_in, r, b)
    ms = time_ms(sc.slstm_cell_bwd_cuda, traj, h, r, dy)
    plan = sc.bwd_plans[(g_in.device, B, H, dh)]
    clusters = -(-B // plan["rows_per_cluster"])
    bound, bound_by = slstm_bwd_bound_ms(B, S, H, dh, clusters)
    sms = clusters * H * plan["cluster_blocks"]
    card_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out["slstm_timed"] = {
        "ms": ms,
        "dgg_ms": time_ms(sc.slstm_cell_dgg_cuda, traj, r, dy),
        "forward_ms": time_ms(sc.slstm_cell_cuda, g_in, r, b),
        "traj_forward_ms": time_ms(sc.slstm_cell_traj_cuda, g_in, r, b),
        "plain_ms": time_ms(ref.plain_vjp, ref.slstm_cell_ref, (g_in, r, b),
                            dy, iters=2, warmup=1),
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "sms": sms, "card_sms": card_sms,
        "bound_on_sms_ms": bound * card_sms / sms,
        "step_floor_ms": floor_ms, "forward_step_floor_ms": forward_floor_ms,
        "plan": plan, "shape": [B, S, H, dh]}
    t = out["slstm_timed"]
    fwd_floor = ("not measured" if forward_floor_ms is None
                 else f"{forward_floor_ms:.4g} ms")
    log(f"slstm_cell backward {label}: dg_in, dR and db {t['ms']:.4g} ms = "
        f"{bound / t['ms']:.1%} of its bound ({bound:.4g} ms by "
        f"{bound_by}), {t['bound_on_sms_ms'] / t['ms']:.1%} of it on the "
        f"{sms} of {card_sms} SMs its plan {plan} uses; dg_in alone "
        f"{t['dgg_ms']:.4g} ms; step-latency floor (B 1, H 1, dh 4, S {S}) "
        f"{floor_ms:.4g} ms, the forward's {fwd_floor}; forward "
        f"{t['forward_ms']:.4g} ms, with its trajectory "
        f"{t['traj_forward_ms']:.4g} ms "
        f"({t['traj_forward_ms'] / t['forward_ms'] - 1:+.1%}); plain vjp "
        f"{t['plain_ms']:.4g} ms; library: none")
    del g_in, r, b, dy, h, traj
    torch.cuda.empty_cache()
    return out


def recurrent_whole_check(lm, steps, SyntheticLMDataset, RunConfig,
                          InputShape, OptimizerConfig, tree_map, tree_leaves,
                          configs, counts, arch, dev) -> dict:
    """Phase 17 (c): one train step of ``arch`` at full width
    (:func:`whole_model_config`: f32, the smallest depth with every block
    kind), the same weights and batch on the card through the kernels and
    on the host through the backward ops' plain algorithms: the loss
    within ``TRAIN_WHOLE_LOSS_REL`` and every gradient leaf within
    ``TRAIN_WHOLE_GRAD_REL`` × its max |g|; the card's backward kernels
    launched once per recurrent block."""
    import torch
    cfg = whole_model_config(configs, arch)
    run = RunConfig(model=cfg, shape=InputShape("whole", LM_WHOLE_PROMPT, 1,
                                                "train"),
                    optimizer=OptimizerConfig(warmup_steps=1))
    loss_fn = steps.make_loss_fn(run)
    batch = SyntheticLMDataset(cfg, LM_WHOLE_PROMPT, 1, seed=17).batch_at(0)
    gen = torch.Generator(device=dev).manual_seed(17)
    with torch.no_grad():
        card_params = lm.init(gen, cfg, dev)
        host_params = tree_map(lambda t: t.to("cpu", copy=True),
                               card_params)

    def one_step(params, device):
        params = tree_map(lambda t: t.requires_grad_(), params)
        b = {k: torch.from_numpy(v).to(device, dtype=torch.long)
             for k, v in batch.items()}
        loss, _, grads = steps.value_and_grad(loss_fn, params, b)
        return float(loss), grads

    before = counts()
    card_loss, card_g = one_step(card_params, dev)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
    t0 = time.perf_counter()
    host_loss, host_g = one_step(host_params, torch.device("cpu"))
    host_s = time.perf_counter() - t0
    loss_rel = abs(card_loss - host_loss) / abs(host_loss)
    grad_rel = max(float((cg.cpu() - hg).abs().max())
                   / max(float(hg.abs().max()), 1e-30)
                   for cg, hg in zip(tree_leaves(card_g),
                                     tree_leaves(host_g)))
    del card_params, card_g
    torch.cuda.empty_cache()
    blocks = (*cfg.prefix_blocks, *cfg.block_pattern * cfg.num_groups)
    want = {"mamba2_ssd_bwd": blocks.count("mamba2"),
            "slstm_cell_bwd": blocks.count("slstm")}
    log(f"{arch} whole model train step ({cfg.num_layers} layers, f32, seq "
        f"{LM_WHOLE_PROMPT}): card loss {card_loss:.8g}, host "
        f"{host_loss:.8g} (rel {loss_rel:.3g}); worst gradient leaf "
        f"{grad_rel:.3g} × its max |g|; card launches {launched}; host "
        f"{host_s:.1f} s")
    if not loss_rel <= TRAIN_WHOLE_LOSS_REL \
            or not grad_rel <= TRAIN_WHOLE_GRAD_REL:
        raise SystemExit(f"{arch} whole-model train step: card and host "
                         f"differ (loss {loss_rel:.3g}, gradients "
                         f"{grad_rel:.3g})")
    if any(launched.get(k, 0) != v for k, v in want.items() if v):
        raise SystemExit(f"{arch} whole-model train step launched "
                         f"{launched}, want {want}")
    return {"layers": cfg.num_layers, "seq": LM_WHOLE_PROMPT,
            "loss_rel": loss_rel, "grad_rel": grad_rel,
            "card_launches": launched, "host_s": host_s}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this "
              "script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.analysis.targets import f32
    from repro_torch.api import PerfSession
    from repro_torch.kernels import _build, dg_diff, flash_attention
    from repro_torch.kernels import mamba2_ssd, matmul_tiled, microbench
    from repro_torch.kernels import ops, ref, slstm_cell, stencil5
    from repro_torch import studies
    from repro_torch.core import uipick
    from repro_torch.core.countengine import CountEngine
    from repro_torch.core.uipick import default_timer
    from repro_torch.profiles import cli, load_profile, presets
    from repro_torch.profiles.cli import main as calibrate_main
    from repro_torch.studies import paper_figures
    from repro_torch.testing import variants
    from repro_torch.analysis.cli import main as lint_main
    from repro_torch.analysis.scope import abstract_like
    from repro_torch.studies.autotune import autotune
    from repro_torch.tuning.cli import main as tune_main
    from repro_torch.fleet import FleetRouter
    from repro_torch.fleet.cli import main as fleet_main
    from repro_torch.profiles.profile import save_profile
    from repro_torch.serving.cli import main as serve_main
    from repro_torch.studies import fleet_bench, serve_bench
    from repro_torch.testing import synthdev
    from repro_torch.core.counting import count_fn
    from repro_torch.core.workremoval import remove_work
    from repro_torch.studies.run import main as run_main
    from repro_torch.configs import InputShape
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import counting as lm_counting
    from repro_torch.models import lm
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.configs import OptimizerConfig, RunConfig
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import steps
    from repro_torch.launch.presets import make_run_config
    from repro_torch.optim import adamw
    from repro_torch.runtime import Trainer
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe, moe_a2a
    from repro_torch.models.param import axes_tree, init_tree, place
    from repro_torch.sharding import use_mesh

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} ({smi})")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    ptxas = _build.ptxas_report_path(lib)
    if not ptxas.exists():
        raise SystemExit(f"no ptxas report beside {lib.name}")
    for line in ptxas.read_text().splitlines():
        if any(w in line for w in ("registers", "spill", "==",
                                   "entry function", "wgmma")):
            log(f"ptxas {line.strip()}")
    check_no_spills(ptxas.read_text())
    check_no_serialized_wgmma(ptxas.read_text())
    check_madd_sass(sass_counts(lib))

    # ---- 2. each kernel against its plain version ---------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    errs = check_kernels(ops, ref, dev)
    print(json.dumps({"dg_diff_node_counts": check_dg_node_counts(
        ops, ref, dev)}), flush=True)
    sizes = model_layer_sizes(configs)
    log(f"model-layer real sizes (port configs): {sizes}")
    errs.update(check_model_kernels(ops, ref, variants, dev, sizes))
    single = (matmul_tiled, stencil5, dg_diff, flash_attention, mamba2_ssd,
              slstm_cell)

    with_backward = (flash_attention, mamba2_ssd, slstm_cell)

    def counts():
        return {**{m.__name__.rsplit(".", 1)[1]: m.launches for m in single},
                **microbench.launches,
                **{m.__name__.rsplit(".", 1)[1] + "_bwd": m.backward_launches
                   for m in with_backward}}

    def zero_counts():
        for m in single:
            m.launches = 0
        for m in with_backward:
            m.backward_launches = 0
        for name in microbench.launches:
            microbench.launches[name] = 0

    # ---- 3-5. the base-model path, counted ---------------------------------
    zero_counts()
    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_smoke_"))
    profile_path = tmp / "h100_profile.json"
    t0 = time.perf_counter()
    # keep the battery's feature table: fitted again off the card, it
    # tells the LM solver's part in the fit from the data's
    tables = []
    gather = cli.gather_feature_table

    def keep_table(*args, **kwargs):
        tables.append(gather(*args, **kwargs))
        return tables[-1]

    cli.gather_feature_table = keep_table
    try:
        rc = calibrate_main(["--out", str(profile_path), "--trials", "3",
                             "--device", "cuda"])
    finally:
        cli.gather_feature_table = gather
    if rc != 0:
        raise SystemExit(f"calibration exited {rc}")
    log(f"calibration took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"base_feature_table": tables[0].to_dict()}),
          flush=True)
    profile = load_profile(profile_path)
    fit = profile.fits["base"].fit
    if profile.fingerprint.platform != "gpu" or \
            profile.fingerprint.device_kind != torch.cuda.get_device_name(0):
        raise SystemExit(f"profile fingerprint {profile.fingerprint}")
    if len(profile.kernel_names) != 43:
        raise SystemExit(f"battery has {len(profile.kernel_names)} kernels, "
                         f"the reference selects 43")
    if not all(math.isfinite(v) and v >= 0 for v in fit.params.values()):
        raise SystemExit(f"fitted params not finite/nonnegative: {fit}")
    log(f"profile {profile.fingerprint.id}: converged={fit.converged} "
        f"residual={fit.residual_norm:.6g} params={fit.params}")

    rc = calibrate_main(["predict", str(profile_path),
                         "--kernel", "kernels.ops.matmul",
                         "--kernel", "kernels.ops.stencil5",
                         "--kernel", "kernels.ops.dg_diff",
                         "--explain", "3", "--expect-zero-timings"])
    if rc != 0:
        raise SystemExit(f"predict exited {rc}")

    session = PerfSession.open(profile_path)
    m, k, n = REAL_MATMUL
    mm, nn, kk = REAL_DG
    base_names = ("matmul_tiled", "stencil5", "dg_diff")
    preds = session.predict_batch(
        [(ops.matmul, (f32(m, k), f32(k, n))),
         (ops.stencil5, (f32(*REAL_STENCIL),)),
         (ops.dg_diff, (f32(mm, nn, nn), f32(nn, kk)))],
        names=list(base_names))
    if session.timer.calls != 0:
        raise SystemExit(f"prediction timed {session.timer.calls} kernels")
    for p in preds:
        if not (math.isfinite(p.seconds) and p.seconds > 0):
            raise SystemExit(f"prediction {p.kernel}: {p.seconds}")
        print(p.explain(top=3), flush=True)
    log(f"real-size prediction: timings_performed={session.timer.calls} "
        f"batched_evals={session.eval_calls}")

    rng = np.random.default_rng(11)
    args = {"matmul_tiled": (randn(rng, m, k).to(dev),
                             randn(rng, k, n).to(dev)),
            "stencil5": (randn(rng, *REAL_STENCIL).to(dev),),
            "dg_diff": (randn(rng, mm, nn, nn).to(dev),
                        randn(rng, nn, kk).to(dev))}
    wrappers = {"matmul_tiled": ops.matmul, "stencil5": ops.stencil5,
                "dg_diff": ops.dg_diff}
    base_ms = {name: time_ms(wrappers[name], *args[name])
               for name in base_names}
    launches = {name: counts()[name] for name in base_names}
    log(f"launches on the base-model path: {launches}")
    if not all(launches.values()):
        raise SystemExit(f"a kernel of the base-model path never "
                         f"launched: {launches}")
    base_pred = {p.kernel: p.seconds * 1e3 for p in preds}
    for name in base_names:
        log(f"{name}: base model predicted {base_pred[name]:.4g} ms, "
            f"measured {base_ms[name]:.4g} ms (pred/meas "
            f"{base_pred[name] / base_ms[name]:.3g})")
    del args

    # ---- 6-7. the zoo-study path, counted -----------------------------------
    zero_counts()
    zoo_preds = zoo_path(calibrate_main, load_profile, PerfSession, f32,
                         ops, tmp)
    measured, zoo_cases = time_zoo_kernels(ops, ref, dev, zoo_preds, F)
    launches = counts()
    zoo_kernels = list(measured)
    log(f"launches on the zoo-study path: {launches}")
    if not all(launches[name] for name in zoo_kernels):
        raise SystemExit(f"a kernel of the zoo-study path never launched: "
                         f"{launches}")

    # ---- 8. the model-layer kernels, counted -------------------------------
    zero_counts()
    t0 = time.perf_counter()
    measured.update(model_layer_path(
        calibrate_main, PerfSession, model_layer_cases(ops, ref, sizes), dev,
        profile_path, tmp / "h100_zoo.json"))
    model_launches = {name: counts()[name] for name in
                      ("flash_attention", "mamba2_ssd", "slstm_cell")}
    log(f"launches on the model-layer path: {model_launches} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not all(model_launches.values()):
        raise SystemExit(f"a model-layer kernel never launched: "
                         f"{model_launches}")
    launches.update(model_launches)

    # the two kernels nearest their library call, timed again in turns
    # with it (after the counted paths, so these launches count nowhere)
    stream = zoo_cases["stream_strided"]
    for name, case, row in (
            ("dg_diff", zoo_cases["dg_diff"], measured["dg_diff"]),
            ("stream_strided", stream, measured["stream_strided"]),
            ("stream_strided stride4", stream["variant"][1],
             measured["stream_strided"]["stride4"])):
        turns = time_in_turns(case["kernel"], case["library"], case["args"])
        row["in_turns_ratio"] = turns["median"]
        log(f"{name} in turns with its library call: kernel ÷ library "
            f"{turns['median']:.4g} (median of {len(turns['rounds'])} "
            f"rounds: " + " ".join(f"{x:.4g}" for x in turns["rounds"])
            + ")")
    del zoo_cases, stream
    recurrent = floor_and_passes(slstm_cell, mamba2_ssd, sizes, dev)
    sl, sd = measured["slstm_cell"], measured["mamba2_ssd"]
    sl["step_floor_ms"] = recurrent["step_floor_ms"]
    sd["pass_ms"] = recurrent["pass_ms"]
    log(f"slstm_cell cluster plans met: {slstm_cell.plans}")
    log(f"slstm_cell: {sl['ms']:.4g} ms = {sl['bound_ms'] / sl['ms']:.1%} "
        f"of its bound ({sl['bound_ms']:.4g} ms), "
        f"{sl['step_floor_ms'] / sl['ms']:.1%} of its step-latency floor "
        f"({sl['step_floor_ms']:.4g} ms = {sizes['slstm']['S']} steps of "
        f"{sl['step_floor_ms'] / sizes['slstm']['S'] * 1e3:.4g} µs at B=1, "
        f"H=1, dh=4)")
    ssd = sizes["ssd"]
    ssd_bytes_ms = (4 * ssd["B"] * ssd["S"] * ssd["H"]
                    * (2 * ssd["P"] + 2 * ssd["N"] + 1) / PEAK_HBM_BYTES * 1e3)
    ssd_ops = sd["tflops"] * 1e9 * sd["ms"]
    log(f"mamba2_ssd: {sd['ms']:.4g} ms = {sd['bound_ms'] / sd['ms']:.1%} "
        f"of its bound ({sd['bound_ms']:.4g} ms by {sd['bound_by']}; "
        f"operations counted at the kernel's chunk, over the f32 FMA "
        f"peak); its "
        f"bytes alone take {ssd_bytes_ms:.4g} ms "
        f"({ssd_bytes_ms / sd['ms']:.1%} of it), its operations at the "
        f"3×TF32 rate (TF32 peak / 3) {ssd_ops / PEAK_TF32_FLOPS * 3e3:.4g} "
        f"ms; at the kernel's chunk "
        f"{mamba2_ssd.inner_chunk(ssd['chunk'])} the passes alone "
        + ", ".join(f"{name} {ms:.4g} ms"
                    for name, ms in sd["pass_ms"].items())
        + f" (sum {sum(sd['pass_ms'].values()):.4g} ms)")

    # ---- 10. the paper's figures, from phase 3's profile --------------------
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("TF32 is on: the figures time f32 products")
    zero_counts()
    t0 = time.perf_counter()
    figures = figures_path(paper_figures, default_timer, profile, dev)
    log(f"paper figures took {time.perf_counter() - t0:.1f} s; hand-kernel "
        f"launches on their path (aten ops only): {counts()}")
    print(json.dumps({"figures": figures,
                      "loops": loop_costs(uipick, dev)}), flush=True)

    # ---- 11. measurement cache, count engine, retiming ----------------------
    zero_counts()
    t0 = time.perf_counter()
    items = zoo_items(ops, f32)
    cases = model_layer_cases(ops, ref, sizes)
    items.update({name: (c["kernel"], c["meta"])
                  for name, c in cases.items()})
    amortization = amortization_path(
        calibrate_main, PerfSession, CountEngine, uipick, paper_figures,
        presets, studies, items, profile_path, tmp / "h100_zoo.json", tmp)
    pricing_launches = counts()
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s; hand-kernel "
        f"launches on its path (aten battery, pricing only): "
        f"{pricing_launches}")
    if any(pricing_launches.values()):
        raise SystemExit(f"pricing launched a hand kernel: "
                         f"{pricing_launches}")
    print(json.dumps({"amortization": amortization}), flush=True)

    # ---- 12. autotuning and the static audit --------------------------------
    zero_counts()
    t12 = time.perf_counter()
    tuning = tuning_path(tune_main, autotune, load_profile, profile_path,
                         tmp)
    log(f"phase 12 tuning took {time.perf_counter() - t12:.1f} s; "
        f"hand-kernel launches on its path (aten generators only): "
        f"{counts()}")
    print(json.dumps({"tuning": tuning}), flush=True)
    zero_counts()
    t0 = time.perf_counter()
    audit = audit_path(PerfSession, calibrate_main, lint_main,
                       abstract_like, items, profile_path)
    audit_launches = counts()
    log(f"phase 12 audit took {time.perf_counter() - t0:.1f} s; "
        f"hand-kernel launches during it: {audit_launches}")
    if any(audit_launches.values()):
        raise SystemExit(f"the audit launched a hand kernel: "
                         f"{audit_launches}")
    audit["launches"] = audit_launches
    print(json.dumps({"audit": audit}), flush=True)
    log(f"phase 12 took {time.perf_counter() - t12:.1f} s")

    # ---- 13. serving and fleet routing ---------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    serving = serving_path(
        serve_main, fleet_main, FleetRouter, studies, synthdev,
        save_profile, serve_bench, fleet_bench, load_profile, items,
        measured, profile_path, tmp)
    serving_launches = counts()
    serving["seconds"] = time.perf_counter() - t0
    serving["launches"] = serving_launches
    log(f"phase 13 took {serving['seconds']:.1f} s; hand-kernel launches "
        f"during it: {serving_launches}")
    if any(serving_launches.values()):
        raise SystemExit(f"serving or routing launched a hand kernel: "
                         f"{serving_launches}")
    print(json.dumps({"serving": serving}), flush=True)

    # ---- 14. work removal and the host benches -------------------------------
    zero_counts()
    t0 = time.perf_counter()
    phase14 = workremoval_path(uipick, remove_work, count_fn, run_main, dev)
    wr_launches = counts()
    log(f"phase 14 took {time.perf_counter() - t0:.1f} s; hand-kernel "
        f"launches during it: {wr_launches}")
    if any(wr_launches.values()):
        raise SystemExit(f"work removal or the benches launched a hand "
                         f"kernel: {wr_launches}")
    phase14["workremoval"]["launches"] = wr_launches
    print(json.dumps({"workremoval": phase14["workremoval"]}), flush=True)
    print(json.dumps({"benches": phase14["benches"]}), flush=True)

    # ---- 15. the served language models -------------------------------------
    t0 = time.perf_counter()
    served = lm_path(lm_serve.main, lm, lm_counting, InputShape, tree_map,
                     configs, ops, ref, lm_serve.launch_counts, zero_counts,
                     dev)
    lm_launches = {name: sum(m["launches_run"][name]
                             for m in served.values())
                   for name in lm_serve.KERNELS}
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s; hand-kernel "
        f"launches serving the three models: {lm_launches}")
    print(json.dumps({"lm": {"models": served, "launches": lm_launches,
                             "seconds": time.perf_counter() - t0,
                             "device": smi}}), flush=True)

    # ---- 16. training on the card ------------------------------------------
    t16 = time.perf_counter()
    backward = check_attention_backward(ops, ref, flash_attention, dev)
    log(f"phase 16 (a) took {time.perf_counter() - t16:.1f} s")
    t0 = time.perf_counter()
    training = train_path(Trainer, make_run_config, InputShape,
                          OptimizerConfig, configs, lm_counting, tree_leaves,
                          counts, zero_counts, dev, tmp, arch=TRAIN_ARCH,
                          layers=TRAIN_LAYERS, batch=TRAIN_BATCH,
                          steps=TRAIN_STEPS, launches=TRAIN_STEP_LAUNCHES)
    log(f"phase 16 (b) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fault = fault_tolerance_path(Trainer, InputShape, OptimizerConfig,
                                 RunConfig, configs, dev, tmp)
    log(f"phase 16 (c) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    whole_train = whole_train_check(
        lm, steps, adamw, SyntheticLMDataset, RunConfig, InputShape,
        OptimizerConfig, tree_map, tree_leaves, configs, counts, dev)
    log(f"phase 16 (d) took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"train": {
        "attention_backward": backward, "gemma2_9b": training,
        "fault_tolerance": fault, "whole_model": whole_train,
        "seconds": time.perf_counter() - t16, "device": smi}}), flush=True)

    # ---- 17. training the recurrent models on the card ---------------------
    t17 = time.perf_counter()
    recurrent = check_recurrent_backward(
        ops, ref, variants, mamba2_ssd, slstm_cell, dev,
        forward_floor_ms=measured["slstm_cell"]["step_floor_ms"])
    log(f"phase 17 (a) took {time.perf_counter() - t17:.1f} s")
    t0 = time.perf_counter()
    trained = {arch: train_path(
        Trainer, make_run_config, InputShape, OptimizerConfig, configs,
        lm_counting, tree_leaves, counts, zero_counts, dev, tmp, arch=arch,
        layers=layers, batch=RECURRENT_BATCH, steps=RECURRENT_STEPS,
        launches=RECURRENT_STEP_LAUNCHES[arch],
        routes=(lambda: dict(mamba2_ssd.bwd_route_launches),
                RECURRENT_STEP_SSD_ROUTES[arch]))
        for arch, layers in RECURRENT_TRAIN}
    log(f"phase 17 (b) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wholes = {arch: recurrent_whole_check(
        lm, steps, SyntheticLMDataset, RunConfig, InputShape,
        OptimizerConfig, tree_map, tree_leaves, configs, counts, arch, dev)
        for arch, _ in RECURRENT_TRAIN}
    log(f"phase 17 (c) took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"train_recurrent": {
        "backward": recurrent, "trained": trained, "whole_model": wholes,
        "seconds": time.perf_counter() - t17, "device": smi}}), flush=True)

    # ---- 18. the mesh -------------------------------------------------------
    t18 = time.perf_counter()
    meshed = mesh_train_path(Trainer, make_run_config, InputShape,
                             OptimizerConfig, configs, make_host_mesh,
                             tree_leaves, counts, zero_counts, smi, dev, tmp)
    log(f"phase 18 (a) took {time.perf_counter() - t18:.1f} s")
    t0 = time.perf_counter()
    dryruns = start_dryruns(tmp)
    try:
        checkpointed = mesh_checkpoint_path(
            Trainer, InputShape, OptimizerConfig, RunConfig, configs,
            make_host_mesh, tree_leaves, dev, tmp)
        log(f"phase 18 (b) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        moe_layer = moe_a2a_path(configs, init_tree, moe, moe_a2a,
                                 axes_tree, place, make_host_mesh, use_mesh,
                                 smi, dev)
        log(f"phase 18 (c) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cells = collect_dryruns(dryruns, tmp)
    finally:
        for _, proc in dryruns:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    log(f"phase 18 (d) waited {time.perf_counter() - t0:.1f} s more")
    print(json.dumps({"mesh": {
        "train": meshed, "checkpoint": checkpointed, "moe_a2a": moe_layer,
        "dryrun": cells, "seconds": time.perf_counter() - t18,
        "device": smi}}), flush=True)

    sources = {"matmul_tiled": "src/repro/kernels/matmul_tiled.py:54",
               "stencil5": "src/repro/kernels/stencil5.py:43",
               "dg_diff": "src/repro/kernels/dg_diff.py:41",
               "stream_strided": "src/repro/kernels/microbench.py:44",
               "madd_throughput": "src/repro/kernels/microbench.py:80",
               "flash_attention": "src/repro/kernels/flash_attention.py:109",
               "mamba2_ssd": "src/repro/kernels/mamba2_ssd.py:78",
               "slstm_cell": "src/repro/kernels/slstm_cell.py:77"}
    # the backward kernel: launches from phase 16 (b), its error at the
    # main path's layer (gemma2-9b global, bf16), timed there
    timed = backward["timed"]
    measured["flash_attention_bwd"] = {
        key: timed[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}
    measured["flash_attention_bwd"].update(
        {key: timed[key] for key in (
            "library", "forward_lse_ms", "fwd_bwd_ms", "library_fwd_ms",
            "library_bwd_ms", "passes_ms", "tflops")}, pred_over_meas={})
    launches["flash_attention_bwd"] = training["launches"][
        "flash_attention_bwd"]
    main_case = backward["cases"][f"{ATTN_BWD_CASES[0][0]} bfloat16"]
    errs["flash_attention_bwd"] = max(
        main_case[g]["max_abs_err"] for g in ("dq", "dk", "dv"))
    sources["flash_attention_bwd"] = "src/repro/models/layers.py:151"
    # the recurrent backward kernels: launches from phase 17 (b)'s steps,
    # their error at the model's layer, timed there
    for name, timed, case in (
            ("mamba2_ssd_bwd", recurrent["ssd_timed"],
             recurrent["ssd"][SSD_BWD_CASES[0][0]]),
            ("slstm_cell_bwd", recurrent["slstm_timed"],
             recurrent["slstm"][SLSTM_BWD_CASES[0][0]])):
        measured[name] = {key: timed[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "forward_ms")}
        measured[name].update(library="none", pred_over_meas={})
        launches[name] = sum(t["launches"].get(name, 0)
                             for t in trained.values())
        errs[name] = max(r["max_abs_err"] for r in case.values())
    measured["mamba2_ssd_bwd"].update(
        {key: recurrent["ssd_timed"][key]
         for key in ("route", "pass_ms", "floors")},
        routes=recurrent["ssd_routes"])
    measured["slstm_cell_bwd"].update(
        {key: recurrent["slstm_timed"][key] for key in (
            "traj_forward_ms", "dgg_ms", "step_floor_ms", "bound_on_sms_ms",
            "sms")})
    sources["mamba2_ssd_bwd"] = "src/repro/models/ssm.py:77"
    sources["slstm_cell_bwd"] = "src/repro/models/xlstm.py:275"
    rows = []
    for name, meas in measured.items():
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{name}.cu",
               "replaces": sources[name], "launches": launches[name],
               "max_abs_err": errs[name], **meas}
        if name in lm_launches:   # phase 15, the served models
            row["launches_lm"] = lm_launches[name]
        if name == "flash_attention":   # phase 16 (b), the training steps
            row["launches_train"] = training["launches"][name]
        if name in ("mamba2_ssd", "slstm_cell", "flash_attention"):
            row["launches_train_recurrent"] = sum(  # phase 17 (b)
                t["launches"][name] for t in trained.values())
        if name in base_pred:
            row["predicted_ms"]["base"] = base_pred[name]
            row["pred_over_meas"]["base"] = base_pred[name] / meas["ms"]
        rows.append(row)
        for tag, r in [("", row)] + [(f" {t}", row[t])
                                     for t in ("stride4", "global")
                                     if t in row]:
            ratios = " ".join(f"{rung} {v:.3g}"
                              for rung, v in r["pred_over_meas"].items())
            lib_ms = r["library_ms"]
            log(f"{name}{tag}: measured {r['ms']:.4g} ms, bound "
                f"{r['bound_ms']:.4g} ms by {r['bound_by']}, plain "
                f"{r['plain_ms']:.4g} ms, library "
                f"{'none' if lib_ms is None else f'{lib_ms:.4g} ms'}; "
                f"pred/meas {ratios}")

    for name, r in (("matmul_tiled", measured["matmul_tiled"]),
                    ("flash_attention local", measured["flash_attention"]),
                    ("flash_attention global",
                     measured["flash_attention"]["global"]),
                    ("dg_diff", measured["dg_diff"]),
                    ("stream_strided", measured["stream_strided"]),
                    ("stream_strided stride4",
                     measured["stream_strided"]["stride4"])):
        log(f"{name}: {r['ms']:.4g} ms = "
            f"{r['ms'] / r['library_ms']:.3g}× its library call "
            f"({r['library_ms']:.4g} ms), {r['tflops']:.4g} TFLOP/s on the "
            f"needed work, {r['bound_ms'] / r['ms']:.1%} of its bound")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--pass-trace":
        sys.exit(pass_trace_main(sys.argv[2]))
    sys.exit(main())
