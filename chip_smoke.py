#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the device: CUDA must be present; prints the card's name and
   ``nvidia-smi``'s name and power limit;
2. the build: compiles every CUDA library of the port with ``nvcc`` from the
   sources in this checkout, one ``nvcc`` per library, all at once, and
   prints ``-Xptxas -v``'s registers and spills of every kernel: #6's
   three and its backward's four, the LSTM sequence kernels' (#1, #2,
   #3), the one-step cell's (#5), #4's, and #7's and #8's two and their
   backwards' two each;
3. the kernels: each kernel against its plain PyTorch version on the card
   at the main paths' shapes and a few edge shapes (the training pair also
   against the plain versions of its own algorithms, ``ref.*_tiled_ref``,
   with ragged tiles, one row and a long T; every case of #1, #2, #3, #5,
   #4, #6's two Hopper kernels, #7 and #8 runs twice, bit for bit), then
   timed beside the plain version and the library call that computes the
   same function (cuDNN's ``torch.nn.LSTM`` for #1-#3, by CUDA events and
   by the profiler's device time, #1's in turns with cuDNN's; for the int8
   matmul, which no one PyTorch call computes, ``(x @ q.float()) *
   scale``, both by CUDA events and by device time; for the one-step LSTM
   cell #5, ``torch.lstm_cell``, device times in turns, and #5 also at 1, 2
   and 4 rows a block and at H = 512; each #5 case prints its tiling);
4. the serving path: the paper's per-window loop (``HybridStreamAnalytics.
   run``) on the card in every weighting mode, serving the stream with the
   models the JAX reference published (``tests/data/
   torch_parity_lstm_paper.npz``); every per-window record must match the
   reference's, and the launch counters must show that every predict went
   through the serving kernel;
5. the training path: the batch model pretrained on the card, then the same
   loop in every mode training each window's speed model on the card, both
   from the reference's initial params and permutations (the fixture's
   draws); every trained model and every record must match the reference's,
   the launch counters must show every train step through the training
   kernels, and a refit from the same draws must be bit-identical;
6. the bus path (``BusExecutor``): the reference's models replayed in the
   paper's three deployments with float sync (integrated and cloud-centric
   must reproduce the in-process records, edge-centric must OOM every
   window and serve the batch model), and with int8 sync in the integrated
   deployment (every publish 9,644 B of int8 tensors equal to the
   reference's bit for bit, its int8 predictions and records matched, every
   int8 product through the int8 kernel); then the launcher
   (``repro_torch.launch.edge_cloud``), trained on the card, with float and
   with int8 sync, must pass every Table-3 claim;
7. where the time goes: ``torch.profiler`` gives each kernel's own device
   time, and the device's busy time and idle share over a warm drive of the
   serving path, over one warm speed fit and pretrain, and over one warm
   int8 bus run;
8. the zoo's serving path: ``tinyllama-1.1b`` at full width and depth
   through the port's ``Engine``, every attention through the flash kernel.
   In float32, params from a numpy seed must reproduce the JAX reference's
   greedy tokens and logits (``tests/data/torch_parity_tinyllama.npz``),
   step-by-step decode must equal one full forward, and ``Engine.serve`` of
   the fixture's four requests on two slots (a slot freed and refilled
   twice, prefill buckets of 32 and 64) must give the reference's tokens,
   admission and finish ticks (a differing token only where the
   reference's top-2 margin is below ``ZOO_LOGIT_ATOL``, a near tie that
   ends that request's comparison); in the config's bf16,
   ``Engine.generate`` (4 x 512 prompt + 32 tokens) must launch the flash
   kernel exactly 22 x 32 times (22 of its wgmma prefill, 22 x 31 of its
   split decode, none of its SIMT kernel) and no plain attention, and
   ``Engine.serve`` must finish every request; prefill and decode times,
   tokens/s, the device's idle share over a warm generate and the device
   time of every port kernel in it are printed;
9. the zoo's RWKV6 path: ``rwkv6-3b`` at full width and depth through the
   same ``Engine`` and the same checks, every WKV recurrence through the
   WKV kernel: float32 parity with ``tests/data/torch_parity_rwkv6_3b.npz``
   and decode equivalence and the float32 serve, then in bf16
   ``Engine.generate`` (4 x 512 + 32) with exactly 32 x 32 launches of the
   WKV scan (32 of its chunked prefill kernel, 32 x 31 of its row-split
   decode kernel) and no plain WKV call, and ``Engine.serve``;
10. the zoo's hybrid path: ``zamba2-1.2b`` at full width and depth through
   the same ``Engine`` and the same checks, every Mamba2 scan through the
   selective-scan kernel and every application of the shared attention
   block through the flash kernel: float32 parity with
   ``tests/data/torch_parity_zamba2_1_2b.npz`` and decode equivalence,
   then in bf16 ``Engine.generate`` (4 x 512 + 32) with exactly 38 x 32
   launches of the selective scan (38 of its chunked prefill kernel, 38 x
   31 of its row-split decode kernel), 6 x 32 of the flash kernel (6 of
   its wgmma prefill, 6 x 31 of its split decode) and no plain scan or
   attention, and ``Engine.serve``;
11. the scan path, the path of the one-step LSTM cell #5: the per-step
   baseline ``ops.lstm_sequence_scan`` on the reference's batch model and
   a serving window (250 x 5 x 5, H = 40), in float32 and with bf16 x; each
   call must launch #5 exactly T = 5 times and no sequence kernel, match
   the plain scan (whose carry is in x's type, as the reference's) and, in
   float32, the fused #1; then timed beside #1 and ``torch.nn.LSTM``;
12. the fleet, the stream axis of #1-#4 (``fleet_kernel_phase``,
   ``fleet_phase``): each stream-axis kernel against its plain version at
   S = 1, 3 and 8, rerun bit for bit, every stream equal bit for bit to a
   single-stream launch, nothing launched at S = 0 or B = 0, then timed at
   the fleet shapes at S = 1, 8 and 64 beside S times one stream's bound
   (#4 also beside ``torch.bmm``); the fixture's fleet
   (``tests/data/torch_parity_fleet.npz``, 3 streams x 4 windows)
   replayed from the reference's draws through ``InProcessFleetExecutor``
   and ``FleetBusExecutor`` (float, int8 and gated sync), every fit and
   record within ``FLEET_ATOL``; ``lstm-paper`` fleets of 8 and 64
   streams x 8 windows x 250 records with the port's own draws, one
   launch of #2 and of #3 a fit step and of #1 a stacked predict whatever
   S, seven of #4 an int8 fleet predict, streams 0, S/2 and S-1 of a
   fleet fit equal to sequential fits with the same keys; one window's
   fit timed at S = 1, 8 and 64 beside 8 sequential fits (wall, device
   busy time, idle share); and the fleet launcher (``--streams 8
   --windows 4 --fast --gated``).
13. the request plane (``request_phase``): the reference's serving runs
   of ``tests/data/torch_parity_requests.npz`` (``serve_float``,
   ``serve_int8``: the fleet fixture's fleet answering an open-loop trace
   on 4 slots under fixed stage costs) replayed from the reference's
   draws, every answer within ``REQUEST_ATOL`` and every stamp, latency
   and statistic exactly; a mix of point, horizon and what-if queries
   batched against unbatched within ``UNBATCHED_ATOL``, float and int8; a
   float tick exactly one launch of #1, an int8 tick exactly seven of #4,
   no plain version, at S = 3, 8 and 64 and with streams that have no
   rows; ``lstm-paper`` fleets of 8 streams at 20 qps on 4 slots and 64 at
   200 qps on 16 (4 windows x 250 records, measured walls), every request
   answered at one stacked predict a tick, sustained >= offered QPS, with
   the latency percentiles, tick walls, a warm tick's idle share,
   staleness and restacks printed, and every measured stage's wall logged
   with its kind and window (``logging_stages``): the slowest five
   printed with the collections of Python's collector that overlapped
   each and the card's reserved-memory growth at each;
14. the placement plane (``placement_phase``): the ``LoadForecaster``'s
   fits (H = 8, F = 1) replayed from the reference's draws, every forecast
   within ``FORECAST_RTOL``, one launch of #2 and of #3 a fit step and one
   of #1 a forecast, #1-#3 at its shapes against their plain versions
   twice, bit for bit; the reference's ``elastic_spike`` run replayed
   (migrations, scale events and final workers exactly); the fleet
   launcher with both planes on (``--streams 8 --windows 4 --fast --qps 20
   --slots 4 --elastic``), float and ``--quantized``, every request
   answered and no window dropped; then #1-#4 timed at the planes' shapes
   (``plane_kernel_timings``);
15. the chaos and health planes (``chaos_phase``): the reference's chaos
   runs of ``tests/data/torch_parity_chaos.npz`` (its eight scenarios,
   ``fault_free`` under static thresholds and the delayed-sync watchdog
   run, on the fleet fixture's fleet) replayed from the reference's draws,
   the fault schedule, bus signature, health verdicts and adaptations and
   every stamp, latency and statistic exactly, answers and records within
   ``REQUEST_ATOL`` and each envelope's RMSE within ``CHAOS_RMSE_RTOL``;
   the port's own ``ChaosHarness`` at BENCH_chaos.json's config (3
   streams x 6 windows x 120 records, 8 qps), all eight scenarios under
   ``torch.use_deterministic_algorithms``, with ``tests/test_chaos.py``'s
   properties (envelopes, every corrupt and forged publish rejected and
   none installed, detection within two heartbeat intervals, a calm run
   with no verdict and byte-identical to static thresholds, seed 0 twice
   byte-identical, seed 1 different); ``partitioned_sync``,
   ``forged_sync`` and ``sensor_chaos`` at S = 64 (6 windows x 250
   records, 64 qps on 16 slots) beside ``fault_free``; every run's
   launches of #1-#4 those of the forwards it ran (one of #1 a float
   predict, one of #2 and #3 a fit step, seven of #4 an int8 one) and no
   plain version; a ``forged_sync`` run's wall, busy device time and idle
   share at each size, and the host cost of signing and verifying a
   publish;
16. the rest of the zoo's dense transformers (``zoo_rest_phase``):
   ``h2o-danube-3-4b``, ``codeqwen1.5-7b`` and ``nemotron-4-15b`` through
   ``zoo_phase`` as in phase 8, each from its parity fixture
   (``tests/data/torch_parity_<arch>.npz``) at full width in float32, at
   the depth ``PARITY_CUTS`` names (h2o 24 of 24 layers, codeqwen 16 of
   32, nemotron 8 of 32), decode equivalence, the float32 serve; for h2o
   also decode past its 4096-token window (``window_check``: 2 layers, a
   4,090-token prompt and 16 steps against one forward, the ring buffer
   wrapping); then in bf16 at full depth ``Engine.generate`` (4 x 512 +
   32) with exactly L x 32 launches of #6 (L of its wgmma prefill, L x 31
   of its split decode, none of its SIMT kernel) and no plain attention,
   and ``Engine.serve``;
17. the MoE pair the same way, through ``models/moe.py``:
   ``grok-1-314b`` (parity at 1 of 64 layers, bf16 at 6) and
   ``kimi-k2-1t-a32b`` (parity at 2 layers, its dense first layer and one
   MoE layer, with 72 of 384 experts so that the capacity drops slots;
   bf16 at 2 layers and all 384 experts); the parity run also holds every
   dispatch's top-k experts and kept slots to the reference's
   (``check_zoo_routes``; a differing route only at a printed routing
   near tie, which ends that row's comparison) and fails unless kimi's
   capacity dropped slots as the reference's did;
18. the encoder-decoder and the VLM (``zoo_encdec_vlm_phase``):
   ``seamless-m4t-medium`` (a 12-layer encoder over 1024 stubbed frames,
   a 12-layer decoder with cross attention) and ``paligemma-3b`` (MQA at
   head_dim 256 after 256 stubbed patch embeddings) through ``zoo_phase``
   at full width and depth, the prefix embeddings from numpy
   (``zoo_prefix``): float32 parity with their fixtures, decode
   equivalence with the prefix, paligemma's text-only float32 serve held
   to the reference's; in bf16 ``Engine.generate`` (4 x 512 + 32 with the
   prefix) with exactly 780 launches of #6 for seamless (36 of its wgmma
   prefill: 12 encoder, 12 decoder and 12 cross attentions; 31 x 24 of
   its split decode) and 576 for paligemma (18 + 31 x 18), none of its
   SIMT kernel and no plain attention; paligemma's ``Engine.serve``
   finishing every request, seamless's raising before any launch, as the
   reference's fails;
19. the zoo's training (``zoo_train_phase``): (a), in phase 3, #6's
   backward at ``FLASH_BWD_SHAPES`` in both dtypes through the route
   ``kernel.bwd_kernel_for`` picks (the tensor-core pair ``bwd_dq_wgmma``
   + ``bwd_dkdv_wgmma`` in bf16, the SIMT pair ``bwd_dq`` + ``bwd_dkdv``
   in float32), the bf16 cases also through the SIMT pair forced and
   timed in turns with it; (b) float32 tinyllama-1.1b training against its
   fixture, each kernel of the SIMT pair launched 22 times a step; (c) five
   bf16 steps, each kernel of the tensor-core pair launched 22 times a step
   and none of the SIMT pair; (d) ``train_local`` of every
   transformer-family arch reduced, both kernels of its route launched;
20. the recurrent families' training (``recurrent_train_phase``): (a), in
   phase 3, the backward of #7 and of #8 (two kernels each, a boundary
   pass and a chunk pass, the chunked forms on 3xTF32 tensor cores; the
   JAX package has none) at ``WKV_BWD_CASES`` and ``SSM_BWD_CASES``: the
   training shapes, a ragged T, with and without state0 and a final
   state's gradient, decays that round to 0, against
   ``ref.wkv_bwd_ref`` / ``ref.selective_scan_bwd_ref``, three runs bit
   for bit, each timed at its training shape (its ``-Xptxas -v`` lines in
   phase 2); (b) ``rwkv6-3b`` at 4 layers and ``zamba2-1.2b`` at 8, full
   width, float32, against their fixtures (``RECURRENT_TRAIN``), each
   scan's chunked forward and backward once a layer and step, Zamba2's
   shared block on #6's SIMT pair; (c) each at full depth in bf16, five
   AdamW steps at 4 x 512: step wall, busy device time, idle share, the
   scans' backward share of it, peak memory; (d) ``train_local`` of each
   reduced.  Phases 4-18 launch no backward kernel (checked after phases
   10 and 18);
21. the dry run against the card (``dryrun_phase``): the bf16 steps of
   phases 19 (c) and 20 (c) are not run again; each arch's step is traced
   on ``meta`` tensors through ``launch/dryrun.py: run_one`` at
   ``InputShape(..., 512, 4, "train")`` and held to what those steps
   measured: (a) the trace's params and AdamW state bytes equal to the
   bytes the run's tensors requested from the caching allocator, and
   ``torch.cuda.memory_allocated``'s growth within the allocator's
   rounding (``alloc_rounding``); (b) the trace's FLOPs
   outside the port's kernels against ``FlopCounterMode``'s count of the
   run's first step on the card, exactly (the card's kernels, launched
   through ``ctypes``, are invisible to the counter); printed without a
   gate: (c) the trace's peak over ``torch.cuda.max_memory_allocated``,
   (d) ``model_flops`` over the busy device time at 989e12 FLOP/s, beside
   ``nvidia-smi``'s name and power limit;
22. the launcher's default mode and the legacy trainer
   (``calibrated_phase``): (a) the calibrated Table-3 simulation as the
   README gives it, ``edge_cloud.run_calibrated`` of ``--deployment all
   --windows 25`` (the speed fit's 100 epochs) and of ``--fast --quantized
   --static``, each calibrating on the card: one launch of #1 a predict
   (six) and two at the compiled fit's first mask check, #2 and #3 once a
   step of its two fits (2 x epochs x 4), no other kernel; every publish
   of the reference's bytes (model 44,000 B, 11,256 int8; window 5,000;
   result 1,000), edge-centric failing every window, the paper's
   orderings; then ``launch.calibrate`` once more for one ``CostModel``:
   the reference's constants, every measured time above 0, two
   simulations of it equal, dynamic weighting dearer than static; (b) the
   legacy ``training.train_loop.fit`` loop from the reference's draws
   (``tests/data/torch_parity_legacy_fit.npz``: the calibration's window
   min-max scaled, 100 epochs of 64, 64, 64 and a ragged 58), the trained params within
   ``LEGACY_ATOL`` of the reference's, #2 and #3 launched 400 times each
   at those rows, then its wall beside a compiled fit's of the same
   window, and both's busy device time and idle share over their first
   ``PROFILED_EPOCHS`` epochs.

Every kernel is built in phase 2 and held to its plain version in phase 3
(#6 also at the served shapes of phases 16-18: their GQA ratios, MHA,
D = 120 and 128, kimi's D = 112 in bf16 and float32, and phase 18's
seamless calls that are not causal and paligemma's D = 256 MQA, in both
dtypes, ``FLASH_ENCDEC_VLM``).
The one-step cell (#5) is held there at the reference's sweep, the serving
rows and H up to 1024 (beyond the sequence kernels' shared memory), every
case twice, bit for bit.  Flash attention (#6) is three kernels, one
launch a call, picked by ``kernel.kernel_for``: the split decode, the
wgmma prefill and the SIMT kernel; phase 3 runs each case through the one
the rule picks and names it, holds the wgmma prefill's bf16 output also
within ``FLASH_TC_TOL``, reruns the two new kernels bit for bit, and times
each new kernel against the SIMT kernel in turns beside SDPA (at
tinyllama's GQA shapes, zamba2's MHA ones, seamless's encoder and cross
attentions and paligemma's D = 256 prefill and decode), by CUDA events
and by the profiler.  The WKV scan (#7) and the selective scan (#8) are two
kernels each, one launch a call, picked by ``kernel.kernel_for``: the
row-split decode for T <= 8, the chunked prefill on the tensor cores
otherwise; phase 3 runs each case through the one the rule picks and
names it, holds it also to its own algorithm (``ref.wkv_chunked_ref`` and
``ref.ssd_chunked_ref`` in 3xTF32, ``ref.wkv_decode_rows_ref`` and
``ref.ssm_decode_rows_ref``) run on the card, and times each at its
served shape by its profiler name.  No single PyTorch call computes #7
or #8.

It prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  The helpers above ``main`` need no
GPU; the port's CPU tests drive the same paths through them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "torch_parity_lstm_paper.npz"

# fixture name -> (mode, dwa_solver) of HybridStreamAnalytics
MODES = {
    "dynamic_closed_form": ("dynamic", "closed_form"),
    "dynamic_scipy": ("dynamic", "scipy"),
    "static_0.3": (("static", 0.3), "closed_form"),
    "speed": ("speed", "closed_form"),
    "batch": ("batch", "closed_form"),
}
RECORD_COLUMNS = ("window", "rmse_batch", "rmse_speed", "rmse_hybrid",
                  "w_speed", "w_batch")

# kernel phase: (B, T, F, H, x dtype[, weights' dtype]); H=None is the
# largest H that fits; the weights are float32 unless a case names bfloat16
# (the wrappers cast those once).  Every row count the main paths give the
# serving kernel is a case: 250 and 245 (the windows), 256 and 245 (window
# 0's mask check, padded and not), 2048 and 1595 (the pretrain's mask check),
# and the placement plane's LoadForecaster (16 rows, its mask check, and one,
# its forecast, at T = 4, F = 1, H = 8: 32 gate columns, one warp);
# then the kernel's other paths: wh from shared memory (H = 10, not a
# multiple of 4; H = 72, over 64), two chunks of steps (T = 9, 12) and x
# read from global memory (F = 449, where a chunk of x does not fit)
MAIN_SHAPE = (250, 5, 5, 40)
KERNEL_CASES = [
    (*MAIN_SHAPE, "float32"),
    (245, 5, 5, 40, "float32"),
    (256, 5, 5, 40, "float32"),
    (1595, 5, 5, 40, "float32"),
    (2048, 5, 5, 40, "float32"),
    (1, 1, 1, 8, "float32"),
    (129, 7, 3, 40, "float32"),
    (1024, 5, 5, 40, "float32"),
    (250, 5, 5, None, "float32"),
    (*MAIN_SHAPE, "bfloat16"),
    (*MAIN_SHAPE, "float32", "bfloat16"),
    (*MAIN_SHAPE, "bfloat16", "bfloat16"),
    (33, 9, 5, 10, "float32"),
    (40, 12, 5, 72, "float32"),
    (3, 4, 449, None, "float32"),
    (16, 4, 1, 8, "float32"),
    (1, 4, 1, 8, "float32"),
]
KERNEL_ATOL = 1e-5
# the training pair: the speed fit's and the pretrain's step shapes, the
# reference's gradient-test shapes, the backward's largest H (H=None: one
# step a chunk), bf16 x, and bf16 weights (the backward then takes their
# float32 copies, as ops.lstm_sequence hands them over); then a ragged last
# tile of both kernels' 2-row tiles at 4H = 160 (the reference's shapes
# leave ragged tiles at their own widths too), one row, a long T (8 chunks
# of 8 steps in both kernels), two H whose wh stays in shared memory
# (H = 10, not a multiple of 4; H = 72 > 64), the second over two chunks,
# and the largest H at F = 449, where #2's shared memory has no room for
# x (read from global memory instead) and #3 runs one row and one step a
# block; last the LoadForecaster's fit (16 rows, T = 4, F = 1, H = 8) and
# one row of it
# the speed fit's and the pretrain's step shapes, and the legacy fit's
# ragged last minibatch of 250 examples in batches of 64 (phase 22)
TRAIN_SHAPES = ((64, 5, 5, 40), (256, 5, 5, 40), (58, 5, 5, 40))
TRAIN_CASES = [
    (*TRAIN_SHAPES[0], "float32"),
    (*TRAIN_SHAPES[1], "float32"),
    (*TRAIN_SHAPES[2], "float32"),
    (33, 7, 3, 16, "float32"),
    (1, 1, 2, 8, "float32"),
    (130, 12, 4, 24, "float32"),
    (64, 5, 5, None, "float32"),
    (*TRAIN_SHAPES[0], "bfloat16"),
    (*TRAIN_SHAPES[0], "float32", "bfloat16"),
    (63, 5, 5, 40, "float32"),
    (1, 5, 5, 40, "float32"),
    (64, 64, 5, 40, "float32"),
    (17, 6, 3, 10, "float32"),
    (40, 9, 5, 72, "float32"),
    (3, 4, 449, None, "float32"),
    (16, 4, 1, 8, "float32"),
    (1, 4, 1, 8, "float32"),
]
# the backward's tolerance is the reference's own for its gradient tests
# (tests/test_kernels.py); the card sums in another order than the plain
# version
BWD_ATOL = BWD_RTOL = 2e-5
# the trained models and records on the card against the reference's
TRAIN_ATOL = 1e-4
# kernel #4, (M, K, N, x dtype): the bus path's products at B=250 and at the
# warm-up's 245 (input projection (B*T, F) @ (F, 4H), one recurrent step
# (B, H) @ (H, 4H), Dense(10)), the reference's edge shapes
# (tests/test_kernels.py), and bf16 x
INT8_MAIN = (250, 40, 160)
INT8_SHAPES = ((1250, 5, 160), INT8_MAIN, (250, 40, 10))
INT8_CASES = [
    *((*shape, "float32") for shape in INT8_SHAPES),
    (1225, 5, 160, "float32"),
    (245, 40, 160, "float32"),
    (245, 40, 10, "float32"),
    (1, 1, 1, "float32"),
    (33, 100, 17, "float32"),
    (128, 512, 128, "float32"),
    (*INT8_MAIN, "bfloat16"),
]
# atol = rtol = 1e-5 where K <= 40; at K >= 100 the reference's own 1e-3
# (tests/test_kernels.py), where sums of hundreds of terms of up to 127|x|
# differ in order between the card and the plain version
INT8_TOL = 1e-5
INT8_TOL_DEEP = 1e-3
# the bus path: the deployments, and the cost model of the reference's
# tests/test_executor.py (only the Kafka ingest charge is set)
BUS_DEPLOYMENTS = ("edge-cloud-integrated", "cloud-centric", "edge-centric")
BUS_INGEST_S = 0.5
# model-topic bytes of one lstm-paper publish: 7,781 float32 parameters, or
# the int8 tree of quantize_tree(min_size=64)
FLOAT_MODEL_NBYTES = 31_124
INT8_MODEL_NBYTES = 9_644
# int8 speed predictions on the bus against the reference's (its forward
# through qmatmul in interpret mode)
INT8_PRED_ATOL = 1e-5
# phase 22: the launcher's calibrated mode as the README runs it, then with
# the other flags; the reference's non-timing constants of
# benchmarks/calibrate.py at 250 records a window (model_nbytes its 44,000
# B, not the 31,124 B a float publish moves; --quantized 44,000 / 4 + 256)
CALIBRATED_WINDOWS = 25
CALIBRATED_RUNS = {
    "default": ["--deployment", "all", "--windows", "25"],
    "fast_quantized_static": ["--deployment", "all", "--windows", "25",
                              "--fast", "--quantized", "--static"]}
CALIBRATED_RPW = 250
CALIBRATED_CONSTANTS = {"ingest_s": 250 / 7.0 * 0.45,
                        "model_nbytes": 44_000.0, "window_nbytes": 5_000,
                        "result_nbytes": 1_000}
CALIBRATED_INT8_NBYTES = 11_256.0
# the Table-3 rows whose computation is a measured time
ROWS_COMPUTED = ("batch_inference", "speed_inference", "hybrid_inference",
                 "speed_training")
# the legacy per-minibatch fit from the reference's draws (calibrate's
# window, min-max scaled: 250 examples, 100 epochs of 64, 64, 64, 58)
LEGACY_FIXTURE = ROOT / "tests" / "data" / "torch_parity_legacy_fit.npz"
LEGACY_ATOL = 1e-4
# the epochs of each fit the phase profiles (busy time, idle share)
PROFILED_EPOCHS = 10
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor
# cores, at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# and the bf16 and TF32 tensor-core rates (dense)
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_TF32_FLOP_PER_S = 495e12
# the zoo's serving path: tinyllama-1.1b through the port's Engine.  The
# parity run (tests/data/torch_parity_tinyllama.npz, written by the JAX
# reference): full width and depth in float32, params from numpy seed
# ZOO_SEED, 2 prompts of 32 tokens, 8 greedy tokens, each step's logsumexp
# and top 64 (id, logit) pairs.  Logits held at ZOO_LOGIT_ATOL: float32
# products of depth 2048 and 5632 over 22 layers, summed in another order
# on the card than on the reference's CPU
ZOO_ARCH = "tinyllama-1.1b"
ZOO_FIXTURE = ROOT / "tests" / "data" / "torch_parity_tinyllama.npz"
ZOO_SEED = 0
ZOO_PROMPTS = (2, 32)
ZOO_NEW_TOKENS = 8
ZOO_TOPK = 64
ZOO_LOGIT_ATOL = 2e-3
# the served run in the config's bf16: Engine.generate at (batch, prompt,
# new tokens), and Engine.serve's request mix on 4 slots
SERVE_GENERATE = (4, 512, 32)
SERVE_MAX_LEN = 544
SERVE_PROMPT_LENS = (17, 300, 64, 129, 33, 250, 100, 200)
SERVE_NEW_TOKENS = (8, 32, 16, 24, 12, 32, 8, 20)
SERVE_SLOTS = 4
# Engine.serve held to the reference in float32 at full width (the parity
# fixtures' serve_* arrays): four requests on two slots, so that two slots
# are freed and refilled (the cache scatter); the first tick prefills a
# bucket of 32 (prompts 17 and 30), each refill one of 64 (prompts 64 and
# 33), so #6, #7 and #8 take their prefill kernels at two T
SERVE_CHECK_PROMPT_LENS = (17, 30, 64, 33)
SERVE_CHECK_NEW_TOKENS = (8, 12, 16, 10)
SERVE_CHECK_SLOTS = 2
SERVE_CHECK_MAX_LEN = 80
SERVE_CHECK_SEED = ZOO_SEED + 3
# step-by-step decode against one full forward, float32 on the card (the
# reference's tests/test_decode_equivalence.py tolerance)
DECODE_EQ_ATOL = 2e-3
# the zoo's RWKV6 serving path: rwkv6-3b through the port's Engine, its
# parity fixture written by the JAX reference as the tinyllama one is (the
# same seed, prompts, new tokens, top-k and tolerances); the served run at
# SERVE_GENERATE and the serve mix on SERVE_SLOTS
RWKV_ARCH = "rwkv6-3b"
RWKV_FIXTURE = ROOT / "tests" / "data" / "torch_parity_rwkv6_3b.npz"
# kernel #6 against its plain version: the reference's tolerances
# (tests/test_kernels.py: tol), atol = rtol
FLASH_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
# (B, H, S, D, causal, window) of tests/test_kernels.py's
# test_flash_attention_sweep, one KV head per query head
FLASH_SWEEP = ((2, 2, 128, 32, True, 0), (1, 4, 256, 64, True, 0),
               (2, 2, 100, 32, True, 0), (2, 2, 250, 32, True, 64),
               (1, 2, 77, 16, False, 0))
# the served shapes: (B, Sq, Sk, Hq, Hkv, D) of one layer's prefill
# attention and of generate's last decode step
FLASH_PREFILL = (4, 512, 512, 32, 4, 64)
FLASH_DECODE = (4, 1, 544, 32, 4, 64)
# kernel #7 against its plain version: the reference's tolerance
# (tests/test_kernels.py: test_rwkv6_scan_sweep), atol = rtol
WKV_TOL = 1e-4
# (BH, T, N) of tests/test_kernels.py::test_rwkv6_scan_sweep
WKV_SWEEP = ((4, 64, 16), (2, 100, 32), (3, 17, 8), (1, 256, 64))
# the served shapes (B, T, H, N) of rwkv6-3b: one layer's prefill of
# SERVE_GENERATE and one decode step
WKV_PREFILL = (4, 512, 40, 64)
WKV_DECODE = (4, 1, 40, 64)
# the zoo's hybrid serving path: zamba2-1.2b through the port's Engine, its
# parity fixture written by the JAX reference as the other two are; its
# shared block is MHA (32 query heads, 32 KV heads), and kernel #6 is held
# and timed at its shapes too: (B, Sq, Sk, Hq, Hkv, D) of the served
# prefill and of generate's last decode step
ZAMBA_ARCH = "zamba2-1.2b"
ZAMBA_FIXTURE = ROOT / "tests" / "data" / "torch_parity_zamba2_1_2b.npz"
FLASH_MHA_PREFILL = (4, 512, 512, 32, 32, 64)
FLASH_MHA_DECODE = (4, 1, 544, 32, 32, 64)
# the rest of the zoo's transformers, phases 16 (the dense trio) and 17 (the
# MoE pair), through the port's Engine with every attention in #6: each
# arch's parity fixture, written by the JAX reference as the other three
# are, from a parity config cut in depth (and kimi in experts) so that its
# float32 params fit this repo's fixture host and the card
# (PARITY_CUTS), and a bf16 served config cut in depth where the card
# cannot hold the whole model (SERVED_LAYERS).  Widths are never cut.
DENSE_ARCHS = ("h2o-danube-3-4b", "codeqwen1.5-7b", "nemotron-4-15b")
MOE_ARCHS = ("grok-1-314b", "kimi-k2-1t-a32b")
NEW_ZOO_ARCHS = DENSE_ARCHS + MOE_ARCHS


def zoo_fixture(arch: str) -> Path:
    return ROOT / "tests" / "data" / (
        "torch_parity_" + arch.replace("-", "_").replace(".", "_") + ".npz")


# phase 18: the encoder-decoder and the VLM, through the port's Engine
# with every attention in #6, parity at full width and depth (no cut),
# their fixtures written by the JAX reference as the others are.  Their
# frontends are stubs: the frames or patches are embeddings (batch,
# n_prefix_tokens, embed_dim), standard normal from numpy seed
# PREFIX_SEED (the parity run) or PREFIX_SEED + 1 (the served run)
ENCDEC_ARCH = "seamless-m4t-medium"
VLM_ARCH = "paligemma-3b"
ENCDEC_VLM_ARCHS = (ENCDEC_ARCH, VLM_ARCH)
# arch -> the parity config's n_layers and n_experts (0: the arch's own)
PARITY_CUTS = {"h2o-danube-3-4b": (24, 0), "codeqwen1.5-7b": (16, 0),
               "nemotron-4-15b": (8, 0), "grok-1-314b": (1, 0),
               "kimi-k2-1t-a32b": (2, 72), ENCDEC_ARCH: (0, 0),
               VLM_ARCH: (0, 0)}
PREFIX_SEED = ZOO_SEED + 5
# the bf16 generate's #6 launches: seamless 12 encoder self, 12 decoder
# self and 12 cross attentions a prefill and 24 a decode step (36 + 31 x
# 24); paligemma 18 (18 + 31 x 18)
ENCDEC_VLM_LAUNCHES = {ENCDEC_ARCH: 780, VLM_ARCH: 576}
# arch -> the bf16 served config's n_layers (the arch's own where absent):
# grok's 64 layers are 9.8 GB of bf16 experts each, kimi's 60 MoE layers
# 34 GB each
SERVED_LAYERS = {"grok-1-314b": 6, "kimi-k2-1t-a32b": 2}
# the new fixtures' numpy draws: each leaf in pieces of DRAW_CHUNK samples,
# piece i from its own generator (seed, crc32 of the path, i), drawn by
# threads (the older fixtures draw each leaf whole, DRAW_CHUNK 0)
DRAW_CHUNK = 1 << 26
# a routed token's routing margin: the smallest gap between adjacent
# router probabilities among its top k + 1, the reference's.  The port may
# route a token otherwise than the reference only where that margin is
# below ZOO_ROUTE_ATOL (a near tie of float32 sums); it ends that row's
# comparison, as a logit near tie does
ZOO_ROUTE_ATOL = 2e-5
# h2o-danube-3-4b's window on the card: decode past it at full width, 2
# layers, float32: a prompt of WINDOW_CHECK[0] tokens, WINDOW_CHECK[1]
# decode steps against one forward over both (the ring buffer wraps)
WINDOW_CHECK = (4090, 16)
# #6 at the new configs' served GQA ratios and head dims in phase 3:
# (B, Sq, Sk, Hq, Hkv, D) of a served prefill layer and of generate's last
# decode step, by label; kimi's D = 112 also in float32
FLASH_ZOO_SHAPES = {
    "h2o 4:1 d120": ((4, 512, 512, 32, 8, 120), (4, 1, 544, 32, 8, 120)),
    "codeqwen mha d128": ((4, 512, 512, 32, 32, 128),
                          (4, 1, 544, 32, 32, 128)),
    "6:1 d128": ((4, 512, 512, 48, 8, 128), (4, 1, 544, 48, 8, 128)),
    "kimi 8:1 d112": ((4, 512, 512, 64, 8, 112), (4, 1, 544, 64, 8, 112)),
}
# #6 at phase 18's served shapes in phase 3, each in bf16 and float32:
# label -> ((B, Sq, Sk, Hq, Hkv, D), causal, the positions' kind).
# seamless-m4t-medium (MHA 16:16, D = 64) is not causal in the encoder's
# self attention and in every cross attention (queries at position 0, the
# encoder's 1024 frames); paligemma-3b is MQA 8:1 at D = 256, its prefill
# the 256 patches and 512 tokens, its decode generate's last step
FLASH_ENCDEC_VLM = {
    "seamless encoder": ((4, 1024, 1024, 16, 16, 64), False, "full"),
    "seamless cross prefill": ((4, 512, 1024, 16, 16, 64), False, "cross"),
    "seamless cross decode": ((4, 1, 1024, 16, 16, 64), False, "cross"),
    "paligemma prefill": ((4, 768, 768, 8, 1, 256), True, "arange"),
    "paligemma decode": ((4, 1, 800, 8, 1, 256), True, "last"),
}
# kernel #6's timed shapes: label -> (shape, the positions' kind); "full"
# and "cross" are not causal
# kernel A's bf16 output against the plain version: about two bf16 steps
# (one rounding of the output either way).  It cannot tell P_hi + P_lo
# from a single bf16 pass of P (that moves the output by ~1e-3), so
# FLASH_TC_SHARE and the count of elements equal to the SIMT kernel's do
FLASH_TC_TOL = 1e-2
# a bf16 output of kernels A and B against the float32 result of its own
# algorithm (ref.attend_tc_ref, ref.flash_decode_split_ref) on the same
# inputs: one rounding to bf16 (half a step, at most 2^-8 of the value)
# and the f32 sums' order; a dropped 64-key split or lane group moves a
# decode output of ~0.07 by ~1e-2
FLASH_STEP_RTOL, FLASH_STEP_ATOL = 2.0**-8, 1e-3
# kernel A's bf16 output: the largest share of elements that may differ
# from ref.attend_tc_ref's bf16 output on the same inputs (the f32 sums'
# order flips a rounding now and then; a P without P_lo flips far more)
FLASH_TC_SHARE = 0.01
# phase 19 (a): #6's backward at the zoo's training shapes: label ->
# ((B, Sq, Sk, Hq, Hkv, D), causal, window, the positions' kind), each in
# float32 and bf16: tinyllama-1.1b's training shape, a window shorter than
# S, seamless-m4t-medium's encoder and cross attention, paligemma-3b's MQA
# at D = 256, a batch with unwritten slots and a fully masked row,
# nemotron-4-15b's (and grok-1's) 48:8 heads at D = 128 (G = 6: the
# tensor-core pair's row tiles hold 60 rows of 64, and Sq = 256 is no
# multiple of their 10 queries), and 80 query heads a KV head (a second
# row tile of 16 heads past G)
FLASH_BWD_SHAPES = {
    "tinyllama train": ((4, 512, 512, 32, 4, 64), True, 0, "arange"),
    "window 256": ((4, 512, 512, 32, 8, 120), True, 256, "arange"),
    "seamless encoder": ((2, 1024, 1024, 16, 16, 64), False, 0, "full"),
    "seamless cross": ((2, 128, 1024, 16, 16, 64), False, 0, "cross"),
    "paligemma": ((2, 768, 768, 8, 1, 256), True, 0, "arange"),
    "holes, a dead row": ((2, 200, 200, 16, 2, 64), True, 0, "holes_dead"),
    "nemotron G 6": ((2, 256, 256, 48, 8, 128), True, 0, "arange"),
    "G 80": ((1, 64, 256, 80, 1, 64), True, 0, "arange"),
}
# the backward's gradients against ref.flash_attend_bwd_ref in float32 on
# the same inputs (and the forward kernel's own o): float32 within
# |d| <= FLASH_BWD_TOL (1 + |want|), the f32 sums' order over up to
# Sq G = 4096 rows; bf16 within a bf16 step (FLASH_STEP_RTOL, ATOL) of the
# float32 result, one rounding on store
FLASH_BWD_TOL = 1e-4
# the backward's four kernels (two routes of two) by a substring of the
# profiler's name
FLASH_BWD_KERNELS = {"bwd_dq": "flash_bwd_dq_kernel",
                     "bwd_dkdv": "flash_bwd_dkdv_kernel",
                     "bwd_dq_wgmma": "flash_bwd_dq_wgmma_kernel",
                     "bwd_dkdv_wgmma": "flash_bwd_dkdv_wgmma_kernel"}
# phase 19 (b): tinyllama-1.1b's training at full width and depth in
# float32 against tests/data/torch_parity_train_tinyllama_1_1b.npz (written
# by the JAX reference: tests/test_torch_zoo_train.py as a script): params
# from numpy_params(cfg, TRAIN_SEED, DRAW_CHUNK), one batch of TRAIN_BATCH
# (B, S) tokens from numpy seed TRAIN_SEED, step 1's loss, xent, global
# gradient norm, every leaf's gradient norm (a norm per layer of a stacked
# leaf) and TRAIN_SAMPLES entries of each leaf's gradient at indices drawn
# from (TRAIN_SEED, crc32 of its path), then the losses of TRAIN_STEPS
# steps of adamw(warmup_cosine(*TRAIN_SCHEDULE))
TRAIN_FIXTURE = ROOT / "tests" / "data" / "torch_parity_train_tinyllama_1_1b.npz"
TRAIN_SEED = ZOO_SEED + 7
TRAIN_BATCH = (2, 128)
TRAIN_SAMPLES = 16
TRAIN_STEPS = 3
TRAIN_SCHEDULE = (1e-4, 1, 3)  # lr, warmup, total
# the stacked leaves' subtrees: a norm per layer
STACK_NAMES = ("layers", "moe_layers", "enc_layers", "dec_layers", "mamba")
# the card's float32 training against the reference's on the CPU (both in
# full float32, TF32 off; the sums' order differs through 22 layers and
# their backward): losses within TRAIN_LOSS_ATOL, the global and every
# leaf's norm within TRAIN_NORM_RTOL of it, each sampled entry within
# TRAIN_SAMPLE_RTOL of its leaf's rms (norm over sqrt(numel))
TRAIN_LOSS_ATOL = 1e-3
TRAIN_NORM_RTOL = 1e-3
TRAIN_SAMPLE_RTOL = 2e-2
# phase 19 (c): tinyllama-1.1b in its own dtypes (bf16 params, float32
# moments), BF16_TRAIN_STEPS steps of adamw(warmup_cosine(*BF16_SCHEDULE))
# on one batch of BF16_TRAIN_BATCH tokens
BF16_TRAIN_BATCH = (4, 512)
BF16_TRAIN_STEPS = 5
BF16_SCHEDULE = (1e-3, 1, 5)
# phase 19 (d): train_local of each transformer-family arch, reduced:
# (steps, batch, seq, lr)
ZOO_TRAIN_ARCHS = ("tinyllama-1.1b", *NEW_ZOO_ARCHS, VLM_ARCH, ENCDEC_ARCH)
LOCAL_TRAIN = (3, 2, 32, 3e-4)
# phase 20: RWKV6's and Zamba2's training.  (a), in phase 3: the backward
# of the WKV scan (#7) and of the selective scan (#8), which the JAX
# package does not have (XLA differentiates its scans), against their
# plain versions (ref.wkv_bwd_ref, ref.selective_scan_bwd_ref): label ->
# (shape, from a state0, with a final state's gradient).  Each gradient
# within RECURRENT_BWD_TOL of its largest |value|: both sides float32, the
# kernel's sums in another order through up to 512 steps.  Sizes that are
# no multiple of 4 take the kernels' 4-byte copies and scalar stores
RECURRENT_BWD_TOL = 1e-4
# the training shapes at BF16_TRAIN_BATCH: rwkv6-3b's (B, T, H, N) and
# zamba2-1.2b's (B, T, H, P, N)
WKV_TRAIN_SHAPE = (4, 512, 40, 64)
SSM_TRAIN_SHAPE = (4, 512, 64, 64, 64)
WKV_BWD_CASES = {"train": (WKV_TRAIN_SHAPE, False, False),
                 "train, state0 and dS_T": (WKV_TRAIN_SHAPE, True, True),
                 "ragged T=77": ((2, 77, 5, 64), True, True),
                 "ragged T=77, no state": ((2, 77, 5, 64), False, False),
                 "dw to 5 (w = 0)": ((2, 100, 4, 64), True, True),
                 "T=1": ((3, 1, 4, 64), True, True),
                 "T=16": ((2, 16, 3, 64), False, True),
                 "T=17 N=24": ((2, 17, 3, 24), True, False),
                 "reduced N=32": ((2, 40, 8, 32), False, False),
                 "N=10 (4-byte copies)": ((2, 21, 3, 10), True, True)}
SSM_BWD_CASES = {"train": (SSM_TRAIN_SHAPE, False, False),
                 "train, state0 and dh_T": (SSM_TRAIN_SHAPE, True, True),
                 "ragged T=77": ((2, 77, 4, 64, 64), True, True),
                 "ragged T=77, no state": ((2, 77, 4, 64, 64), False, False),
                 "dt x 40 (e = 0)": ((2, 50, 4, 64, 64), True, True),
                 "T=1": ((3, 1, 4, 64, 64), True, True),
                 "T=16 P=24": ((2, 16, 3, 24, 64), False, True),
                 "reduced T=33 N=16": ((2, 33, 8, 64, 16), True, False),
                 "P=10 N=6 (4-byte copies)": ((2, 37, 3, 10, 6), True,
                                              True)}
# each backward's two kernels, by the wrapper's name and by a substring of
# the profiler's: a call's device time is the sum over both
WKV_BWD_KERNELS = {"bounds": "rwkv6_bwd_bounds_kernel",
                   "chunk": "rwkv6_bwd_chunk_kernel"}
SSM_BWD_KERNELS = {"bounds": "ssm_bwd_bounds_kernel",
                   "chunk": "ssm_bwd_chunk_kernel"}
# (b) float32 training at full width against the reference's, as phase 19
# (b), from fixtures written by tests/test_torch_rwkv_train.py and
# tests/test_torch_zamba2_train.py as scripts: arch -> (fixture, its
# depth), cut so that the reference's value_and_grad fits a 62 GB CPU host
# (Zamba2's 8 layers run one super-layer of 6 and the 2-layer tail)
RECURRENT_TRAIN = {
    RWKV_ARCH: (ROOT / "tests" / "data" / "torch_parity_train_rwkv6_3b.npz",
                4),
    ZAMBA_ARCH: (ROOT / "tests" / "data"
                 / "torch_parity_train_zamba2_1_2b.npz", 8)}
# (c) each arch at full width and depth in its own dtypes, params from the
# model's init on the card, BF16_TRAIN_STEPS steps of
# adamw(warmup_cosine(*BF16_SCHEDULE)) on one batch of BF16_TRAIN_BATCH;
# (d) train_local of each, reduced, LOCAL_TRAIN
RECURRENT_ARCHS = (RWKV_ARCH, ZAMBA_ARCH)
# phase 21 (a): the CUDA caching allocator rounds every block up to a
# multiple of ALLOC_ROUND bytes, and splits a free block for a request
# over ALLOC_SMALL only when more than ALLOC_SMALL would be left
ALLOC_ROUND = 512
ALLOC_SMALL = 1 << 20
# kernel #6's three kernels, by a substring of the profiler's name
# the LSTM sequence kernels, by a substring of the profiler's name: #1, #2,
# and #3's two launches a call
SERVE_FWD_KERNEL = "lstm_serve_fwd_kernel"
TRAIN_FWD_KERNEL = "lstm_train_fwd_kernel"
BWD_KERNELS = ["lstm_bwd_time_kernel", "lstm_bwd_combine_kernel"]
FLASH_KERNELS = {"simt": "flash_attention_kernel",
                 "prefill_wgmma": "flash_prefill_wgmma_kernel",
                 "decode_split": "flash_decode_split_kernel"}
# kernel #8's two kernels by a substring of the profiler's name, and the
# kernel of each zoo wrapper that takes a prefill and a decode step
SSM_KERNELS = {"chunked": "ssm_chunked_kernel",
               "decode_rows": "ssm_decode_kernel"}
# kernel #7's two kernels by a substring of the profiler's name
WKV_KERNELS = {"chunked": "rwkv6_chunked_kernel",
               "decode_rows": "rwkv6_decode_kernel"}
# every kernel of the port by a substring of the profiler's name: a zoo
# generate's device time is summed for each
PORT_KERNELS = (SERVE_FWD_KERNEL, TRAIN_FWD_KERNEL, *BWD_KERNELS,
                "lstm_cell_kernel", "int8_matmul_kernel",
                *FLASH_KERNELS.values(), *WKV_KERNELS.values(),
                *SSM_KERNELS.values())
PREFILL_DECODE = {"flash_attention": ("prefill_wgmma", "decode_split"),
                  "ssm_scan": ("chunked", "decode_rows"),
                  "rwkv6_scan": ("chunked", "decode_rows")}
FLASH_TIMED = (("prefill", FLASH_PREFILL, "arange"),
               ("decode", FLASH_DECODE, "last"),
               ("mha_prefill", FLASH_MHA_PREFILL, "arange"),
               ("mha_decode", FLASH_MHA_DECODE, "last"),
               ("encoder", FLASH_ENCDEC_VLM["seamless encoder"][0], "full"),
               ("cross_prefill",
                FLASH_ENCDEC_VLM["seamless cross prefill"][0], "cross"),
               ("cross_decode", FLASH_ENCDEC_VLM["seamless cross decode"][0],
                "cross"),
               ("d256_prefill", FLASH_ENCDEC_VLM["paligemma prefill"][0],
                "arange"),
               ("d256_decode", FLASH_ENCDEC_VLM["paligemma decode"][0],
                "last"))
# kernel #8 against its plain version: the reference's tolerance
# (tests/test_kernels.py: test_ssm_scan_sweep), atol = rtol
SSM_TOL = 1e-4
# (BH, T, P, N) of tests/test_kernels.py::test_ssm_scan_sweep
SSM_SWEEP = ((4, 64, 16, 16), (2, 90, 32, 16), (1, 33, 8, 8))
# the served shapes (B, T, H, P, N) of zamba2-1.2b: one layer's prefill of
# SERVE_GENERATE and one decode step
SSM_PREFILL = (4, 512, 64, 64, 64)
SSM_DECODE = (4, 1, 64, 64, 64)
# kernel #5 against its plain version, (B, F, H, x, h, c and weights'
# dtypes): the reference's sweep (tests/test_kernels.py::
# test_lstm_cell_sweep) with every input float32, then every input bfloat16;
# the rows a serving window gives a step (250, window 0's 245, its padded
# 256); bf16 h with float32 c; and two H beyond the sequence kernels' shared
# memory (H <= 117 at F = 5).  Float32 outputs within CELL_ATOL (the
# reference's tol), bf16 ones within one bf16 step of the value
CELL_MAIN = (250, 5, 40)
CELL_SWEEP = ((4, 5, 40), (128, 5, 40), (33, 7, 16), (1, 1, 8))
F32, BF16 = ("float32",) * 4, ("bfloat16",) * 4
CELL_CASES = [
    *((*shape, F32) for shape in CELL_SWEEP),
    *((*shape, BF16) for shape in CELL_SWEEP),
    *((*shape, F32) for shape in (CELL_MAIN, (245, 5, 40), (256, 5, 40),
                                  (250, 5, 512), (250, 5, 1024))),
    (*CELL_MAIN, ("float32", "bfloat16", "float32", "float32")),
]
CELL_ATOL = 2e-5
# kernel #5's profiler name (a part of both its kernels' names); the rows
# a block its device time is measured at (kernel.cell_tiling takes 1 at
# CELL_MAIN); a width beyond the sequence kernels' shared memory it is also
# timed at
CELL_KERNEL = "lstm_cell_kernel"
CELL_ROWS_TIMED = (1, 2, 4)
CELL_WIDE = (250, 5, 512)


# the fleet: S streams of the paper's LSTM (lstm-paper at its published
# width, H 40, F 5, lag 5), BENCH_fleet.json's configuration (8 streams x 8
# windows x 250 records, 10 epochs, batch 64), then 64 streams
FLEET_STREAMS = (8, 64)
FLEET_WINDOWS = 8
FLEET_RPW = 250
FLEET_EPOCHS = 10
FLEET_BATCH = 64
# the rows a fleet predict hands #1 and #4 at a window of 250 records: the
# batch padded to its power-of-two bucket
FLEET_PREDICT_ROWS = 256
# the fixture of the fleet's parity (tests/test_torch_fleet.py writes it from
# the JAX reference), held on the card to the records' tolerance
FLEET_FIXTURE = ROOT / "tests" / "data" / "torch_parity_fleet.npz"
FLEET_ATOL = 1e-4
# the stream-axis kernels against their plain versions: S, and (B, T, F, H,
# x dtype) of #1 and of #2 + #3 (a serving window, a speed-fit step, a
# ragged batch with wh in shared memory and bf16 x), and (M, K, N, x dtype)
# of #4 (the int8 fleet predict's three products and bf16 x); then a
# serving tick's row bucket (4 rows, the slots) and its three int8 products
FLEET_KERNEL_S = (1, 3, 8)
FLEET_LSTM_CASES = ((250, 5, 5, 40, "float32"), (64, 5, 5, 40, "float32"),
                    (37, 5, 5, 10, "bfloat16"), (4, 5, 5, 40, "float32"))
FLEET_INT8_SHAPES = ((5 * FLEET_PREDICT_ROWS, 5, 160),
                     (FLEET_PREDICT_ROWS, 40, 160),
                     (FLEET_PREDICT_ROWS, 40, 10))
FLEET_INT8_CASES = (*((*shape, "float32") for shape in FLEET_INT8_SHAPES),
                    (250, 40, 160, "bfloat16"), (20, 5, 160, "float32"),
                    (4, 40, 160, "float32"), (4, 40, 10, "float32"))

# the request and placement planes: the reference's runs on the fixture's
# fleet (tests/test_torch_query_plane.py writes them from the JAX package)
REQUEST_FIXTURE = ROOT / "tests" / "data" / "torch_parity_requests.npz"
# the runs: name -> (int8 sync?, elastic?), all in the integrated deployment
# at a 5 s window period under fixed stage costs, so every stamp is a sum of
# fixed costs
REQUEST_RUNS = {"serve_float": (False, False),
                "serve_int8": (True, False),
                "elastic_spike": (False, True)}
# answers to the reference's, absolute; each LoadForecaster forecast,
# relative; batched answers to unbatched ones (bench_serving's gate)
REQUEST_ATOL = 1e-5
FORECAST_RTOL = 1e-5
UNBATCHED_ATOL = 1e-6
# the scale-ahead ramp of tests/test_placement.py: per-worker edge loads fed
# to a proactive controller, tick by tick, until it scales
RAMP_LOADS = tuple(0.07 * (k + 1) for k in range(10))
# the LoadForecaster's fit and predict shapes (B, T, F, H): a 16-row bucket
# of lag-4 one-feature windows, H = 8, and one row
LOAD_FIT_SHAPE = (16, 4, 1, 8)
LOAD_PREDICT_SHAPE = (1, 4, 1, 8)
# the request plane at scale (phase 13 (d)): lstm-paper fleets of S streams
# at the launcher's fast settings (BENCH_fleet.json's: 250 records a window,
# 10 epochs at batch 64) over REQUEST_WINDOWS windows of a 5 s period, at
# (S, offered QPS, slots): BENCH_serving.json's rate at 8 streams, then 64
REQUEST_SCALE = ((8, 20.0, 4), (64, 200.0, 16))
REQUEST_WINDOWS = 4
REQUEST_SCALE_PERIOD = 5.0
# a warm tick's busy time and idle share: means over this many ticks
TICK_PROFILE_CALLS = 50
# the launcher with both planes on (phase 14 (c))
PLANES_LAUNCHER = ["--real", "--streams", "8", "--windows", "4", "--fast",
                   "--qps", "20", "--slots", "4", "--elastic",
                   "--deployment", "integrated"]

# the chaos and health planes (phase 15): the reference's runs on the fleet
# fixture's fleet (tests/test_torch_chaos.py writes them from the JAX package)
CHAOS_FIXTURE = ROOT / "tests" / "data" / "torch_parity_chaos.npz"
CHAOS_SCENARIOS = ("fault_free", "site_crash", "partitioned_sync",
                   "sensor_chaos", "corrupted_int8_sync", "forged_sync",
                   "byzantine", "compound_drift")
# the runs: name -> (scenario, adaptive thresholds?), each in the integrated
# deployment under the scenario's fault plane and a health plane, at
# CHAOS_SETUP under the reference's fixed stage costs (CHAOS_STAGE_COSTS)
CHAOS_RUNS = {**{name: (name, True) for name in CHAOS_SCENARIOS},
              "fault_free_static": ("fault_free", False)}
# ChaosHarness's defaults and BENCH_chaos.json's config: a 5 s period, 8 qps
# on 4 slots, staleness bound 1, fault seed 0
CHAOS_SETUP = {"period": 5.0, "qps": 8.0, "slots": 4, "staleness_bound": 1,
               "fault_seed": 0, "ingest_s": BUS_INGEST_S}
# tests/test_query_plane.py's delayed-sync watchdog run: every model publish
# from 0.8 periods on delayed 3 periods, 30 requests at 3 qps from 2
# periods (trace seed 3), 3 windows, no health plane, default costs model
WATCHDOG_RUN = "watchdog_delayed_sync"
WATCHDOG = {"n_windows": 3, "qps": 3.0, "n_requests": 30, "start": 10.0,
            "trace_seed": 3, "delay_s": 15.0, "fault_start": 4.0,
            "fault_seed": 0}
# an envelope's RMSE to the reference's, relative
CHAOS_RMSE_RTOL = 1e-5
# the envelope's fields read with CHAOS_RMSE_RTOL; every other is exact
CHAOS_FLOAT_FIELDS = ("rmse_hybrid",)
# phase 15 (b): the port's own ChaosHarness at BENCH_chaos.json's config
CHAOS_BENCH = {"n_streams": 3, "n_windows": 6, "records_per_window": 120,
               "period_s": 5.0, "qps": 8.0, "serve_slots": 4,
               "staleness_bound": 1}
# phase 15 (c): the fleet phase's shape at S = 64, 64 qps on 16 slots
CHAOS_SCALE = {"n_streams": 64, "n_windows": 6, "records_per_window": 250,
               "period_s": 5.0, "qps": 64.0, "serve_slots": 16,
               "staleness_bound": 1}
CHAOS_SCALE_SCENARIOS = ("partitioned_sync", "forged_sync", "sensor_chaos")


def _import_port():
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise FileNotFoundError(
            f"the port's package is missing under {src}; run this script "
            "from a checkout of the repository")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))


# ---------------------------------------------------------------------------
# The main path, on any device
# ---------------------------------------------------------------------------


def load_fixture(path: Path = FIXTURE) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def unflatten(arrays: dict, prefix: str) -> dict:
    """``prefix/a/b`` keys -> nested ``{"a": {"b": ...}}``."""
    tree: dict = {}
    for name, v in arrays.items():
        if not name.startswith(prefix + "/"):
            continue
        *path, leaf = name[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def records_array(records) -> np.ndarray:
    return np.array([[getattr(r, c) for c in RECORD_COLUMNS] for r in records],
                    np.float64)


def port_data(setup: dict):
    """The scaled windowed stream and the scaled history of the fixture's
    setup, from the port's own sources, scaler and windows."""
    _import_port()
    from repro_torch.core.windows import WindowedStream, WindowPlan
    from repro_torch.streams.normalize import MinMaxScaler
    from repro_torch.streams.sources import gradual_drift, wind_turbine_series

    series = wind_turbine_series(int(setup["series_len"]),
                                 seed=int(setup["series_seed"]))
    hist_len = int(setup["hist_len"])
    hist, stream_raw = series[:hist_len], series[hist_len:]
    stream = gradual_drift(stream_raw,
                           alphas=np.full(5, float(setup["drift_alpha"])),
                           seed=int(setup["drift_seed"]))
    scaler = MinMaxScaler.fit(hist)
    plan = WindowPlan(n_windows=int(setup["n_windows"]),
                      records_per_window=int(setup["records_per_window"]),
                      lag=int(setup["lag"]))
    return WindowedStream(scaler.transform(stream), plan), scaler.transform(hist)


def port_stream(setup: dict):
    """The scaled windowed stream of the fixture's setup."""
    return port_data(setup)[0]


def window_keys(setup: dict) -> dict:
    """{training key: window} of a run of the fixture's setup: the window
    keys every executor derives from ``run_key``, and the bus executor's
    warm-up key, which gets window 0's model or draws.  A replay keyed so
    stays in step when an executor adds a call (the bus's warm-up fit)."""
    _import_port()
    from repro_torch.runtime.executor import warmup_seed, window_seeds

    run_key, n = int(setup["run_key"]), int(setup["n_windows"])
    keys = {k: t for t, k in enumerate(window_seeds(run_key, n))}
    keys[warmup_seed(run_key)] = 0
    return keys


def replay_trainer(speed_models, keys, device):
    """A ``Forecaster.train`` that installs published speed models, window
    t's for the key ``keys`` maps to t, as the edge installs the models the
    cloud publishes.  Its wall is the transfer of the model onto the
    device."""
    from repro_torch.convert import params_from_numpy

    def train(data, params, key):
        t0 = time.perf_counter()
        model = params_from_numpy(speed_models[keys[key]], device)
        return model, time.perf_counter() - t0

    return train


def run_main_path(fx: dict, device, modes=tuple(MODES)) -> dict:
    """Serve the fixture's stream with the port on ``device`` in each of
    ``modes``: {mode name: HybridRunResult}."""
    _import_port()
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import HybridStreamAnalytics, lstm_forecaster

    setup = unflatten(fx, "setup")
    ws = port_stream(setup)
    cfg = get_config("lstm-paper")
    batch_params = params_from_numpy(unflatten(fx, "batch"), device)
    speed = [unflatten(fx, f"speed{t}")
             for t in range(int(fx["n_speed_models"]))]
    results = {}
    for name in modes:
        mode, solver = MODES[name]
        fc = lstm_forecaster(cfg, epochs=int(setup["speed_epochs"]),
                             batch_size=int(setup["speed_batch_size"]),
                             device=device)
        fc = dataclasses.replace(
            fc, train=replay_trainer(speed, window_keys(setup), device))
        results[name] = HybridStreamAnalytics(
            fc, mode=mode, dwa_solver=solver).run(
                ws, batch_params, int(setup["run_key"]))
    return results


def check_records(fx: dict, results: dict, rtol: float, atol: float) -> float:
    """Hold every mode's records to the fixture: same windows, RMSEs to
    ``rtol``, weights to ``atol``.  Returns the largest relative RMSE error."""
    worst = 0.0
    for name, res in results.items():
        want = fx[f"records/{name}"]
        got = records_array(res.records)
        if got.shape != want.shape:
            raise AssertionError(f"{name}: {got.shape[0]} records, the "
                                 f"reference has {want.shape[0]}")
        np.testing.assert_array_equal(got[:, 0], want[:, 0], err_msg=name)
        np.testing.assert_allclose(got[:, 1:4], want[:, 1:4], rtol=rtol,
                                   atol=0, err_msg=name)
        np.testing.assert_allclose(got[:, 4:6], want[:, 4:6], rtol=0,
                                   atol=atol, err_msg=name)
        worst = max(worst, float(np.max(np.abs(got[:, 1:4] - want[:, 1:4])
                                        / np.abs(want[:, 1:4]))))
    return worst


def draw_replay_trainer(engine, draws, keys, device):
    """A ``Forecaster.train`` that trains every window itself, from draws
    made elsewhere: window t's (init params, permutation indices), for the
    key ``keys`` maps to t, go to ``engine.fit_window``.  Its wall is the
    fit's, synced.  Returns (train, published), where ``published`` collects
    the models it trains."""
    import torch

    from repro_torch.convert import params_from_numpy

    published = []

    def train(data, params, key):
        init, idx = draws[keys[key]]
        init = params_from_numpy(init, device)
        idx = torch.as_tensor(np.asarray(idx, np.int64))
        t0 = time.perf_counter()
        trained = engine.fit_window(data, init, idx)
        wall = time.perf_counter() - t0
        published.append(trained)
        return trained, wall

    return train, published


def speed_draws(fx: dict) -> list:
    """Window t's (init params, permutation indices) of the reference."""
    return [(unflatten(fx, f"init{t}"), fx[f"idx{t}"])
            for t in range(int(fx["n_speed_models"]))]


def run_training_path(fx: dict, device, modes=tuple(MODES)) -> dict:
    """The training path on ``device``: pretrain the batch model, then run
    the per-window loop in each of ``modes`` training every window's speed
    model, all from the reference's draws.  Returns {"batch": params,
    "batch_wall_s": s, "results": {mode: HybridRunResult}, "speed": {mode:
    [trained params per window]}}."""
    _import_port()
    from repro_torch.configs import get_config
    from repro_torch.core import (
        HybridStreamAnalytics,
        lstm_forecaster,
        make_supervised,
        pretrain_batch_model,
    )

    setup = unflatten(fx, "setup")
    ws, hist = port_data(setup)
    cfg = get_config("lstm-paper")
    fc_batch = lstm_forecaster(cfg, epochs=int(setup["batch_epochs"]),
                               batch_size=int(setup["batch_size"]),
                               device=device)
    train, _ = draw_replay_trainer(
        fc_batch.engine, [(unflatten(fx, "batch_init"), fx["batch_idx"])],
        {int(setup["batch_key"]): 0}, device)
    batch_params, batch_wall = pretrain_batch_model(
        dataclasses.replace(fc_batch, train=train),
        make_supervised(hist, int(setup["lag"]), 0), int(setup["batch_key"]))
    results, speed = {}, {}
    for name in modes:
        mode, solver = MODES[name]
        fc = lstm_forecaster(cfg, epochs=int(setup["speed_epochs"]),
                             batch_size=int(setup["speed_batch_size"]),
                             device=device)
        train, speed[name] = draw_replay_trainer(
            fc.engine, speed_draws(fx), window_keys(setup), device)
        results[name] = HybridStreamAnalytics(
            dataclasses.replace(fc, train=train), mode=mode,
            dwa_solver=solver).run(ws, batch_params, int(setup["run_key"]))
    return {"batch": batch_params, "batch_wall_s": batch_wall,
            "results": results, "speed": speed}


def check_params(want: dict, got: dict, atol: float, what: str) -> float:
    """Hold a trained params tree (tensors) to the reference's (numpy),
    leaf by leaf, to ``atol``.  Returns the largest |difference|."""
    worst = 0.0
    for k, v in want.items():
        if isinstance(v, dict):
            worst = max(worst, check_params(v, got[k], atol, f"{what}/{k}"))
            continue
        g = got[k].detach().cpu().numpy()
        np.testing.assert_allclose(g, v, rtol=0, atol=atol,
                                   err_msg=f"{what}/{k}")
        worst = max(worst, float(np.max(np.abs(g - v))))
    return worst


def legacy_window(setup: dict, scaled: bool = True) -> dict:
    """The legacy fixture's window from the port's own sources: the first
    ``n_records`` of the turbine series, the window ``launch.calibrate``
    times, min-max scaled over themselves (unless not ``scaled``) and made
    supervised."""
    _import_port()
    from repro_torch.core.windows import make_supervised
    from repro_torch.streams.normalize import MinMaxScaler
    from repro_torch.streams.sources import wind_turbine_series

    series = wind_turbine_series(int(setup["series_len"]),
                                 seed=int(setup["series_seed"]))
    series = series[:int(setup["n_records"])]
    if scaled:
        series = MinMaxScaler.fit(series).transform(series)
    return make_supervised(series, int(setup["lag"]), 0)


def legacy_batch_rows(n: int, batch_size: int, epochs: int) -> list:
    """The rows of every minibatch of the legacy fit, in order: each epoch
    every example once, the last minibatch ragged."""
    return [min(batch_size, n - i) for i in range(0, n, batch_size)] * epochs


def run_legacy_fit(fx: dict, device, epochs: Optional[int] = None):
    """The port's legacy ``fit`` loop (``train_loop.fit_loop``) on
    ``device`` from the fixture's draws: the reference's init params and
    its epochs' permutations (the first ``epochs`` of them when given).
    Returns the ``FitResult``."""
    import torch

    _import_port()
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import get_model
    from repro_torch.training.train_loop import fit_loop

    setup = unflatten(fx, "setup")
    return fit_loop(get_model(get_config("lstm-paper")),
                    {"x": fx["x"], "y": fx["y"]},
                    params_from_numpy(unflatten(fx, "init"), device),
                    torch.as_tensor(fx["perms"][:epochs].astype(np.int64)),
                    batch_size=int(setup["batch_size"]),
                    lr=float(setup["lr"]), device=device)


def check_legacy_fit(fx: dict, res, atol: float) -> float:
    """Hold a legacy fit to the reference's: its steps, every trained leaf
    to ``atol`` and its last loss to ``atol`` relative.  Returns the largest
    |dparam|."""
    setup = unflatten(fx, "setup")
    steps = len(legacy_batch_rows(len(fx["x"]), int(setup["batch_size"]),
                                  int(setup["epochs"])))
    if res.steps != steps:
        raise AssertionError(f"legacy fit: {res.steps} steps, the reference "
                             f"took {steps}")
    worst = check_params(unflatten(fx, "trained"), res.params, atol,
                         "legacy fit")
    np.testing.assert_allclose(res.history[-1]["loss"], float(fx["loss"]),
                               rtol=atol, err_msg="legacy fit: last loss")
    return worst


@contextlib.contextmanager
def recording_rows(kernel_mod, names):
    """Record the rows (B of x (..., B, T, F)) of every call of the named
    kernel wrappers of ``kernel_mod`` while the block runs; each wrapper's
    launch counter counts on (a wrapper bumps the counter its module name
    resolves to)."""
    rows = {n: [] for n in names}
    originals = {n: getattr(kernel_mod, n) for n in names}
    for n, orig in originals.items():
        def record(x, *args, _orig=orig, _rows=rows[n], **kw):
            _rows.append(int(x.shape[-3]))
            return _orig(x, *args, **kw)
        record.launches = orig.launches
        setattr(kernel_mod, n, record)
    try:
        yield rows
    finally:
        for n, orig in originals.items():
            orig.launches = getattr(kernel_mod, n).launches
            setattr(kernel_mod, n, orig)


def expected_calibration_launches(epochs: int, rpw: int = CALIBRATED_RPW,
                                  batch_size: int = 64) -> dict:
    """Launches of one ``launch.calibrate`` on the card: its compiled
    forecaster's two fits, each ``epochs`` x the bucket's steps of #2 and
    #3, the first with the bucket's mask check (two no-grad forwards, #1)
    when the window needs padding; one warm-up and five timed predicts
    (#1)."""
    _import_port()
    from repro_torch.training.compiled import bucket_examples

    n = rpw  # make_supervised of rpw + lag records
    nb = bucket_examples(n, batch_size)
    steps = 2 * epochs * (nb // batch_size)
    return {"lstm_sequence_fused": 6 + (2 if nb != n else 0),
            "lstm_sequence_fwd_train": steps, "lstm_sequence_bwd": steps,
            "int8_matmul": 0}


def check_calibrated_runs(runs: dict, quantized: bool, n_windows: int
                          ) -> None:
    """The launcher's calibrated runs: the three deployments, every bus
    message of the reference's bytes, edge-centric failing every window
    and training nowhere else failing, every measured time above 0, and
    the paper's Table-3 orderings."""
    _import_port()
    from repro_torch.runtime.modules import T_BATCH, T_MODEL, T_STREAM

    if set(runs) != set(BUS_DEPLOYMENTS):
        raise AssertionError(f"calibrated runs of {sorted(runs)}")
    want = {T_MODEL: CALIBRATED_INT8_NBYTES if quantized
            else CALIBRATED_CONSTANTS["model_nbytes"],
            T_STREAM: CALIBRATED_CONSTANTS["window_nbytes"],
            T_BATCH: CALIBRATED_CONSTANTS["result_nbytes"]}
    for dep, res in runs.items():
        for topic, nbytes in want.items():
            got = {m.nbytes for m in messages(res, topic)}
            if got and got != {nbytes}:
                raise AssertionError(f"{dep}: {topic} carried {got} B, the "
                                     f"reference's {nbytes}")
        table = res.table3()
        if any(table[m]["computation"] <= 0 for m in ROWS_COMPUTED
               if m in table):
            raise AssertionError(f"{dep}: a computation time not above 0: "
                                 f"{table}")
    if len(runs["edge-centric"].failures) != n_windows:
        raise AssertionError(f"edge-centric: "
                             f"{len(runs['edge-centric'].failures)} failures "
                             f"in {n_windows} windows")
    if "speed_training" in runs["edge-centric"].table3():
        raise AssertionError("edge-centric trained a speed model")
    for dep in ("cloud-centric", "edge-cloud-integrated"):
        if runs[dep].failures or len(messages(runs[dep], T_MODEL)) != \
                n_windows:
            raise AssertionError(f"{dep}: failures {runs[dep].failures}")
    cloud = runs["cloud-centric"].table3()
    integ = runs["edge-cloud-integrated"].table3()
    for mod in ("batch_inference", "speed_inference"):
        if not cloud[mod]["communication"] > integ[mod]["communication"]:
            raise AssertionError(f"{mod}: cloud-centric communication "
                                 "does not exceed integrated's")
    if not integ["batch_inference"]["computation"] > \
            cloud["batch_inference"]["computation"]:
        raise AssertionError("integrated batch_inference computation does "
                             "not exceed cloud-centric's")


def check_training_path(fx: dict, run: dict, rtol: float, atol: float
                        ) -> tuple:
    """Hold the training path to the reference: the batch model and every
    mode's published speed models to ``atol``, every record as
    ``check_records`` does.  Returns (largest |dparam|, largest relative
    RMSE error)."""
    worst = check_params(unflatten(fx, "batch"), run["batch"], atol, "batch")
    for name, models in run["speed"].items():
        if len(models) != int(fx["n_speed_models"]):
            raise AssertionError(f"{name}: {len(models)} speed models, the "
                                 f"reference has {fx['n_speed_models']}")
        for t, p in enumerate(models):
            worst = max(worst, check_params(unflatten(fx, f"speed{t}"), p,
                                            atol, f"{name} speed{t}"))
    return worst, check_records(fx, run["results"], rtol=rtol, atol=atol)


def expected_training_launches(fx: dict, modes=tuple(MODES)) -> dict:
    """The launches the training path must make, derived from the setup:
    one training forward and one backward per train step (epochs x steps of
    each fit's bucket); one serving forward per predict (2 eval predicts a
    window, 2 inference predicts a record) and two per mask check (once per
    engine and padded bucket, under no_grad)."""
    _import_port()
    from repro_torch.core import make_supervised
    from repro_torch.training.compiled import bucket_examples

    setup = unflatten(fx, "setup")
    ws, hist = port_data(setup)

    def fits(sizes, epochs, batch_size):
        buckets = [bucket_examples(n, batch_size) for n in sizes]
        steps = sum(epochs * nb // batch_size for nb in buckets)
        padded = {nb for n, nb in zip(sizes, buckets) if n < nb}
        return steps, 2 * len(padded)

    steps, fused = fits([len(make_supervised(hist, int(setup["lag"]), 0)["x"])],
                        int(setup["batch_epochs"]), int(setup["batch_size"]))
    sizes = [len(ws.supervised(t)["x"]) for t in range(len(ws))]
    for name in modes:
        s, checks = fits(sizes, int(setup["speed_epochs"]),
                         int(setup["speed_batch_size"]))
        steps += s
        fused += checks + 2 * len(sizes) + 2 * len(fx[f"records/{name}"])
    return {"lstm_sequence_fwd_train": steps, "lstm_sequence_bwd": steps,
            "lstm_sequence_fused": fused}


# ---------------------------------------------------------------------------
# The fleet, on any device
# ---------------------------------------------------------------------------


def fleet_data(setup: dict):
    """The fleet of the fixture's setup, from the port's own sources:
    ({stream id: WindowedStream}, the first stream's scaled history)."""
    _import_port()
    from repro_torch.streams.sources import fleet_windowed_streams

    return fleet_windowed_streams(
        int(setup["n_streams"]), int(setup["n_windows"]),
        int(setup["records_per_window"]),
        [str(x) for x in setup["scenarios"]], seed=int(setup["seed"]),
        hist_len=int(setup["hist_len"]),
        alphas=np.full(5, float(setup["drift_alpha"])))


def fleet_window_keys(setup: dict, ids) -> dict:
    """{training key: (stream, window)} of a fleet run of the fixture's
    setup: every stream's chain under ``run_key`` (``fleet_key_chains``; a
    shorter run's chain is a prefix of it).  The bus executor's warm-up fits
    with the window-0 keys, so it replays window 0's draws."""
    _import_port()
    from repro_torch.runtime.executor import fleet_key_chains

    chains = fleet_key_chains(int(setup["run_key"]), list(ids),
                              int(setup["n_windows"]))
    return {k: (sid, w) for sid, chain in chains.items()
            for w, k in enumerate(chain)}


def fleet_draws(fx: dict) -> dict:
    """{(stream, window): (init params, permutation indices)} of the
    reference's fleet fits."""
    ids = [str(x) for x in fx["fsetup/ids"]]
    return {(sid, w): (unflatten(fx, f"init_{sid}_w{w}"),
                       fx[f"idx_{sid}_w{w}"])
            for sid in ids for w in range(int(fx["fsetup/n_windows"]))}


def fleet_replay(ff, draws: dict, keys: dict, device, rows: bool = False):
    """Replace ``ff.train_fleet`` with a fit from draws made elsewhere: the
    draws of (stream, window) ``keys`` maps each key to go to
    ``ff.fit_fleet_window``; with ``rows``, the draws of (stream, window,
    the window's row count), for runs whose windows lose records.  Returns
    ``fits``, {(stream, window[, rows]): [(params, per-step losses), ...]}
    of every fit it makes, in order."""
    from repro_torch.convert import params_from_numpy

    fits: dict = {}

    def train_fleet(datas, ks):
        t0 = time.perf_counter()
        sw = [keys[int(k)] for k in ks]
        if rows:
            sw = [(*x, len(d["x"])) for x, d in zip(sw, datas)]
        out = ff.fit_fleet_window(
            datas, [params_from_numpy(draws[x][0], device) for x in sw],
            [draws[x][1] for x in sw])
        wall = time.perf_counter() - t0
        for x, p, losses in zip(sw, out, ff.last_losses):
            fits.setdefault(x, []).append((p, losses))
        return out, wall

    ff.train_fleet = train_fleet
    return fits


# the reference's fleet runs in the fixture: name -> (bus?, int8 sync?,
# drift-gated?), all in the integrated deployment
FLEET_RUNS = {"inproc": (False, False, False),
              "bus_float": (True, False, False),
              "bus_int8": (True, True, False),
              "bus_gated": (True, False, True)}


def run_fleet_replay(fx: dict, device, name: str):
    """The fixture's fleet through the port on ``device``: the run ``name``
    of ``FLEET_RUNS``, every fit from the reference's draws.  Returns (the
    run's result, its fits as ``fleet_replay`` collects them, the fleet
    forecaster)."""
    _import_port()
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import FleetStages, lstm_fleet_forecaster
    from repro_torch.core.drift import DriftGate
    from repro_torch.runtime import (
        CostModel,
        FleetBusExecutor,
        InProcessFleetExecutor,
        edge_cloud_integrated,
        paper_topology,
    )

    setup = unflatten(fx, "fsetup")
    streams, _ = fleet_data(setup)
    ff = lstm_fleet_forecaster(get_config("lstm-paper"),
                               epochs=int(setup["speed_epochs"]),
                               batch_size=int(setup["speed_batch_size"]),
                               device=device)
    fits = fleet_replay(ff, fleet_draws(fx),
                        fleet_window_keys(setup, streams), device)
    stages = FleetStages.build(ff, mode="dynamic")
    bp = params_from_numpy(unflatten(fx, "batch"), device)
    bus, quantized, gated = FLEET_RUNS[name]
    gate = DriftGate() if gated else None
    if bus:
        ex = FleetBusExecutor(stages, edge_cloud_integrated(),
                              paper_topology(),
                              CostModel(ingest_s=BUS_INGEST_S), gate=gate,
                              quantized_sync=quantized)
    else:
        ex = InProcessFleetExecutor(stages, gate=gate)
    return ex.run(streams, bp, int(setup["run_key"])), fits, ff


def check_fleet_records(fx: dict, name: str, res, rtol: float,
                        atol: float) -> float:
    """Hold run ``name``'s per-stream records to the fixture's (windows
    equal, RMSEs to ``rtol``, weights to ``atol``) and, for a gated run, its
    retrain log exactly.  Returns the largest relative RMSE error."""
    worst = 0.0
    for sid, r in res.results.items():
        worst = max(worst, check_records(
            {f"records/{name}_{sid}": fx[f"records/{name}/{sid}"]},
            {f"{name}_{sid}": r}, rtol=rtol, atol=atol))
        if f"retrain/{name}/{sid}" in fx:
            want = fx[f"retrain/{name}/{sid}"].tolist()
            if res.retrain_log[sid] != want:
                raise AssertionError(f"{name} {sid}: retrain log "
                                     f"{res.retrain_log[sid]}, the "
                                     f"reference's {want}")
    return worst


def check_fleet_fits(fx: dict, fits: dict, atol: float) -> float:
    """Hold every (stream, window) fit of a replay to the reference's fleet
    fit: params and per-step losses to ``atol``.  Returns the largest
    difference."""
    _import_port()
    from repro_torch.stacked import materialize_params

    worst = 0.0
    for (sid, w), runs in sorted(fits.items()):
        want = unflatten(fx, f"fit_{sid}_w{w}")
        want_losses = fx[f"loss_{sid}_w{w}"]
        for p, losses in runs:
            worst = max(worst, check_params(
                want, materialize_params(p), atol, f"fit {sid} w{w}"))
            np.testing.assert_allclose(losses, want_losses, rtol=0,
                                       atol=atol,
                                       err_msg=f"losses {sid} w{w}")
            worst = max(worst, float(np.max(np.abs(losses - want_losses))))
    return worst


def run_bus_replay(fx: dict, device, deployment: str, quantized=False,
                   stage_costs=None):
    """The fixture's stream on the bus in ``deployment``, dynamic weights
    with the closed-form solve, serving the reference's published speed
    models through the keyed replay; with ``quantized`` the training site
    publishes them as int8.  ``stage_costs`` (module -> seconds), when
    given, replaces the measured stage walls in the schedule.  Returns the
    ``BusRunResult``."""
    _import_port()
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import PipelineStages, lstm_forecaster
    from repro_torch.runtime import (
        ALL_DEPLOYMENTS,
        BusExecutor,
        CostModel,
        paper_topology,
    )

    setup = unflatten(fx, "setup")
    speed = [unflatten(fx, f"speed{t}")
             for t in range(int(fx["n_speed_models"]))]
    fc = lstm_forecaster(get_config("lstm-paper"),
                         epochs=int(setup["speed_epochs"]),
                         batch_size=int(setup["speed_batch_size"]),
                         device=device)
    fc = dataclasses.replace(
        fc, train=replay_trainer(speed, window_keys(setup), device))
    ex = BusExecutor(PipelineStages.build(fc, mode="dynamic"),
                     ALL_DEPLOYMENTS[deployment](), paper_topology(),
                     CostModel(ingest_s=BUS_INGEST_S),
                     quantized_sync=quantized)
    ex.stage_costs = stage_costs
    return ex.run(port_stream(setup),
                  params_from_numpy(unflatten(fx, "batch"), device),
                  int(setup["run_key"]))


def messages(res, topic: str) -> list:
    """The deliveries of ``topic`` in a bus run, in delivery order."""
    return [m for m in res.message_log if m.topic == topic]


def check_bus_float(fx: dict, results: dict, rtol: float, atol: float
                    ) -> float:
    """Hold float-sync replays ({deployment: BusRunResult}) to the
    reference: integrated and cloud-centric reproduce its in-process
    ``dynamic_closed_form`` records (every model sync lands before the next
    window); edge-centric records one OOM failure per window and serves the
    batch model as its speed model.  Returns the largest relative RMSE
    error."""
    _import_port()
    from repro_torch.runtime.modules import T_MODEL

    worst = 0.0
    for dep in ("edge-cloud-integrated", "cloud-centric"):
        worst = max(worst, check_records(
            fx, {"dynamic_closed_form": results[dep]},
            rtol=rtol, atol=atol))
        sizes = {m.nbytes for m in messages(results[dep], T_MODEL)}
        if sizes != {FLOAT_MODEL_NBYTES}:
            raise AssertionError(f"{dep}: model-topic bytes {sizes}, "
                                 f"expected {FLOAT_MODEL_NBYTES}")
    edge = results["edge-centric"]
    if (len(edge.failures) != edge.n_windows
            or not all("OOM" in f for f in edge.failures)):
        raise AssertionError(f"edge-centric: {len(edge.failures)} failures "
                             f"in {edge.n_windows} windows: {edge.failures}")
    if len(edge.records) != edge.n_windows - 1 or any(
            r.rmse_speed != r.rmse_batch for r in edge.records):
        raise AssertionError("edge-centric: the speed layer must serve the "
                             "batch model in every window")
    return worst


def check_bus_int8(fx: dict, res, rtol: float) -> tuple:
    """Hold the int8-sync replay (integrated) to the reference: every model
    publish is ``INT8_MODEL_NBYTES`` and carries ``QTensor`` leaves whose
    ``q`` and ``scale`` equal the reference's ``quantize_tree`` bit for bit
    (the rest float); every window's speed predictions come from an
    installed int8 model, within ``INT8_PRED_ATOL`` of the reference's
    ``int8pred{t}``; the records within ``rtol`` of its
    ``bus_int8_integrated`` (the reference serves dequantized floats off the
    TPU, one float rounding from the int8 products).  Returns (largest
    |dpred|, largest relative RMSE error)."""
    _import_port()
    from repro_torch.runtime.modules import T_MODEL, T_SPEED
    from repro_torch.serving.quantize import QTensor

    published = messages(res, T_MODEL)
    if len(published) != int(fx["n_speed_models"]):
        raise AssertionError(f"{len(published)} int8 publishes, expected "
                             f"{int(fx['n_speed_models'])}")
    for m in published:
        t = m.payload["window"]
        if m.nbytes != INT8_MODEL_NBYTES:
            raise AssertionError(f"window {t}: model-topic bytes {m.nbytes}, "
                                 f"expected {INT8_MODEL_NBYTES}")
        want = unflatten(fx, f"q8speed{t}")
        for sub, leaves in m.payload["params"].items():
            for leaf, got in leaves.items():
                if leaf not in want.get(sub, {}):
                    if isinstance(got, QTensor):
                        raise AssertionError(f"{sub}/{leaf} quantized, the "
                                             "reference keeps it float")
                    continue
                ref = want[sub][leaf]
                if not (isinstance(got, QTensor)
                        and np.array_equal(got.q.cpu().numpy(), ref["q"])
                        and np.array_equal(
                            got.scale.cpu().numpy().view(np.uint32),
                            ref["scale"].view(np.uint32))):
                    raise AssertionError(f"window {t}: {sub}/{leaf} is not "
                                         "the reference's int8 tensor")
    worst_pred = 0.0
    for m in messages(res, T_SPEED):
        w = m.payload["window"]
        if m.payload["fallback"]:
            raise AssertionError(f"window {w} served no synced model")
        err = float(np.max(np.abs(m.payload["pred"] - fx[f"int8pred{w - 1}"])))
        worst_pred = max(worst_pred, err)
        if err > INT8_PRED_ATOL:
            raise AssertionError(f"window {w}: int8 predictions off by {err}")
    worst = check_records(fx, {"bus_int8_integrated": res},
                          rtol=rtol, atol=rtol)
    return worst_pred, worst


def expected_bus_launches(res, quantized: bool, lag: int) -> dict:
    """The launches a replayed bus run must make, derived from the run: the
    warm-up's 2 eval predicts and batch predict; 2 eval predicts for every
    window that trained; a batch predict per record; a speed predict per
    speed message, through kernel #4's ``lag + 2`` products (input
    projection, ``lag`` recurrent steps, Dense(10)) where an installed int8
    model served it, else through #1; the warm-up's int8 speed predict
    with int8 sync on."""
    _import_port()
    from repro_torch.runtime.modules import T_SPEED

    speed = messages(res, T_SPEED)
    int8_served = (sum(not m.payload["fallback"] for m in speed)
                   if quantized else 0)
    trained = res.n_windows - len(res.failures)
    return {"lstm_sequence_fused": 3 + 2 * trained + len(res.records)
            + len(speed) - int8_served,
            "int8_matmul": (lag + 2) * (int8_served + 1) if quantized else 0}


# ---------------------------------------------------------------------------
# The request and placement planes, on any device
# ---------------------------------------------------------------------------


def _scalars(tree: dict) -> dict:
    """A fixture's group of numpy scalars as Python values."""
    return {k: v.item() for k, v in tree.items()}


def load_forecaster_replay(lf, draws: list, device) -> dict:
    """Make ``lf`` (a ``LoadForecaster``) fit from draws made elsewhere: its
    ``k``-th fit from ``draws[k]`` (init params, permutation indices),
    through the port's ``fit_window``, and log every forecast and every
    prediction of the fitted LSTM (before the trend floor).  Returns the
    log: {"calls": [(series, value, fitted?)], "fits": [trained params],
    "preds": [the LSTM's scaled-down prediction]}."""
    import torch

    from repro_torch.convert import params_from_numpy

    fc = lf._forecaster()
    log: dict = {"calls": [], "fits": [], "preds": []}

    def train(data, params, key):
        init, idx = draws[len(log["fits"])]
        t0 = time.perf_counter()
        trained = fc.engine.fit_window(
            data, params_from_numpy(init, device),
            torch.as_tensor(np.asarray(idx, np.int64)))
        log["fits"].append(trained)
        return trained, time.perf_counter() - t0

    def predict(params, x):
        y = fc.predict(params, x)
        log["preds"].append(float(np.asarray(y).reshape(-1)[0]))
        return y

    lf._fc = dataclasses.replace(fc, train=train, predict=predict)
    forecast = lf.forecast

    def logged(series):
        n0 = len(log["fits"])
        value = forecast(series)
        log["calls"].append((np.asarray(series, np.float64), value,
                             len(log["fits"]) > n0))
        return value

    lf.forecast = logged
    return log


def check_forecasts(fx: dict, run: str, log: dict, rtol: float) -> float:
    """Hold a replay's forecasts to the reference's run ``run``: the same
    calls on the same series, the same ones fitted, each value and each
    fitted LSTM's own prediction (before the trend floor) to ``rtol``
    (relative).  Returns the largest relative error."""
    calls = log["calls"]
    want = fx[f"lf/{run}/value"]
    if len(calls) != len(want):
        raise AssertionError(f"{run}: {len(calls)} forecasts, the "
                             f"reference made {len(want)}")
    worst = 0.0
    ref_preds = fx[f"lf/{run}/pred"]
    if len(log["preds"]) != len(ref_preds):
        raise AssertionError(f"{run}: {len(log['preds'])} LSTM predictions, "
                             f"the reference made {len(ref_preds)}")
    for k, (got, ref) in enumerate(zip(log["preds"], ref_preds)):
        err = abs(got - ref) / max(abs(ref), 1e-12)
        worst = max(worst, err)
        if err > rtol:
            raise AssertionError(f"{run} fit {k}: the LSTM predicts {got}, "
                                 f"the reference's {ref} ({err:.3g} rel)")
    for i, (series, value, fitted) in enumerate(calls):
        ref_series = fx[f"lf/{run}/series{i}"]
        if not np.array_equal(series, ref_series):
            raise AssertionError(f"{run} forecast {i}: series {series}, the "
                                 f"reference's {ref_series}")
        if fitted != bool(fx[f"lf/{run}/fitted"][i]):
            raise AssertionError(f"{run} forecast {i}: fitted {fitted}")
        err = abs(value - want[i]) / max(abs(want[i]), 1e-12)
        worst = max(worst, err)
        if err > rtol:
            raise AssertionError(f"{run} forecast {i}: {value}, the "
                                 f"reference's {want[i]} ({err:.3g} rel)")
    return worst


def _load_forecaster(fx: dict, run: str, device):
    """A ``LoadForecaster`` of run ``run``'s configuration on ``device``,
    replaying its fits from the fixture's draws (each fit's init params and
    permutation indices, in fit order).  Returns (forecaster, log)."""
    _import_port()
    from repro_torch.runtime import LoadForecaster

    lf = LoadForecaster(device=device,
                        **_scalars(unflatten(fx, f"lfcfg/{run}")))
    draws = [(unflatten(fx, f"lf/{run}/init{k}"), fx[f"lf/{run}/idx{k}"])
             for k in range(int(fx[f"lf/{run}/n_fits"]))]
    return lf, load_forecaster_replay(lf, draws, device)


def run_ramp_replay(fx: dict, device) -> tuple:
    """``RAMP_LOADS`` fed tick by tick to a proactive controller of the
    fixture's ``ramp`` configuration, its forecaster replaying the
    reference's fits on ``device``, until it scales.  Returns (decisions as
    (workers, migrations) per tick, the controller, the forecaster's
    log)."""
    _import_port()
    from repro_torch.runtime import PlacementController, SiteSignal

    lf, log = _load_forecaster(fx, "ramp", device)
    ctl = PlacementController(forecaster=lf,
                              **_scalars(unflatten(fx, "ctl/ramp")))
    decisions = []
    for k, load in enumerate(RAMP_LOADS):
        d = ctl.step(float(k), [SiteSignal("edge", "edge", 1, 1, load),
                                SiteSignal("cloud", "cloud", 4, 4, 0.0)], [])
        decisions.append((d.workers, d.migrations))
        if d.workers:
            break
    return decisions, ctl, log


def run_request_replay(fx: dict, device, name: str, fleet_fx=None,
                       **overrides):
    """The reference's request- or placement-plane run ``name`` of
    ``REQUEST_RUNS`` through the port on ``device``: the fleet fixture's
    fleet in the integrated deployment, every fleet fit from the
    reference's draws (``fleet_replay``) and, elastic, every
    ``LoadForecaster`` fit too.  ``overrides`` replace the run's
    ``FleetBusExecutor`` arguments.  Returns (the ``FleetBusRunResult``, the
    executor, the fleet forecaster, the forecaster's log or None)."""
    _import_port()
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import FleetStages, lstm_fleet_forecaster
    from repro_torch.runtime import (
        CostModel,
        FleetBusExecutor,
        PlacementController,
        edge_cloud_integrated,
        paper_topology,
    )
    from repro_torch.serving.query_plane import open_loop_trace

    fleet_fx = load_fixture(FLEET_FIXTURE) if fleet_fx is None else fleet_fx
    setup = unflatten(fleet_fx, "fsetup")
    streams, _ = fleet_data(setup)
    ff = lstm_fleet_forecaster(get_config("lstm-paper"),
                               epochs=int(setup["speed_epochs"]),
                               batch_size=int(setup["speed_batch_size"]),
                               device=device)
    fleet_replay(ff, fleet_draws(fleet_fx),
                 fleet_window_keys(setup, streams), device)
    rs = _scalars(unflatten(fx, "rsetup"))
    quantized, elastic = REQUEST_RUNS[name]
    holder: dict = {}
    kw: dict = {}
    if elastic:
        def factory():
            lf, holder["log"] = _load_forecaster(fx, name, device)
            return PlacementController(
                forecaster=lf, **_scalars(unflatten(fx, f"ctl/{name}")))

        kw = dict(qps=rs["qps"], elastic=True, controller_factory=factory,
                  stage_costs=_scalars(unflatten(fx, "costs/spike")))
    else:
        kw = dict(query_trace=open_loop_trace(
            list(streams), rs["qps"], rs["n_requests"], start=rs["start"],
            seed=rs["trace_seed"]),
                  stage_costs=_scalars(unflatten(fx, "costs/serve")))
    kw.update(overrides)
    ex = FleetBusExecutor(
        FleetStages.build(ff, mode="dynamic"), edge_cloud_integrated(),
        paper_topology(), CostModel(ingest_s=rs["ingest_s"]),
        window_period_s=rs["period"], serve_slots=rs["slots"],
        quantized_sync=quantized, **kw)
    res = ex.run(streams, params_from_numpy(unflatten(fleet_fx, "batch"),
                                            device),
                 int(setup["run_key"]))
    return res, ex, ff, holder.get("log")


def serve_mix(ids) -> list:
    """bench_serving's mix, handcrafted: point, horizon and what-if queries,
    several from one stream in a tick, in three waves (submitted every
    other tick, so slots free and refill between them)."""
    _import_port()
    from repro_torch.serving.query_plane import ForecastQuery

    a, b, c = ids[0], ids[1 % len(ids)], ids[2 % len(ids)]
    return [
        [ForecastQuery(uid=0, stream=a),
         ForecastQuery(uid=1, stream=a, kind="horizon", horizon=3),
         ForecastQuery(uid=2, stream=b, kind="whatif", perturb_scale=1.1,
                       perturb_offset=0.05)],
        [ForecastQuery(uid=3, stream=c, kind="horizon", horizon=2),
         ForecastQuery(uid=4, stream=b),
         ForecastQuery(uid=5, stream=a, kind="whatif", perturb_scale=0.9,
                       perturb_offset=-0.02)],
        [ForecastQuery(uid=6, stream=a),
         ForecastQuery(uid=7, stream=a, kind="horizon", horizon=3)],
    ]


def batched_vs_unbatched(ff, params: list, windows: dict,
                         n_slots: int = 3) -> dict:
    """``serve_mix`` through ``QueryPlane`` and ``ServingStage`` (one
    stacked predict a tick over ``params``, one tree a stream of
    ``windows``, {stream: its window's x}), each answer against
    ``answer_query_unbatched`` over the batch-of-one predict
    ``ff.single.predict`` from the same context.  Returns the largest
    |difference|, the ticks and the stacked predicts."""
    _import_port()
    from repro_torch.core.stages import ServingStage
    from repro_torch.serving.query_plane import (
        QueryPlane,
        answer_query_unbatched,
    )

    ids = list(windows)
    waves = serve_mix(ids)
    n_queries = sum(len(w) for w in waves)
    plane = QueryPlane(ids, n_slots)
    for sid, x in windows.items():
        plane.observe_window(sid, x, 0)
    stage = ServingStage(ff)
    tick, done = 0, []
    while plane.busy or waves:
        if waves and tick % 2 == 0:
            for q in waves.pop(0):
                plane.submit(q)
        plane.admit(float(tick))
        batch = plane.build_batch()
        if batch is not None:
            by_stream, xs = batch
            out = stage(params_seq=params, xs=xs)
            plane.apply(by_stream, out["preds"], {sid: 0 for sid in ids})
        done += plane.retire(float(tick))
        tick += 1
    if sorted(q.uid for q in done) != list(range(n_queries)):
        raise AssertionError(f"{len(done)} of {n_queries} queries finished")
    worst = 0.0
    for q in done:
        want = answer_query_unbatched(ff.single.predict,
                                      params[ids.index(q.stream)], q,
                                      np.asarray(windows[q.stream])[-1])
        if len(q.answer) != q.horizon or len(want) != q.horizon:
            raise AssertionError(f"query {q.uid}: {len(q.answer)} answers, "
                                 f"horizon {q.horizon}")
        worst = max(worst, max(abs(a - b) for a, b in zip(q.answer, want)))
    return {"worst": worst, "ticks": stage.ticks,
            "dispatches": stage.dispatches, "queries": len(done)}


# the per-query columns of the fixture, each held exactly
QUERY_EXACT = ("uid", "stream", "kind", "horizon", "arrived_at",
               "admitted_at", "finished_at", "model_window",
               "context_window", "served_fallback")


def query_columns(queries, latency: dict) -> dict:
    """A run's queries as the fixture's columns: ``QUERY_EXACT``, the
    answers (n, 3) padded with nan, and each query's latency."""
    cols = {c: np.array([getattr(q, c) for q in queries]) for c in QUERY_EXACT}
    ans = np.full((len(queries), 3), np.nan)
    for i, q in enumerate(queries):
        ans[i, :len(q.answer)] = q.answer
    cols["answer"] = ans
    cols["latency"] = np.array([latency.get(q.uid, np.nan) for q in queries])
    return cols


def _events_equal(got: list, want: list, rtol: float) -> float:
    """A controller's events against the reference's: the same events in
    order, every field exact but a forecast's value (to ``rtol``).  Returns
    the largest relative forecast error."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} controller events, the reference "
                             f"has {len(want)}: {got} vs {want}")
    worst = 0.0
    for g, w in zip(got, want):
        if g["event"] == "forecast" and w["event"] == "forecast":
            err = abs(g["value"] - w["value"]) / abs(w["value"])
            worst = max(worst, err)
            if err > rtol or {**g, "value": 0} != {**w, "value": 0}:
                raise AssertionError(f"event {g}, the reference's {w}")
        elif g != w:
            raise AssertionError(f"event {g}, the reference's {w}")
    return worst


def check_serving_run(fx: dict, name: str, res, ex, atol: float) -> dict:
    """Hold the port's serving run ``name`` to the reference's: every
    query's stamps, windows and fallback flag and its latency exactly, its
    answers to ``atol``; the serving statistics exactly; the fleet's
    dispatch counts; each stream's records (``check_fleet_records``).
    Returns the largest errors."""
    want = {c: fx[f"q/{name}/{c}"] for c in (*QUERY_EXACT, "answer",
                                              "latency")}
    got = query_columns(res.queries, ex._query_lat)
    if len(got["uid"]) != len(want["uid"]):
        raise AssertionError(f"{name}: {len(got['uid'])} queries, the "
                             f"reference has {len(want['uid'])}")
    for c in (*QUERY_EXACT, "latency"):
        if not np.array_equal(got[c], want[c]):
            bad = np.flatnonzero(got[c] != want[c])[:5]
            raise AssertionError(f"{name}: query {c} differs at {bad}: "
                                 f"{got[c][bad]} vs {want[c][bad]}")
    if not np.array_equal(np.isnan(got["answer"]), np.isnan(want["answer"])):
        raise AssertionError(f"{name}: answer counts differ")
    err = float(np.nanmax(np.abs(got["answer"] - want["answer"])))
    if err > atol:
        raise AssertionError(f"{name}: answers off by {err}")
    ref_serving = json.loads(str(fx[f"serving/{name}"]))
    if res.serving != ref_serving:
        raise AssertionError(f"{name}: serving {res.serving}, the "
                             f"reference's {ref_serving}")
    counts = json.loads(str(fx[f"dispatch/{name}"]))
    mine = {"train": res.train_dispatches, "infer": res.infer_dispatches}
    if mine != counts:
        raise AssertionError(f"{name}: dispatches {mine}, the reference's "
                             f"{counts}")
    return {"answer": err,
            "records": check_fleet_records(fx, name, res, rtol=atol,
                                           atol=atol)}


def check_request_run(fx: dict, name: str, res, ex, atol: float,
                      rtol: float = FORECAST_RTOL) -> dict:
    """``check_serving_run``, and for an elastic run the migrations, stream
    sites, worker counts and controller events exactly but each forecast
    to ``rtol``.  Returns the largest errors."""
    worst = check_serving_run(fx, name, res, ex, atol)
    if REQUEST_RUNS[name][1]:
        pl = json.loads(str(fx[f"placement/{name}"]))
        mine = res.placement
        for k in ("mode", "control_interval_s", "migrations", "stream_site",
                  "base_workers", "final_workers"):
            if mine[k] != pl[k]:
                raise AssertionError(f"{name}: placement {k} {mine[k]}, "
                                     f"the reference's {pl[k]}")
        ctl, ref_ctl = mine["controller"], pl["controller"]
        for k in ("ticks", "migrations", "scale_events",
                  "proactive_scale_events", "forecaster_fits"):
            if ctl[k] != ref_ctl[k]:
                raise AssertionError(f"{name}: controller {k} {ctl[k]}, "
                                     f"the reference's {ref_ctl[k]}")
        worst["event"] = _events_equal(ctl["events"], ref_ctl["events"], rtol)
    return worst


def as_json(x):
    """``x`` as the fixture holds it: through a JSON round trip (tuples as
    lists, floats exact)."""
    return json.loads(json.dumps(x))


def bus_columns(message_log) -> dict:
    """A run's bus signature (``core.scenarios.bus_signature``: topic,
    source, bytes, publish and delivery time of every message) as the
    fixture's columns."""
    return {"topic": np.array([m.topic for m in message_log]),
            "src": np.array([m.src for m in message_log]),
            "nbytes": np.array([m.nbytes for m in message_log], np.float64),
            "publish": np.array([m.publish_time for m in message_log],
                                np.float64),
            "deliver": np.array([m.deliver_time for m in message_log],
                                np.float64)}


def chaos_health(ex) -> dict:
    """A run's health verdicts and threshold adaptations, as lists."""
    hp = ex.health_plane
    return {"verdicts": [list(v) for v in hp.verdicts],
            "adaptations": [list(a) for a in hp.adaptations]}


def chaos_draws(fx: dict, fleet_fx: dict) -> dict:
    """{(stream, window, rows): (init params, permutation indices)} of the
    reference's chaos fits: the indices from the chaos fixture, each fit's
    init from the fleet fixture's (it depends on the key alone)."""
    out = {}
    for k, idx in fx.items():
        if not k.startswith("idx/"):
            continue
        _, sid, w, n = k.split("/")
        w, n = int(w[1:]), int(n[1:])
        out[(sid, w, n)] = (unflatten(fleet_fx, f"init_{sid}_w{w}"), idx)
    return out


def run_chaos_replay(fx: dict, device, name: str, fleet_fx=None):
    """The reference's chaos run ``name`` (one of ``CHAOS_RUNS`` or
    ``WATCHDOG_RUN``) through the port on ``device``: the fleet fixture's
    fleet (``compound_drift``: its per-stream drift cycle on the same
    sizes) in the integrated deployment under the scenario's fault plane
    and a fresh health plane (the watchdog run: its delayed-sync plane and
    trace, no health plane), every fleet fit from the reference's draws of
    its (stream, window, rows) (``fleet_replay``).  Returns (the
    ``FleetBusRunResult``, the executor, the fits as ``fleet_replay``
    collects them)."""
    _import_port()
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import FleetStages, lstm_fleet_forecaster
    from repro_torch.core.scenarios import (
        compound_scenarios,
        scenario_plane,
        scenario_quantized,
    )
    from repro_torch.runtime import (
        CostModel,
        FaultPlane,
        FleetBusExecutor,
        HealthConfig,
        HealthPlane,
        MessageFault,
        edge_cloud_integrated,
        paper_topology,
    )
    from repro_torch.serving.query_plane import open_loop_trace

    fleet_fx = load_fixture(FLEET_FIXTURE) if fleet_fx is None else fleet_fx
    setup = unflatten(fleet_fx, "fsetup")
    cs = _scalars(unflatten(fx, "csetup"))
    costs = _scalars(unflatten(fx, "costs/chaos"))
    scenario, adaptive = CHAOS_RUNS.get(name, (None, False))
    if scenario == "compound_drift":
        setup = {**setup, "scenarios": np.array(
            compound_scenarios(int(setup["n_streams"])))}
    streams, _ = fleet_data(setup)
    ff = lstm_fleet_forecaster(get_config("lstm-paper"),
                               epochs=int(setup["speed_epochs"]),
                               batch_size=int(setup["speed_batch_size"]),
                               device=device)
    fits = fleet_replay(ff, chaos_draws(fx, fleet_fx),
                        fleet_window_keys(setup, streams), device, rows=True)
    stages = FleetStages.build(ff, mode="dynamic")
    bp = params_from_numpy(unflatten(fleet_fx, "batch"), device)
    if scenario is None:
        wd = _scalars(unflatten(fx, "watchdog"))
        plane = FaultPlane(wd["fault_seed"], message_faults=[MessageFault(
            "model/latest/*", "delay", p=1.0, delay_s=wd["delay_s"],
            start=wd["fault_start"])])
        trace = open_loop_trace(list(streams), wd["qps"], wd["n_requests"],
                                start=wd["start"], seed=wd["trace_seed"])
        ex = FleetBusExecutor(
            stages, edge_cloud_integrated(), paper_topology(),
            window_period_s=cs["period"], query_trace=trace,
            serve_slots=cs["slots"], fault_plane=plane, stage_costs=costs,
            staleness_bound=cs["staleness_bound"])
        res = ex.run(streams, bp, int(setup["run_key"]),
                     n_windows=wd["n_windows"])
        return res, ex, fits
    ex = FleetBusExecutor(
        stages, edge_cloud_integrated(), paper_topology(),
        CostModel(ingest_s=cs["ingest_s"]), window_period_s=cs["period"],
        qps=cs["qps"], serve_slots=cs["slots"],
        quantized_sync=scenario_quantized(scenario),
        fault_plane=scenario_plane(scenario, cs["fault_seed"], cs["period"]),
        stage_costs=costs, staleness_bound=cs["staleness_bound"],
        health_plane=HealthPlane(HealthConfig(adaptive=adaptive)))
    return ex.run(streams, bp, int(setup["run_key"])), ex, fits


def check_envelope(got: dict, want: dict, rtol: float,
                   where: str = "envelope") -> float:
    """An envelope (JSON as the fixture holds it) against the reference's:
    the same fields, every count, stamp and statistic exactly, each field
    of ``CHAOS_FLOAT_FIELDS`` to ``rtol`` (relative).  Returns the largest
    relative error."""
    if got.keys() != want.keys():
        raise AssertionError(f"{where}: fields {sorted(got)}, the "
                             f"reference's {sorted(want)}")
    worst = 0.0
    for k in want:
        if k in CHAOS_FLOAT_FIELDS:
            err = abs(got[k] - want[k]) / abs(want[k])
            worst = max(worst, err)
            if not err <= rtol:
                raise AssertionError(f"{where} {k}: {got[k]}, the "
                                     f"reference's {want[k]}")
        elif got[k] != want[k]:
            raise AssertionError(f"{where} {k}: {got[k]}, the reference's "
                                 f"{want[k]}")
    return worst


def check_chaos_run(fx: dict, name: str, res, ex, fits: dict, atol: float,
                    rtol: float = CHAOS_RMSE_RTOL) -> dict:
    """Hold the port's chaos run ``name`` to the reference's: the fault
    schedule, the bus signature, the health verdicts and adaptations, the
    fits made (stream, window, rows), every stamp, latency and statistic
    exactly (``check_serving_run``: answers and records to ``atol``); the
    envelope's counts exactly and its RMSE to ``rtol``.  Returns the largest
    errors."""
    _import_port()
    from repro_torch.core.scenarios import scenario_envelope

    sched = as_json(ex.fault_plane.schedule_signature())
    want = json.loads(str(fx[f"schedule/{name}"]))
    if sched != want:
        bad = next(i for i, (a, b) in enumerate(zip(sched + [None],
                                                    want + [None]))
                   if a != b)
        raise AssertionError(f"{name}: fault event {bad} "
                             f"{(sched + [None])[bad]}, the reference's "
                             f"{(want + [None])[bad]}")
    got = bus_columns(res.message_log)
    for c, v in got.items():
        ref = fx[f"bus/{name}/{c}"]
        if v.shape != ref.shape or not np.array_equal(v, ref):
            n = min(len(v), len(ref))
            bad = np.flatnonzero(v[:n] != ref[:n])[:3]
            raise AssertionError(f"{name}: bus {c}, {len(v)} messages, the "
                                 f"reference {len(ref)}; first differences "
                                 f"at {bad}")
    if f"health/{name}" in fx:
        h, ref_h = as_json(chaos_health(ex)), json.loads(
            str(fx[f"health/{name}"]))
        for k in ("verdicts", "adaptations"):
            if h[k] != ref_h[k]:
                raise AssertionError(f"{name}: health {k} {h[k]}, the "
                                     f"reference's {ref_h[k]}")
    made = sorted([sid, w, n] for (sid, w, n), runs in fits.items()
                  for _ in runs)
    if made != json.loads(str(fx[f"fits/{name}"])):
        raise AssertionError(f"{name}: fits {made}, the reference's "
                             f"{json.loads(str(fx[f'fits/{name}']))}")
    worst = check_serving_run(fx, name, res, ex, atol)
    scenario = CHAOS_RUNS.get(name, (name,))[0]
    env = as_json(scenario_envelope(scenario, CHAOS_SETUP["fault_seed"],
                                    res, CHAOS_SETUP["period"]))
    worst["rmse"] = check_envelope(env, json.loads(str(fx[f"env/{name}"])),
                                   rtol, f"{name} envelope")
    return worst


# ---------------------------------------------------------------------------
# The zoo's serving path (tinyllama-1.1b, rwkv6-3b), on any device
# ---------------------------------------------------------------------------


def zoo_parity_config(cfg, n_layers: int = 0, n_experts: int = 0):
    """The parity run's config: the arch at full width in float32, at full
    depth or ``n_layers``, with all its experts or ``n_experts``."""
    cfg = cfg.replace(dtype="float32", param_dtype="float32")
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    if n_experts:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  n_experts=n_experts))
    return cfg


def _param_shapes(cfg) -> dict:
    """{path: (shape, kind)} of the model's params in the reference's tree
    layout: the embedding, the head, the final norm, and the layer stack
    with a leading L axis, of the dense transformer
    (``models/transformer.py: init_params``) or of RWKV6, the ``ssm``
    family (``models/rwkv.py: init_params``); or, for the Zamba2 hybrid
    (``models/hybrid_arch.py: init_params``), the Mamba2 stack ``mamba/*``
    with a leading L axis and the one shared block ``shared/*``.  An MoE
    config's ``first_dense_layers`` dense layers are the stack
    ``layers/*`` and the rest ``moe_layers/*``, whose MLP is the router
    (d, E), the experts ``we_in``, ``we_gate`` (E, d, f) and ``we_out``
    (E, f, d), and the shared experts' ``w_in``, ``w_gate`` and ``w_out``
    (``models/moe.py: init_moe``), each with a leading L axis.  A config
    with a modality frontend (the VLM, the encoder-decoder) adds its
    projector ``proj_in`` (embed_dim, d); the encoder-decoder
    (``models/encdec.py: init_params``) has the encoder's stack
    ``enc_layers/*`` and final norm ``enc_norm/final_norm``, and the
    decoder's ``dec_layers/*``: three norms, the self and cross
    attentions ``self/*`` and ``cross/*``, and the MLP."""
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    qd, kvd, f = cfg.q_dim, cfg.kv_dim, cfg.d_ff
    shapes = {"tok_embed": ((V, d), "embed"), "final_norm": ((d,), "norm")}
    if not cfg.tie_embeddings:
        shapes["out_head"] = ((d, V), "dense")
    if cfg.frontend is not None:
        shapes["proj_in"] = ((cfg.frontend.embed_dim, d), "dense")
    if cfg.family == "hybrid":
        s, H = cfg.ssm, cfg.ssm.expand * d // cfg.ssm.head_dim
        d_inner, xbc = s.expand * d, s.expand * d + 2 * s.state_dim
        mamba = {"in_proj": ((L, d, 2 * d_inner + 2 * s.state_dim + H),
                             "dense"),
                 "conv_w": ((L, s.conv_dim, xbc), "conv"),
                 "conv_b": ((L, xbc), "bias"), "A_log": ((L, H), "a_log"),
                 "D": ((L, H), "norm"), "dt_bias": ((L, H), "dt_bias"),
                 "ssm_norm": ((L, d_inner), "norm"),
                 "out_proj": ((L, d_inner, d), "dense")}
        shared = {"attn_norm": ((d,), "norm"), "mlp_norm": ((d,), "norm"),
                  "wq": ((d, qd), "dense"), "wk": ((d, kvd), "dense"),
                  "wv": ((d, kvd), "dense"), "wo": ((qd, d), "dense"),
                  "w_in": ((d, f), "dense"), "w_gate": ((d, f), "dense"),
                  "w_out": ((f, d), "dense"),
                  "shared_down": ((2 * d, d), "dense")}
        shapes.update({f"mamba/{k}": v for k, v in mamba.items()})
        shapes.update({f"shared/{k}": v for k, v in shared.items()})
        return shapes
    if cfg.family == "ssm":
        N, r = cfg.rwkv.head_size, cfg.rwkv.decay_lora
        layer = {"attn_norm": ((L, d), "norm"), "mlp_norm": ((L, d), "norm"),
                 **{name: ((L, d, d), "dense")
                    for name in ("w_r", "w_k", "w_v", "w_g", "w_o")},
                 "mix_base": ((L, 6, d), "mix"),
                 "mix_lora_a": ((L, d, 5 * 32), "dense"),
                 "mix_lora_b": ((L, 5, 32, d), "mix_lora"),
                 "decay_base": ((L, d), "decay"),
                 "decay_lora_a": ((L, d, r), "dense"),
                 "decay_lora_b": ((L, r, d), "decay_lora"),
                 "bonus": ((L, d // N, N), "bonus"),
                 "ln_x": ((L, d), "norm"), "ck_mix": ((L, 2, d), "mix"),
                 "ck_in": ((L, d, f), "dense"), "ck_out": ((L, f, d), "dense"),
                 "ck_rec": ((L, d, d), "dense")}
        shapes.update({f"layers/{k}": v for k, v in layer.items()})
        return shapes
    gated = cfg.mlp_variant in ("swiglu", "geglu")

    def attention(n):
        layer = {"attn_norm": ((n, d), "norm"), "mlp_norm": ((n, d), "norm"),
                 "wq": ((n, d, qd), "dense"), "wk": ((n, d, kvd), "dense"),
                 "wv": ((n, d, kvd), "dense"), "wo": ((n, qd, d), "dense")}
        if cfg.qkv_bias:
            layer.update(bq=((n, qd), "bias"), bk=((n, kvd), "bias"),
                         bv=((n, kvd), "bias"))
        return layer

    def mlp(n, width, lead=()):
        layer = {"w_in": ((n, *lead, d, width), "dense"),
                 "w_out": ((n, *lead, width, d), "dense")}
        if gated:
            layer["w_gate"] = ((n, *lead, d, width), "dense")
        return layer

    if cfg.family == "audio":
        ne = cfg.encdec.n_encoder_layers
        proj = {k: v for k, v in attention(L).items()
                if not k.endswith("_norm")}
        enc = {**attention(ne), **mlp(ne, f)}
        dec = {"attn_norm": ((L, d), "norm"), "cross_norm": ((L, d), "norm"),
               "mlp_norm": ((L, d), "norm"), **mlp(L, f),
               **{f"self/{k}": v for k, v in proj.items()},
               **{f"cross/{k}": v for k, v in proj.items()}}
        shapes["enc_norm/final_norm"] = ((d,), "norm")
        shapes.update({f"enc_layers/{k}": v for k, v in enc.items()})
        shapes.update({f"dec_layers/{k}": v for k, v in dec.items()})
        return shapes
    n_dense = L if cfg.moe is None else min(cfg.moe.first_dense_layers, L)
    if n_dense:
        layer = {**attention(n_dense), **mlp(n_dense, f)}
        shapes.update({f"layers/{k}": v for k, v in layer.items()})
    if L > n_dense:
        n, moe = L - n_dense, cfg.moe
        layer = {**attention(n), "router": ((n, d, moe.n_experts), "dense"),
                 **{"we" + k[1:]: v for k, v in mlp(
                     n, moe.d_ff_expert, (moe.n_experts,)).items()}}
        if moe.n_shared_experts:
            layer.update(mlp(n, moe.d_ff_expert * moe.n_shared_experts))
        shapes.update({f"moe_layers/{k}": v for k, v in layer.items()})
    return shapes


# RWKV6's uniform draws and Zamba2's A_log: kind -> (low, high)
UNIFORM_KINDS = {"mix": (0.2, 0.8), "mix_lora": (-0.005, 0.005),
                 "decay": (-1.5, -0.5), "a_log": (0.0, float(np.log(16.0)))}
# Zamba2's dt_bias: the inverse softplus of a dt log-uniform on this range
DT_RANGE = (1e-3, 1e-1)


def numpy_params(cfg, seed: int, chunk: int = 0) -> dict:
    """Random float32 params of the dense or MoE transformer, RWKV6 or the
    Zamba2 hybrid, a nested dict of numpy arrays in the reference's tree
    layout.  Each leaf draws from its own generator, seeded by (seed, crc32
    of its path), or with ``chunk`` each piece of ``chunk`` samples of the
    flattened leaf from its own, seeded by (seed, crc32 of its path, the
    piece's index); the draws run on a thread each (numpy's generators
    fill without the GIL) and give the same arrays however many threads
    run.  Dense weights (the experts and the router among them) normal at
    fan-in scale, the embedding normal at d**-0.5, norm gains 1 + 0.1
    normal, biases 0.02 normal.  RWKV6's other leaves:

    - ``mix_base`` and ``ck_mix`` uniform on [0.2, 0.8], ``mix_lora_b``
      uniform on [-0.005, 0.005]: the ddlerp's LoRA (tanh, rank 32) moves a
      coefficient by at most 32 * 0.005 = 0.16, so every token-shift mix
      coefficient lies in [0.04, 0.96], inside [0, 1];
    - ``decay_base`` uniform on [-1.5, -0.5], ``decay_lora_b`` (r, d)
      uniform on [-0.5/r, 0.5/r]: the decay LoRA (tanh, rank r) moves dw by
      at most 0.5, so dw lies in [-2, 0] and every decay
      w = exp(-exp(dw)) in [0.368, 0.873], inside (0, 1) and away from
      both ends at every token;
    - ``bonus`` 0.5 normal.

    Zamba2's Mamba2 leaves (Mamba2's own init, arXiv:2405.21060):

    - ``A_log`` uniform on [0, log 16], so A = -exp(A_log) in [-16, -1];
    - ``dt_bias`` the inverse softplus of a dt log-uniform on [1e-3, 1e-1],
      so softplus(dt_bias) = dt at a zero input; every step
      dt = softplus(raw + dt_bias) > 0, so every decay exp(dt A) lies in
      (0, 1).  In float32 the extremes round to its ends: the reference's
      Mamba blocks take the residual stream unnormalised, which grows
      through the shared blocks (its RMS ~0.05 at the first layer, ~36 at
      the 38th of a 512-wide stack), so raw, and dt, grow with depth, and
      deep layers' largest steps decay to exactly 0 (and tiny ones to 1);
    - ``D`` 1 + 0.1 normal, as a norm gain; ``ssm_norm`` a norm gain;
    - ``conv_w`` normal at ``conv_dim``**-0.5, ``conv_b`` 0.02 normal.

    The reference and the port load the same tree, so neither needs the
    other's init."""
    from concurrent.futures import ThreadPoolExecutor

    tree: dict = {}
    pieces = []
    for path, (shape, kind) in sorted(_param_shapes(cfg).items()):
        w = np.empty(shape, np.float32)
        flat, key = w.reshape(-1), [seed, zlib.crc32(path.encode())]
        if chunk and flat.size > chunk:
            pieces += [(key + [i], flat[i * chunk:(i + 1) * chunk], shape,
                        kind) for i in range(-(-flat.size // chunk))]
        else:
            pieces.append((key, flat, shape, kind))
        *parents, leaf = path.split("/")
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = w

    def draw(piece):
        key, out, shape, kind = piece
        rng = np.random.default_rng(key)
        if kind in UNIFORM_KINDS or kind == "decay_lora":
            lo, hi = UNIFORM_KINDS.get(kind, (-0.5 / shape[-2],
                                              0.5 / shape[-2]))
            out[:] = rng.uniform(lo, hi, out.size)
        elif kind == "dt_bias":
            dt = np.exp(rng.uniform(*np.log(DT_RANGE), out.size))
            out[:] = dt + np.log(-np.expm1(-dt))
        else:
            rng.standard_normal(out=out, dtype=np.float32)
        if kind in ("dense", "embed", "conv"):
            out *= np.float32(shape[-1 if kind == "embed" else -2] ** -0.5)
        elif kind == "norm":
            out *= np.float32(0.1)
            out += np.float32(1.0)
        elif kind == "bias":
            out *= np.float32(0.02)
        elif kind == "bonus":
            out *= np.float32(0.5)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(draw, pieces))
    return tree


def zoo_prompts(cfg, seed: int, shape=ZOO_PROMPTS) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, shape,
                                                dtype=np.int32)


def zoo_prefix(cfg, seed: int, batch: int) -> Optional[np.ndarray]:
    """The stubbed frontend's embeddings (batch, n_prefix_tokens,
    embed_dim), standard normal float32 from numpy ``seed``; None for a
    config without a frontend."""
    if cfg.frontend is None:
        return None
    fe = cfg.frontend
    return np.random.default_rng(seed).standard_normal(
        (batch, fe.n_prefix_tokens, fe.embed_dim), dtype=np.float32)


def prefix_len(cfg, prefix) -> int:
    """Positions a prefix takes before the tokens: the VLM's patches when
    given; the encoder-decoder's frames are its encoder's, not the
    decoder's."""
    return (cfg.frontend.n_prefix_tokens
            if prefix is not None and cfg.family == "vlm" else 0)


def _host(x) -> np.ndarray:
    """A device array (a tensor, or the reference's array) as float32
    numpy on the host."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu()
    return np.asarray(x, np.float32)


def record_logits(engine) -> list:
    """Wrap ``engine``'s prefill and decode so that each call's logits
    land, as float32 numpy (B, V), in the returned list: one entry per
    generated token.  Works on the port's Engine and the reference's."""
    steps = []
    prefill, decode = engine._prefill, engine._decode

    def _prefill(params, batch):
        logits, cache = prefill(params, batch)
        steps.append(_host(logits))
        return logits, cache

    def _decode(params, batch, cache):
        logits, cache = decode(params, batch, cache)
        steps.append(_host(logits))
        return logits, cache

    engine._prefill, engine._decode = _prefill, _decode
    return steps


def logit_summary(steps: list, k: int = ZOO_TOPK) -> dict:
    """Per row and step of ``steps`` (each (B, V)): the logsumexp and the
    top-k (id, logit) pairs, largest first; arrays (B, T) and (B, T, k)."""
    logits = np.stack(steps, axis=1).astype(np.float64)  # (B, T, V)
    m = logits.max(axis=-1, keepdims=True)
    lse = m[..., 0] + np.log(np.exp(logits - m).sum(axis=-1))
    ids = np.argsort(-logits, axis=-1, kind="stable")[..., :k]
    return {"lse": lse.astype(np.float32), "top_ids": ids.astype(np.int32),
            "top_logits": np.take_along_axis(logits, ids, -1).astype(
                np.float32)}


def zoo_fixture_arrays(arch: str, reduced: bool, seed: int,
                       prompts: np.ndarray, tokens: np.ndarray, steps: list,
                       max_len: int, serve: dict,
                       extra: Optional[dict] = None) -> dict:
    """The parity fixture's arrays: the run's metadata, its prompts and
    greedy tokens, ``logit_summary`` of its steps, and the ``serve_*``
    arrays of its serve run (``serve_fixture_run``); the newer fixtures
    add ``extra``: ``fixture_cuts``' config cuts and draw chunk, and for
    an MoE config the ``route_*`` arrays (``route_arrays``).  No weights:
    the params are ``numpy_params(config, seed, draw_chunk)``."""
    return {"arch": np.array(arch), "reduced": np.array(reduced),
            "seed": np.array(seed), "max_len": np.array(max_len),
            "prompts": np.asarray(prompts, np.int32),
            "tokens": np.asarray(tokens, np.int32), **logit_summary(steps),
            **serve, **(extra or {})}


def fixture_cuts(cfg) -> dict:
    """The newer fixtures' record of the config they ran and of the draws:
    the parity config's depth and expert count (0 without experts), and
    ``DRAW_CHUNK``, so that the card rebuilds the same config and
    params."""
    return {"parity_n_layers": np.array(cfg.n_layers),
            "parity_n_experts": np.array(cfg.moe.n_experts if cfg.moe
                                         else 0),
            "draw_chunk": np.array(DRAW_CHUNK)}


# ---------------------------------------------------------------------------
# An MoE config's routing, recorded on either side and held to the fixture
# ---------------------------------------------------------------------------


def routing_record(probs, top_idx, keep, k: int) -> dict:
    """One dispatch call's routing as host numpy: ``idx`` (N, g, k) the
    top-k expert ids, ``keep`` (N, g, k) the slots the capacity kept, and
    ``margin`` (N, g) each token's routing margin, the smallest gap
    between adjacent probabilities among its top k + 1."""
    p = np.sort(np.asarray(_host(probs), np.float64), axis=-1)[..., ::-1]
    top = p[..., :k + 1]
    return {"idx": np.asarray(top_idx.cpu() if hasattr(top_idx, "cpu")
                              else top_idx).astype(np.int32),
            "keep": np.asarray(keep.cpu() if hasattr(keep, "cpu")
                               else keep).astype(bool),
            "margin": (top[..., :-1] - top[..., 1:]).min(-1).astype(
                np.float32)}


def capacity_keep(idx: np.ndarray, n_experts: int, cap: int) -> np.ndarray:
    """The slots (N, g, k) the reference's one-hot dispatch keeps, from its
    top-k ids, in numpy: a slot's place in its expert's queue counts the
    earlier slots of that expert over the flattened (g * k) axis."""
    N, g, k = idx.shape
    flat = idx.reshape(N, g * k)
    counts = np.cumsum(np.eye(n_experts, dtype=np.int64)[flat], axis=1)
    place = np.take_along_axis(counts, flat[..., None], 2)[..., 0] - 1
    return (place < cap).reshape(N, g, k)


@contextlib.contextmanager
def recording_routes():
    """Record every dispatch call of the port's MoE layer, in call order,
    as ``routing_record``s: wraps ``models/moe.py``'s ``route`` and
    ``kept_slots``, which ``dispatch`` calls once each a call."""
    _import_port()
    from repro_torch.models import moe

    calls: list = []
    route, kept = moe.route, moe.kept_slots
    pending: dict = {}

    def _route(cfg, router_w, x):
        probs, top_p, top_idx = route(cfg, router_w, x)
        pending.update(probs=probs, k=cfg.moe.top_k)
        return probs, top_p, top_idx

    def _kept(top_idx, n_experts, capacity):
        keep = kept(top_idx, n_experts, capacity)
        calls.append(routing_record(pending["probs"], top_idx, keep,
                                    pending["k"]))
        return keep

    moe.route, moe.kept_slots = _route, _kept
    try:
        yield calls
    finally:
        moe.route, moe.kept_slots = route, kept


def route_arrays(calls: list, batch: int, n_moe: int) -> dict:
    """A generate's routing records (the prefill's ``n_moe`` MoE layers,
    then each decode step's) as the fixture's arrays: ``route_prefill_*``
    (L_moe, B, S, ...) and ``route_decode_*`` (steps, L_moe, B, ...), for
    ``idx``, ``keep`` and ``margin``."""
    out = {}
    for part, recs in (("prefill", calls[:n_moe]), ("decode", calls[n_moe:])):
        for key in ("idx", "keep", "margin"):
            arr = np.stack([r[key].reshape(batch, -1, *r[key].shape[2:])
                            for r in recs]) if recs else np.zeros((0,))
            if part == "decode" and recs:
                arr = arr.reshape(-1, n_moe, *arr.shape[1:])[:, :, :, 0]
            out[f"route_{part}_{key}"] = arr
    return out


def check_zoo_routes(fx: dict, tokens: np.ndarray, calls: list,
                     atol: float = ZOO_ROUTE_ATOL) -> dict:
    """Hold the port's routing in a parity generate to the fixture's, step
    by step and row by row: the same top-k ids in order and the same kept
    slots.  A row whose routing differs where the reference's routing
    margin is below ``atol`` (a near tie) is compared no further; a row
    whose token differs from the reference's (a logit near tie) is
    compared up to that step's routing.  Returns {"stops": {row: the
    step its comparison ended, for check_zoo_parity}, "route_near_ties":
    [(row, step, margin)], "dropped": the dropped slots compared,
    "dropped_ref": every dropped slot of the reference's run}."""
    B, T = fx["tokens"].shape
    n_moe = fx["route_prefill_idx"].shape[0]
    got = route_arrays(calls, B, n_moe)
    stops, near, dropped, active = {}, [], 0, set(range(B))
    for t in range(T):
        if t == 0:
            parts = [got["route_prefill_" + k] for k in ("idx", "keep")]
            want = [fx["route_prefill_" + k] for k in ("idx", "keep",
                                                       "margin")]
        else:
            parts = [got["route_decode_" + k][t - 1][:, :, None]
                     for k in ("idx", "keep")]
            want = [fx["route_decode_" + k][t - 1][:, :, None]
                    for k in ("idx", "keep", "margin")]
        for b in sorted(active):
            idx, keep = (a[:, b] for a in parts)
            idx_ref, keep_ref, margin = (a[:, b] for a in want)
            differs = (idx != idx_ref).any(-1)  # (L_moe, S)
            if differs.any():
                worst = float(margin[differs].max())
                if worst >= atol:
                    raise AssertionError(
                        f"row {b}, step {t}: the router chose experts "
                        f"{idx[differs][0]}, the reference's "
                        f"{idx_ref[differs][0]} (routing margin {worst:.3g} "
                        f">= {atol})")
                near.append((b, t, worst))
                stops[b] = t
                active.discard(b)
                continue
            if not np.array_equal(keep, keep_ref):
                raise AssertionError(f"row {b}, step {t}: the capacity kept "
                                     "other slots than the reference's")
            dropped += int((~keep).sum())
        active -= {b for b in active if tokens[b, t] != fx["tokens"][b, t]}
    dropped_ref = int((~fx["route_prefill_keep"]).sum()
                      + (~fx["route_decode_keep"]).sum())
    return {"stops": stops, "route_near_ties": near, "dropped": dropped,
            "dropped_ref": dropped_ref}


def serve_fixture_run(engine_cls, request_cls, cfg, params) -> dict:
    """``serve_check`` on an engine class (the reference's, which writes
    the fixtures), each call's logits recorded; returns
    ``serve_fixture_arrays``."""
    engine = engine_cls(cfg, params, max_len=SERVE_CHECK_MAX_LEN)
    calls = record_serve_calls(engine)
    return serve_fixture_arrays(serve_check(engine, cfg, request_cls), calls)


def zoo_config(fx: dict):
    """The config of a parity fixture: its arch at full width in float32,
    or ``.reduced()``, with the cuts a newer fixture records
    (``fixture_cuts``)."""
    _import_port()
    from repro_torch.configs import get_config

    cfg = get_config(str(fx["arch"]))
    n_layers = int(fx.get("parity_n_layers", 0))
    n_experts = int(fx.get("parity_n_experts", 0))
    if bool(fx["reduced"]):
        return zoo_reduced_config(cfg, n_experts)
    return zoo_parity_config(cfg, n_layers, n_experts)


def zoo_reduced_config(cfg, n_experts: int = 0):
    """``cfg.reduced()``, with ``n_experts`` experts where given (kimi's
    reduced config has 4 and never reaches the capacity path)."""
    cfg = cfg.reduced()
    if n_experts:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  n_experts=n_experts))
    return cfg


def run_zoo_parity(fx: dict, device):
    """The fixture's run on the port: params from ``numpy_params`` on
    ``device``, the prompts through ``Engine.generate``.  Returns (cfg,
    params, tokens, steps)."""
    _import_port()
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving.engine import Engine

    cfg = zoo_config(fx)
    params = params_from_numpy(numpy_params(
        cfg, int(fx["seed"]), int(fx.get("draw_chunk", 0))), device)
    engine = Engine(cfg, params, max_len=int(fx["max_len"]), device=device)
    steps = record_logits(engine)
    tokens, _ = engine.generate(fx["prompts"], fx["tokens"].shape[1],
                                prefix_embed=fixture_prefix(cfg, fx))
    return cfg, params, tokens, steps


def fixture_prefix(cfg, fx: dict) -> Optional[np.ndarray]:
    """A parity fixture's prefix embeddings, ``zoo_prefix`` at the seed it
    records (``prefix_seed``; none in the fixtures of configs without a
    frontend)."""
    if "prefix_seed" not in fx:
        return None
    return zoo_prefix(cfg, int(fx["prefix_seed"]), fx["prompts"].shape[0])


def check_zoo_parity(fx: dict, tokens: np.ndarray, steps: list,
                     atol: float, route_stops: Optional[dict] = None) -> dict:
    """Hold the port's greedy tokens and logits to the fixture: tokens
    equal; at every step, the logits at the reference's top-k ids and the
    logsumexp within ``atol``.  A token may differ only where the
    reference's top-1/top-2 gap is below ``atol``; that row is then
    compared up to the step where it differs.  ``route_stops`` ({row:
    step}, ``check_zoo_routes``') ends a row's comparison before the step
    where its routing met a near tie.  Returns the measured
    {"logit_err", "lse_err", "near_ties"}."""
    got = np.stack(steps, axis=1)  # (B, T, V)
    lse = logit_summary(steps)["lse"]
    logit_err = lse_err = 0.0
    near_ties = []
    for b in range(fx["tokens"].shape[0]):
        cut = (route_stops or {}).get(b, tokens.shape[1])
        diff = np.flatnonzero(tokens[b, :cut] != fx["tokens"][b, :cut])
        last = int(diff[0]) if diff.size else cut - 1
        if last < 0:
            continue  # the prefill's routing met a near tie
        if diff.size:
            gap = float(fx["top_logits"][b, last, 0]
                        - fx["top_logits"][b, last, 1])
            if gap >= atol:
                raise AssertionError(
                    f"row {b}: token {last} is {tokens[b, last]}, the "
                    f"reference's {fx['tokens'][b, last]} (top-2 gap "
                    f"{gap:.3g} >= {atol})")
            near_ties.append((b, last, gap))
        ids = fx["top_ids"][b, :last + 1]
        mine = np.take_along_axis(got[b, :last + 1], ids, -1)
        logit_err = max(logit_err, float(np.abs(
            mine - fx["top_logits"][b, :last + 1]).max()))
        lse_err = max(lse_err, float(np.abs(
            lse[b, :last + 1] - fx["lse"][b, :last + 1]).max()))
    if logit_err > atol or lse_err > atol:
        raise AssertionError(f"logits off the reference's: top-{ZOO_TOPK} "
                             f"{logit_err:.3g}, logsumexp {lse_err:.3g} "
                             f"(atol {atol})")
    return {"logit_err": logit_err, "lse_err": lse_err,
            "near_ties": near_ties}


def full_logits(cfg, params, tokens, prefix=None):
    """Every token position's logits of one full forward over ``tokens``
    (after the ``prefix_embed`` ``prefix``, where given)."""
    from repro_torch.models import blocks
    from repro_torch.models.model import get_model

    batch = {"tokens": tokens}
    if prefix is not None:
        batch["prefix_embed"] = prefix
    h = get_model(cfg).forward(params, batch)
    return blocks.logits_fn(cfg, params, h[:, h.shape[1] - tokens.shape[1]:])


def decode_equivalence(cfg, params, tokens: np.ndarray, n_prefill: int,
                       device, prefix: Optional[np.ndarray] = None) -> float:
    """Step-by-step decode against one full forward over the same tokens
    (and the same prefix embeddings, where given): prefill ``n_prefill``
    tokens, decode the rest teacher-forced, and return the largest |logit
    difference| from ``forward``'s logits at every decoded position (the
    reference's strongest serving invariant,
    tests/test_decode_equivalence.py)."""
    import torch

    from repro_torch.models.model import get_model

    model = get_model(cfg)
    with torch.no_grad():
        t = torch.tensor(np.asarray(tokens, np.int32), device=device)
        B, S = t.shape
        extra, offset = {}, prefix_len(cfg, prefix)
        if prefix is not None:
            extra["prefix_embed"] = torch.as_tensor(prefix, device=device)
        full = full_logits(cfg, params, t, extra.get("prefix_embed"))
        logits, cache = model.prefill(
            params, {"tokens": t[:, :n_prefill], **extra}, S + offset)
        err = float((logits - full[:, n_prefill - 1]).abs().max())
        for i in range(n_prefill, S):
            pos = torch.full((B,), i + offset, dtype=torch.int32,
                             device=device)
            logits, cache = model.decode_step(
                params, {"token": t[:, i:i + 1], "pos": pos}, cache)
            err = max(err, float((logits - full[:, i]).abs().max()))
    return err


def zoo_requests(cfg, seed: int = ZOO_SEED, lens=SERVE_PROMPT_LENS,
                 new_tokens=SERVE_NEW_TOKENS, request_cls=None) -> list:
    """Engine.serve's requests: prompts of ``lens`` tokens from numpy
    ``seed``, ``new_tokens`` new tokens each, as ``request_cls`` (the
    port's ``Request`` unless the reference's is given)."""
    if request_cls is None:
        _import_port()
        from repro_torch.serving.batching import Request as request_cls

    rng = np.random.default_rng(seed)
    return [request_cls(uid=i, prompt=rng.integers(1, cfg.vocab_size, (n,),
                                                   dtype=np.int32),
                        max_new_tokens=new)
            for i, (n, new) in enumerate(zip(lens, new_tokens))]


def serve_check(engine, cfg, request_cls=None) -> list:
    """The float32 serve check's run: ``SERVE_CHECK_*``'s requests through
    ``engine.serve`` (an engine of ``SERVE_CHECK_MAX_LEN``, the port's or
    the reference's) on ``SERVE_CHECK_SLOTS`` slots; the finished
    requests."""
    return engine.serve(zoo_requests(cfg, SERVE_CHECK_SEED,
                                     SERVE_CHECK_PROMPT_LENS,
                                     SERVE_CHECK_NEW_TOKENS, request_cls),
                        n_slots=SERVE_CHECK_SLOTS)


def record_serve_calls(engine) -> list:
    """Wrap ``engine``'s prefill and decode so that each call lands in the
    returned list as (kind, the prefill's tokens or None, its logits as
    float32 numpy (n_slots, V)).  Works on the port's Engine and the
    reference's."""
    calls = []
    prefill, decode = engine._prefill, engine._decode

    def _prefill(params, batch):
        logits, cache = prefill(params, batch)
        toks = batch["tokens"]
        toks = toks.cpu().numpy() if hasattr(toks, "detach") else toks
        calls.append(("prefill", np.asarray(toks), _host(logits)))
        return logits, cache

    def _decode(params, batch, cache):
        logits, cache = decode(params, batch, cache)
        calls.append(("decode", None, _host(logits)))
        return logits, cache

    engine._prefill, engine._decode = _prefill, _decode
    return calls


def serve_margins(done: list, calls: list, pad_id: int = 0) -> dict:
    """uid -> the top-2 logit margin behind each token ``Engine.serve``
    generated for that request, from ``record_serve_calls``' list.  Each
    tick runs at most one prefill and then at most one decode, so a call
    opens a new tick unless it is a decode after a prefill; a request's
    row is the one whose left-padded prompt is its own, its first token
    comes from the prefill at ``admitted_at`` and its n-th from the decode
    at tick ``admitted_at + n - 1``."""
    ticks, tick, last = [], -1, None
    for kind, _, _ in calls:
        if not (kind == "decode" and last == "prefill"):
            tick += 1
        ticks.append(tick)
        last = kind
    prefills = {t: (toks, lg) for t, (kind, toks, lg) in zip(ticks, calls)
                if kind == "prefill"}
    decodes = {t: lg for t, (kind, _, lg) in zip(ticks, calls)
               if kind == "decode"}

    def margin(row):
        top = np.sort(row.astype(np.float64))[-2:]
        return float(top[1] - top[0])

    out = {}
    for r in done:
        a, n = int(r.admitted_at), len(r.prompt)
        toks, lg = prefills[a]
        rows = [i for i in range(toks.shape[0])
                if (toks[i, -n:] == r.prompt).all()
                and (toks[i, :-n] == pad_id).all()]
        if len(rows) != 1:
            raise AssertionError(f"request {r.uid}: its prompt is in rows "
                                 f"{rows} of the prefill at tick {a}")
        row = rows[0]
        steps = [lg[row]] + [decodes[a + m][row]
                             for m in range(len(r.generated) - 1)]
        if [int(np.argmax(s)) for s in steps] != list(r.generated):
            raise AssertionError(f"request {r.uid}: the recorded logits do "
                                 "not give its tokens")
        out[r.uid] = [margin(s) for s in steps]
    return out


def serve_fixture_arrays(done: list, calls: list) -> dict:
    """The parity fixture's ``serve_*`` arrays of a finished
    ``serve_check``: per request (rows in uid order) its generated tokens
    (-1 past its end), ``admitted_at``, ``finished_at`` and each token's
    top-2 logit margin (NaN past its end)."""
    done = sorted(done, key=lambda r: r.uid)
    margins = serve_margins(done, calls)
    width = max(r.max_new_tokens for r in done)
    tokens = np.full((len(done), width), -1, np.int32)
    margin = np.full((len(done), width), np.nan, np.float32)
    for i, r in enumerate(done):
        tokens[i, :len(r.generated)] = r.generated
        margin[i, :len(r.generated)] = margins[r.uid]
    return {"serve_tokens": tokens,
            "serve_admitted_at": np.array([r.admitted_at for r in done],
                                          np.int32),
            "serve_finished_at": np.array([r.finished_at for r in done],
                                          np.int32),
            "serve_margin": margin}


def check_zoo_serve(fx: dict, done: list, atol: float) -> dict:
    """Hold a finished ``serve_check`` to the fixture: every request's
    ``admitted_at`` and ``finished_at`` equal, its tokens equal.  A token
    may differ only where the reference's top-2 margin at that step is
    below ``atol`` (a near tie); that request is compared up to there.  Returns {"tokens": tokens compared,
    "near_ties": [(uid, step, margin)], "min_margin": the smallest
    reference margin among the tokens compared}."""
    by_uid = {r.uid: r for r in done}
    if sorted(by_uid) != list(range(fx["serve_tokens"].shape[0])):
        raise AssertionError(f"serve finished requests {sorted(by_uid)}")
    compared, near_ties, min_margin = 0, [], float("inf")
    for uid in sorted(by_uid):
        r = by_uid[uid]
        want = fx["serve_tokens"][uid]
        want = want[want >= 0]
        stamps = (r.admitted_at, r.finished_at)
        ref_stamps = (int(fx["serve_admitted_at"][uid]),
                      int(fx["serve_finished_at"][uid]))
        if stamps != ref_stamps or len(r.generated) != len(want):
            raise AssertionError(f"request {uid}: admitted, finished at "
                                 f"{stamps} with {len(r.generated)} tokens; "
                                 f"the reference's {ref_stamps} with "
                                 f"{len(want)}")
        got = np.asarray(r.generated)
        diff = np.flatnonzero(got != want)
        last = int(diff[0]) if diff.size else len(want)
        margins = fx["serve_margin"][uid]
        if diff.size:
            if margins[last] >= atol:
                raise AssertionError(
                    f"request {uid}: token {last} is {got[last]}, the "
                    f"reference's {want[last]} (top-2 margin "
                    f"{margins[last]:.3g} >= {atol})")
            near_ties.append((uid, last, float(margins[last])))
        compared += last
        if last:
            min_margin = min(min_margin, float(margins[:last].min()))
    return {"tokens": compared, "near_ties": near_ties,
            "min_margin": min_margin}


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def _kernel_inputs(B, T, F, H, dtype, seed, w_dtype="float32"):
    import torch

    rng = np.random.default_rng(seed)
    x = rng.random((B, T, F))  # min-max scaled inputs lie in [0, 1]
    wx = rng.normal(size=(F, 4 * H)) * F**-0.5
    wh = rng.normal(size=(H, 4 * H)) * H**-0.5
    b = rng.normal(size=(4 * H,)) * 0.1
    dev = torch.device("cuda")
    return (torch.tensor(x, dtype=getattr(torch, dtype), device=dev),
            *(torch.tensor(a, dtype=getattr(torch, w_dtype), device=dev)
              for a in (wx, wh, b)))


def _median_ms(fn, n=200, warmup=20) -> float:
    """Median over ``n`` calls of the device time between CUDA events
    recorded around each call, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def _bound(nbytes: float, flops: float,
           peak_flop_per_s: float = PEAK_F32_FLOP_PER_S):
    """Least time for work that moves ``nbytes`` and does ``flops``
    operations at ``peak_flop_per_s`` (float32 by default): the larger of
    the two over the card's peak rates.  Returns (ms, "bytes" |
    "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flop_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def _tc_bound(nbytes: float, tf32_flops: float, f32_flops: float):
    """``_bound`` for work split between the tensor cores, ``tf32_flops``
    at the TF32 rate, and the CUDA cores, ``f32_flops`` at the float32
    rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = tf32_flops / PEAK_TF32_FLOP_PER_S + f32_flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def _forward_flops(B, T, F, H):
    """The forward's products: x @ wx at every step, h @ wh at the T-1
    steps after the first (h is zero at t=0)."""
    return 2 * B * T * F * 4 * H + 2 * B * (T - 1) * H * 4 * H


def _lstm_bound(B, T, F, H):
    """Bound of one serving forward at (B,T,F,H) float32: x and the weights
    read once, the final (h, c) written once; the two products."""
    nbytes = 4 * (B * T * F + F * 4 * H + H * 4 * H + 4 * H + 2 * B * H)
    return _bound(nbytes, _forward_flops(B, T, F, H))


def _fwd_train_bound(B, T, F, H):
    """Bound of one training forward: as the serving forward, but writing
    the gates (B,T,4H) and c_seq, h_seq (B,T,H)."""
    nbytes = 4 * (B * T * F + F * 4 * H + H * 4 * H + 4 * H + B * T * 6 * H)
    return _bound(nbytes, _forward_flops(B, T, F, H))


def _bwd_bound(B, T, F, H):
    """Bound of one backward: x, the residuals, wx, wh, dh and dc read once;
    dx, dwx, dwh and db written once.  Operations: the dx, dwx and db
    products over every step; dh = dz @ wh^T and dwh over the T-1 steps
    that have a predecessor (at t=0 h_prev is zero and its gradient is no
    output)."""
    G = 4 * H
    nbytes = 4 * (B * T * F + B * T * G + 2 * B * T * H + F * G + H * G
                  + 2 * B * H + B * T * F + F * G + H * G + G)
    flops = (2 * 2 * B * T * F * G + 2 * 2 * B * (T - 1) * H * G
             + B * T * G)
    return _bound(nbytes, flops)


def _cudnn_lstm(wx, wh, b):
    """``torch.nn.LSTM`` (cuDNN) on the card with the port's weights: the
    library call timed beside the kernels, never used by the port."""
    import torch

    F, G = wx.shape
    lstm = torch.nn.LSTM(F, G // 4, batch_first=True).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.T)
        lstm.weight_hh_l0.copy_(wh.T)
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    return lstm


def kernel_phase() -> dict:
    """The serving kernel against its plain version at every case, each
    case run twice (bit for bit), then timed at the serving path's shape
    beside cuDNN's LSTM, by CUDA events and by the profiler's device time.
    Returns the numbers of its row."""
    import torch

    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.lstm_cell.ref import lstm_sequence_ref

    max_err = 0.0
    for i, (B, T, F, H, dtype, *w_dtype) in enumerate(KERNEL_CASES):
        H = lstm_kernel.max_hidden(F) if H is None else H
        w_dtype = w_dtype[0] if w_dtype else "float32"
        x, wx, wh, b = _kernel_inputs(B, T, F, H, dtype, seed=i,
                                      w_dtype=w_dtype)
        with torch.inference_mode():
            runs = [lstm_kernel.lstm_sequence_fused(x, wx, wh, b)
                    for _ in range(2)]
            h_ref, c_ref = lstm_sequence_ref(x, wx, wh, b, return_state=True)
        torch.cuda.synchronize()
        h, c = runs[0]
        same = all(torch.equal(u, v) for u, v in zip(*runs))
        errs = [float((k.float() - r.float()).abs().max())
                for k, r in ((h, h_ref), (c, c_ref))]
        if dtype == "float32":
            ok = max(errs) <= KERNEL_ATOL
            max_err = max(max_err, *errs)
            limit = f"<= {KERNEL_ATOL}"
        else:
            # bf16 outputs: both sides compute in float32 and round once, so
            # they may differ by one bf16 step (2^-7 of the value) where the
            # float32 results straddle a rounding boundary
            ok = all(bool(((k.float() - r.float()).abs()
                           <= 2.0**-7 * r.float().abs() + KERNEL_ATOL).all())
                     for k, r in ((h, h_ref), (c, c_ref)))
            limit = "<= one bf16 step"
        ok = ok and same
        print(f"kernel lstm_sequence_fused B={B} T={T} F={F} H={H} {dtype}, "
              f"{w_dtype} weights: max|dh|={errs[0]:.3g} max|dc|="
              f"{errs[1]:.3g} ({limit}); 2 runs "
              f"{'bit-identical' if same else 'DIFFER'} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(
                f"lstm_sequence_fused disagrees with its plain version or "
                f"with itself at B={B} T={T} F={F} H={H} {dtype}, {w_dtype} "
                f"weights: {errs}")

    B, T, F, H = MAIN_SHAPE
    x, wx, wh, b = _kernel_inputs(B, T, F, H, "float32", seed=100)
    lstm = _cudnn_lstm(wx, wh, b)
    with torch.inference_mode():
        h_lib = lstm(x)[1][0][0]
        h_ker, _ = lstm_kernel.lstm_sequence_fused(x, wx, wh, b)
        lib_err = float((h_lib - h_ker).abs().max())
        print(f"torch.nn.LSTM vs kernel at {MAIN_SHAPE}: max|dh|={lib_err:.3g}")
        if lib_err > 1e-4:
            raise AssertionError("torch.nn.LSTM does not compute the kernel's "
                                 f"function on these weights: {lib_err}")
        def kern():
            return lstm_kernel.lstm_sequence_fused(x, wx, wh, b)

        kernel_ms = _median_ms(kern)
        plain_ms = _median_ms(lambda: lstm_sequence_ref(x, wx, wh, b))
        library_ms = _median_ms(lambda: lstm(x))
        # device times in turns: kernel, cuDNN, cuDNN, kernel
        turns = [_kernel_device_ms(kern, [SERVE_FWD_KERNEL])[SERVE_FWD_KERNEL],
                 _device_ms_per_call(lambda: lstm(x)),
                 _device_ms_per_call(lambda: lstm(x)),
                 _kernel_device_ms(kern, [SERVE_FWD_KERNEL])[SERVE_FWD_KERNEL]]
    device_ms = (None if None in (turns[0], turns[3])
                 else (turns[0] + turns[3]) / 2)
    library_device_ms = (None if None in (turns[1], turns[2])
                         else (turns[1] + turns[2]) / 2)
    bound_ms, bound_by = _lstm_bound(B, T, F, H)
    print(f"timing at {MAIN_SHAPE} float32 (median of 200, CUDA events): "
          f"kernel {kernel_ms:.6f} ms, plain {plain_ms:.6f} ms, "
          f"torch.nn.LSTM {library_ms:.6f} ms; device time in turns kernel, "
          f"cuDNN, cuDNN, kernel {turns} ms (the kernel: profiler median of "
          f"100; cuDNN: all its kernels, mean of 100): kernel {device_ms} "
          f"ms, torch.nn.LSTM {library_device_ms} ms; bound {bound_ms:.6f} "
          f"ms ({bound_by})", flush=True)
    return {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms_phase3": device_ms,
            "library_device_ms": library_device_ms}


def _train_case(B, T, F, H, dtype, seed, w_dtype="float32"):
    """Inputs of the training pair at one case: x and the weights (the
    float32 copies of bf16 ones, which the backward takes), the residuals of
    the training forward on the card from the weights as drawn, and random
    cotangents dh, dc of the final state."""
    import torch

    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel

    x, wx, wh, b = _kernel_inputs(B, T, F, H, dtype, seed, w_dtype)
    res = lstm_kernel.lstm_sequence_fwd_train(x, wx, wh, b)
    wx, wh, b = lstm_kernel.f32_weights(wx, wh, b)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dh = torch.randn((B, H), generator=g, device="cuda")
    dc = torch.randn((B, H), generator=g, device="cuda")
    return (x, wx, wh, b), res, dh, dc


def train_kernel_phase() -> dict:
    """The training pair against its plain versions at every case, and
    against the plain versions of their own algorithms
    (``ref.lstm_sequence_fwd_train_tiled_ref``, and
    ``ref.lstm_sequence_bwd_tiled_ref`` at the tiling the backward reports),
    both run on the card; each kernel rerun bit for bit.  Then both timed at
    the speed fit's, the pretrain's and the legacy fit's ragged step shapes
    (``TRAIN_SHAPES``) beside their plain versions and cuDNN (CUDA events,
    and the profiler's device time of cuDNN's calls).  Returns the numbers
    of their rows."""
    import torch

    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.lstm_cell import ref

    def within(got, want):
        return bool(((got - want).abs() <= BWD_ATOL + BWD_RTOL * want.abs()).all())

    max_fwd = max_bwd = 0.0
    for i, (B, T, F, H, dtype, *w_dtype) in enumerate(TRAIN_CASES):
        H = lstm_kernel.max_hidden_bwd(F) if H is None else H
        w_dtype = w_dtype[0] if w_dtype else "float32"
        (x, wx, wh, b), res, dh, dc = _train_case(B, T, F, H, dtype, 200 + i,
                                                  w_dtype)
        res_again = lstm_kernel.lstm_sequence_fwd_train(x, wx, wh, b)
        res_ref = ref.lstm_sequence_fwd_train_ref(x, wx, wh, b)
        res_tiled = ref.lstm_sequence_fwd_train_tiled_ref(x, wx, wh, b)
        tiling = lstm_kernel.bwd_tiling(B, T, F, H)
        grads = lstm_kernel.lstm_sequence_bwd(x, *res, wx, wh, dh, dc)
        again = lstm_kernel.lstm_sequence_bwd(x, *res, wx, wh, dh, dc)
        grads_ref = ref.lstm_sequence_bwd_ref(x, *res, wx, wh, dh, dc)
        grads_tiled = ref.lstm_sequence_bwd_tiled_ref(
            x, *res, wx, wh, dh, dc, rows=tiling.rows, lanes=tiling.lanes,
            chunk=tiling.chunk)
        torch.cuda.synchronize()
        fwd_errs = [float((k - r).abs().max()) for k, r in zip(res, res_ref)]
        tiled_fwd_errs = [float((k - r).abs().max())
                          for k, r in zip(res, res_tiled)]
        bwd_errs = [float((k - r).abs().max()) for k, r in zip(grads, grads_ref)]
        tiled_errs = [float((k - r).abs().max())
                      for k, r in zip(grads, grads_tiled)]
        fwd_ok = max(fwd_errs + tiled_fwd_errs) <= KERNEL_ATOL
        bwd_ok = all(within(k, r) for k, r in zip(grads[1:], grads_ref[1:]))
        tiled_ok = all(within(k, r) for k, r in zip(grads[1:], grads_tiled[1:]))
        if dtype == "float32":
            bwd_ok = bwd_ok and within(grads[0], grads_ref[0])
            tiled_ok = tiled_ok and within(grads[0], grads_tiled[0])
            max_fwd, max_bwd = max(max_fwd, *fwd_errs), max(max_bwd, *bwd_errs)
        else:
            # dx goes back in x's type: held to one bf16 step of the value
            def bf16_step(want):
                dxk, dxr = grads[0].to(x.dtype).float(), want.to(x.dtype).float()
                return bool(((dxk - dxr).abs()
                             <= 2.0**-7 * dxr.abs() + KERNEL_ATOL).all())

            bwd_ok = bwd_ok and bf16_step(grads_ref[0])
            tiled_ok = tiled_ok and bf16_step(grads_tiled[0])
        same_fwd = all(torch.equal(k, r) for k, r in zip(res, res_again))
        same = all(torch.equal(k, r) for k, r in zip(grads, again))
        print(f"kernel lstm_sequence_fwd_train B={B} T={T} F={F} H={H} "
              f"{dtype}, {w_dtype} weights (one row a block): max|d gates, "
              f"c_seq, h_seq|={max(fwd_errs):.3g},"
              f" against its algorithm {max(tiled_fwd_errs):.3g} (<= "
              f"{KERNEL_ATOL}) {'ok' if fwd_ok else 'FAIL'}; rerun "
              f"{'bit-identical' if same_fwd else 'DIFFERS'}")
        print(f"kernel lstm_sequence_bwd B={B} T={T} F={F} H={H} {dtype}, "
              f"{w_dtype} weights ({tiling.rows} rows a block, {tiling.chunk} "
              f"steps a chunk, dh over {tiling.lanes} lanes, {tiling.blocks} "
              f"partials): max|d dx, dwx, dwh, db|="
              f"{', '.join(f'{e:.3g}' for e in bwd_errs)}, against its "
              f"algorithm {', '.join(f'{e:.3g}' for e in tiled_errs)} (atol "
              f"= rtol = {BWD_ATOL}"
              f"{'; dx to one bf16 step' if dtype != 'float32' else ''}) "
              f"{'ok' if bwd_ok and tiled_ok else 'FAIL'}; rerun "
              f"{'bit-identical' if same else 'DIFFERS'}", flush=True)
        if not (fwd_ok and bwd_ok and tiled_ok and same and same_fwd):
            raise AssertionError(
                f"training pair at B={B} T={T} F={F} H={H} {dtype}, "
                f"{w_dtype} weights: forward {fwd_errs}, against its "
                f"algorithm {tiled_fwd_errs}, rerun identical {same_fwd}; "
                f"backward {bwd_errs}, against its algorithm {tiled_errs}, "
                f"rerun identical {same}")

    rows = {"lstm_sequence_fwd_train": {"max_abs_err": max_fwd, "by_batch": {}},
            "lstm_sequence_bwd": {"max_abs_err": max_bwd, "by_batch": {}}}
    for B, T, F, H in TRAIN_SHAPES:
        (x, wx, wh, b), res, dh, _ = _train_case(B, T, F, H, "float32", 300)
        dc = torch.zeros_like(dh)
        lstm = _cudnn_lstm(wx, wh, b)
        x_lib = x.clone().requires_grad_(True)
        wrt = [x_lib, lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_ih_l0]
        h_lib = lstm(x_lib)[1][0][0]
        g_lib = torch.autograd.grad(h_lib, wrt, grad_outputs=dh,
                                    retain_graph=True)
        g_ker = lstm_kernel.lstm_sequence_bwd(x, *res, wx, wh, dh, dc)
        # cuDNN sums in its own order: weight gradients summed over B*T rows
        # differ by more than 1e-4 in absolute terms where they are large
        pairs = [(res[2][:, -1], h_lib.detach()), (g_ker[0], g_lib[0]),
                 (g_ker[1], g_lib[1].T), (g_ker[2], g_lib[2].T),
                 (g_ker[3], g_lib[3])]
        lib_err = max(float((k - l).abs().max()) for k, l in pairs)
        lib_ok = all(bool(((k - l).abs() <= 1e-4 + 1e-4 * l.abs()).all())
                     for k, l in pairs)
        print(f"torch.nn.LSTM vs the training pair at {(B, T, F, H)}: "
              f"max|d h, dx, dwx, dwh, db|={lib_err:.3g} (atol = rtol = 1e-4)")
        if not lib_ok:
            raise AssertionError("torch.nn.LSTM does not compute the training "
                                 f"pair's functions on these weights: {lib_err}")
        timings = {
            "lstm_sequence_fwd_train": (
                lambda: lstm_kernel.lstm_sequence_fwd_train(x, wx, wh, b),
                lambda: ref.lstm_sequence_fwd_train_ref(x, wx, wh, b),
                lambda: lstm(x_lib),
                _fwd_train_bound(B, T, F, H)),
            "lstm_sequence_bwd": (
                lambda: lstm_kernel.lstm_sequence_bwd(x, *res, wx, wh, dh, dc),
                lambda: ref.lstm_sequence_bwd_ref(x, *res, wx, wh, dh, dc),
                lambda: torch.autograd.grad(h_lib, wrt, grad_outputs=dh,
                                            retain_graph=True),
                _bwd_bound(B, T, F, H)),
        }
        for name, (kern, plain, lib, (bound_ms, bound_by)) in timings.items():
            numbers = {"ms": _median_ms(kern), "plain_ms": _median_ms(plain),
                       "library_ms": _median_ms(lib),
                       "library_device_ms": _device_ms_per_call(lib),
                       "bound_ms": bound_ms, "bound_by": bound_by}
            rows[name]["by_batch"][B] = numbers
            print(f"timing {name} at {(B, T, F, H)} float32 (median of 200, "
                  f"CUDA events): kernel {numbers['ms']:.6f} ms, plain "
                  f"{numbers['plain_ms']:.6f} ms, torch.nn.LSTM "
                  f"{numbers['library_ms']:.6f} ms (device "
                  f"{numbers['library_device_ms']} ms a call, all its "
                  f"kernels, profiler mean of 100), bound {bound_ms:.6f} ms "
                  f"({bound_by})", flush=True)
    for row in rows.values():  # the row's own numbers: the speed fit's shape
        row.update(row["by_batch"][TRAIN_SHAPES[0][0]])
    return rows


def _cell_case(B, F, H, dtypes, seed):
    """Inputs of kernel #5 on the card: x, h, c normal and the weights
    normal times 0.2 (the reference's sweep) or the fan-in's inverse square
    root where that is smaller, in ``dtypes`` (x, h, c, weights)."""
    import torch

    rng = np.random.default_rng(seed)
    scale = min(0.2, (F + H) ** -0.5)
    arrays = (rng.standard_normal((B, F)), rng.standard_normal((B, H)),
              rng.standard_normal((B, H)),
              rng.standard_normal((F, 4 * H)) * scale,
              rng.standard_normal((H, 4 * H)) * scale,
              rng.standard_normal((4 * H,)) * scale)
    kinds = (*dtypes[:3], dtypes[3], dtypes[3], dtypes[3])
    return [torch.tensor(a, dtype=getattr(torch, d), device="cuda")
            for a, d in zip(arrays, kinds)]


def _within(got, want, atol) -> bool:
    """float32 outputs within ``atol``; bf16 ones within one bf16 step of
    the value (2^-7 |want|) more: both sides compute in float32 and round
    once, so they may straddle a rounding boundary."""
    import torch

    step = 2.0**-7 * want.float().abs() if want.dtype == torch.bfloat16 else 0
    return bool(((got.float() - want.float()).abs() <= atol + step).all())


def _cell_bound(B, F, H):
    """Bound of one float32 step at (B, F, H): x, h, c and the weights read
    once, h' and c' written once; the two products, 2 B (F+H) 4H."""
    nbytes = 4 * (B * F + 2 * B * H + (F + H) * 4 * H + 4 * H + 2 * B * H)
    return _bound(nbytes, 2 * B * (F + H) * 4 * H)


def _tiling_text(B, F, H, rows=None) -> str:
    """Kernel #5's tiling at (B, F, H), as phase 3 prints it."""
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel

    t = lstm_kernel.cell_tiling(B, F, H, rows)
    return (f"{t.rows} rows x {t.units} units a block, {t.threads} threads, "
            f"grid {t.grid[0]} x {t.grid[1]}")


def cell_kernel_phase() -> dict:
    """Kernel #5 against its plain version at every case of CELL_CASES, each
    run twice, bit for bit, and at B = 0 (no launch); each case's tiling
    printed.  Then timed at the serving step (250, 5, 40) float32: CUDA
    events, the plain version, and ``torch.lstm_cell``, the one PyTorch call
    that computes the same function (held to the kernel first); device
    times in turns, kernel, library, library, kernel; the kernel's device
    time at each of CELL_ROWS_TIMED rows a block; and kernel and library at
    CELL_WIDE.  Returns the numbers of its row."""
    import torch

    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.lstm_cell import ref

    cell = lstm_kernel.lstm_cell
    max_err = 0.0
    for i, (B, F, H, dtypes) in enumerate(CELL_CASES):
        args = _cell_case(B, F, H, dtypes, seed=1000 + i)
        runs = [cell(*args) for _ in range(2)]
        want = ref.lstm_cell_ref(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        errs = [float((g.float() - w.float()).abs().max())
                for g, w in zip(runs[0], want)]
        ok = same and all(g.dtype == w.dtype and _within(g, w, CELL_ATOL)
                          for g, w in zip(runs[0], want))
        max_err = max([max_err, *(e for e, w in zip(errs, want)
                                  if w.dtype == torch.float32)])
        print(f"kernel lstm_cell B={B} F={F} H={H} x, h, c, weights "
              f"{'/'.join(dtypes)} ({_tiling_text(B, F, H)}): max|dh'|="
              f"{errs[0]:.3g} max|dc'|={errs[1]:.3g} (float32 <= {CELL_ATOL},"
              f" bf16 one step); 2 runs "
              f"{'bit-identical' if same else 'DIFFER'} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"lstm_cell disagrees with its plain "
                                 f"version or itself at B={B} F={F} H={H} "
                                 f"{dtypes}: {errs}, rerun identical {same}")
    launches = cell.launches
    h, c = cell(*_cell_case(0, 5, 40, F32, seed=999))
    if cell.launches != launches or h.shape != (0, 40) or c.shape != (0, 40):
        raise AssertionError("lstm_cell at B = 0 launched or gave rows")
    print("kernel lstm_cell B=0: no launch, empty state ok")

    B, F, H = CELL_MAIN
    x, h, c, wx, wh, b = args = _cell_case(B, F, H, F32, seed=1100)
    w_ih, w_hh, zeros = wx.t(), wh.t(), torch.zeros_like(b)

    def library():
        return torch.lstm_cell(x, [h, c], w_ih, w_hh, b, zeros)

    lib_err = max(float((k - l).abs().max())
                  for k, l in zip(cell(*args), library()))
    print(f"torch.lstm_cell vs kernel at (B, F, H) = {CELL_MAIN}: "
          f"max|d h', c'|={lib_err:.3g}")
    if lib_err > 1e-4:
        raise AssertionError("torch.lstm_cell does not compute the kernel's "
                             f"function on these weights: {lib_err}")

    def kernel_device_ms(call):
        return _kernel_device_ms(call, [CELL_KERNEL])[CELL_KERNEL]

    def mean(a, b):
        return None if None in (a, b) else (a + b) / 2

    bound_ms, bound_by = _cell_bound(B, F, H)
    # device times in turns: kernel, torch.lstm_cell, torch.lstm_cell, kernel
    turns = [kernel_device_ms(lambda: cell(*args)),
             _device_ms_per_call(library), _device_ms_per_call(library),
             kernel_device_ms(lambda: cell(*args))]
    numbers = {
        "max_abs_err": max_err, "ms": _median_ms(lambda: cell(*args)),
        "device_ms": mean(turns[0], turns[3]),
        "plain_ms": _median_ms(lambda: ref.lstm_cell_ref(*args)),
        "library_ms": _median_ms(library),
        "library_device_ms": mean(turns[1], turns[2]),
        "device_ms_turns": turns,
        "tiling": lstm_kernel.cell_tiling(B, F, H)._asdict(),
        "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"timing lstm_cell at (B, F, H) = {CELL_MAIN} float32 "
          f"({_tiling_text(B, F, H)}; median of 200, CUDA events): kernel "
          f"{numbers['ms']:.6f} ms, plain {numbers['plain_ms']:.6f} ms, "
          f"torch.lstm_cell {numbers['library_ms']:.6f} ms; device time in "
          f"turns kernel, torch.lstm_cell, torch.lstm_cell, kernel {turns} "
          f"ms (the kernel: profiler median of 100; torch.lstm_cell: all its "
          f"kernels, mean of 100): kernel {numbers['device_ms']} ms, "
          f"torch.lstm_cell {numbers['library_device_ms']} ms; bound "
          f"{bound_ms:.6f} ms ({bound_by})", flush=True)
    numbers["device_ms_by_rows"] = {
        rows: kernel_device_ms(lambda: cell(*args, rows=rows))
        for rows in CELL_ROWS_TIMED}
    print(f"timing lstm_cell at {CELL_MAIN} by rows a block (device, "
          f"profiler median of 100): " + ", ".join(
              f"{rows} ({_tiling_text(B, F, H, rows)}) {ms} ms"
              for rows, ms in numbers["device_ms_by_rows"].items()),
          flush=True)

    B, F, H = CELL_WIDE
    x, h, c, wx, wh, b = args = _cell_case(B, F, H, F32, seed=1200)
    w_ih, w_hh, zeros = wx.t(), wh.t(), torch.zeros_like(b)
    wide = {"device_ms": kernel_device_ms(lambda: cell(*args)),
            "library_device_ms": _device_ms_per_call(library),
            "bound_ms": _cell_bound(B, F, H)[0]}
    numbers["wide"] = wide
    print(f"timing lstm_cell at (B, F, H) = {CELL_WIDE} float32 "
          f"({_tiling_text(B, F, H)}): device {wide['device_ms']} ms "
          f"(profiler median of 100), torch.lstm_cell "
          f"{wide['library_device_ms']} ms (all its kernels, mean of 100), "
          f"bound {wide['bound_ms']:.6f} ms", flush=True)
    return numbers


def scan_phase(fx: dict) -> dict:
    """The path of kernel #5: ``ops.lstm_sequence_scan``, the per-step
    baseline, on the reference's batch model (the fixture's) and window 1's
    250 examples, (B, T, F, H) = (250, 5, 5, 40), with float32 and with
    bf16 x.  Each call must launch #5 exactly T times and no sequence
    kernel.  Each is held to the plain scan (float32 within CELL_ATOL, bf16
    within one bf16 step), and the float32 one to the fused #1
    (``ops.lstm_sequence``) within the reference's 2e-5
    (tests/test_kernels.py::test_lstm_sequence_fused_agrees_with_scanned_
    cells).  Then the scan is timed beside #1, the plain scan and
    ``torch.nn.LSTM``: T launches against one.  Returns the launch counts
    and the numbers."""
    import torch

    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.lstm_cell import ops, ref

    cell = lstm_kernel.lstm_cell
    lstm_wrappers = (cell, lstm_kernel.lstm_sequence_fused,
                     lstm_kernel.lstm_sequence_fwd_train,
                     lstm_kernel.lstm_sequence_bwd)
    setup = unflatten(fx, "setup")
    lp = unflatten(fx, "batch")["lstm"]
    wx, wh, b = (torch.tensor(lp[k], device="cuda")
                 for k in ("kernel", "recurrent", "bias"))
    x32 = torch.tensor(port_stream(setup).supervised(1)["x"], device="cuda")
    B, T, F = x32.shape
    inputs = {"float32": x32, "bfloat16": x32.bfloat16()}

    _reset_launches(*lstm_wrappers)
    out = {}
    for dtype, x in inputs.items():
        before = cell.launches
        out[dtype] = ops.lstm_sequence_scan(x, wx, wh, b)
        torch.cuda.synchronize()
        if cell.launches - before != T:
            raise AssertionError(f"lstm_sequence_scan {dtype} launched "
                                 f"lstm_cell {cell.launches - before} times, "
                                 f"expected T = {T}")
    launches = {w.__name__: w.launches for w in lstm_wrappers}
    expected = {w.__name__: 0 for w in lstm_wrappers} | {
        cell.__name__: T * len(inputs)}
    print(f"scan path: ops.lstm_sequence_scan at (B, T, F, H) = "
          f"{(B, T, F, wh.shape[0])}, float32 and bf16 x; launches "
          f"{launches}, expected {expected}", flush=True)
    if launches != expected:
        raise AssertionError(f"scan path launches {launches}, expected "
                             f"{expected}")

    errs = {}
    for dtype, x in inputs.items():
        want = ref.lstm_sequence_scan_ref(x, wx, wh, b)
        errs[dtype] = float((out[dtype].float() - want.float()).abs().max())
        if out[dtype].dtype != x.dtype or not _within(out[dtype], want,
                                                      CELL_ATOL):
            raise AssertionError(f"lstm_sequence_scan {dtype} disagrees with "
                                 f"the plain scan: {errs[dtype]}")
    fused = ops.lstm_sequence(x32, wx, wh, b)
    errs["fused"] = float((out["float32"] - fused).abs().max())
    print(f"scan path: against the plain scan max|dh| float32 "
          f"{errs['float32']:.3g} (<= {CELL_ATOL}), bf16 "
          f"{errs['bfloat16']:.3g} (one bf16 step); float32 against the "
          f"fused lstm_sequence {errs['fused']:.3g} (<= 2e-5)", flush=True)
    if errs["fused"] > 2e-5:
        raise AssertionError(f"lstm_sequence_scan disagrees with the fused "
                             f"lstm_sequence: {errs['fused']}")

    lstm = _cudnn_lstm(wx, wh, b)
    calls = {"scan": lambda: ops.lstm_sequence_scan(x32, wx, wh, b),
             "fused": lambda: ops.lstm_sequence(x32, wx, wh, b),
             "plain": lambda: ref.lstm_sequence_scan_ref(x32, wx, wh, b),
             "library": lambda: lstm(x32)}
    numbers = {}
    with torch.inference_mode():
        for name, fn in calls.items():
            numbers[f"{name}_ms"] = _median_ms(fn)
            numbers[f"{name}_device_ms"] = _device_ms_per_call(fn)
    print(f"timing the scan path at {(B, T, F, wh.shape[0])} float32 (median "
          f"of 200, CUDA events; device: every kernel, copy and memset of a "
          f"call, profiler mean of 100): ops.lstm_sequence_scan "
          f"{numbers['scan_ms']:.6f} ms, device {numbers['scan_device_ms']} "
          f"ms ({T} launches of lstm_cell, a copy and two fills); fused "
          f"ops.lstm_sequence {numbers['fused_ms']:.6f} ms, device "
          f"{numbers['fused_device_ms']} ms (one launch); plain scan "
          f"{numbers['plain_ms']:.6f} ms, device "
          f"{numbers['plain_device_ms']} ms; torch.nn.LSTM "
          f"{numbers['library_ms']:.6f} ms, device "
          f"{numbers['library_device_ms']} ms", flush=True)
    return {"launches": launches, "max_abs_err": errs, **numbers}


def _int8_inputs(M, K, N, dtype, seed):
    """x (M,K) in [-1, 1) in ``dtype`` and the int8 (q, scale) of a (K,N)
    fan-in-scaled normal weight, quantized by the port, on the card."""
    import torch

    from repro_torch.serving.quantize import quantize

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    x = torch.tensor(rng.uniform(-1.0, 1.0, (M, K)),
                     dtype=getattr(torch, dtype), device=dev)
    qt = quantize(torch.tensor(rng.normal(size=(K, N)) * K**-0.5,
                               dtype=torch.float32, device=dev))
    return x, qt.q, qt.scale


def _int8_bound(M, K, N):
    """Bound of one int8 matmul: x (float32), q (int8) and scale read once,
    y (float32) written once; the M*K*N multiply-adds and the M*N scale
    multiplies."""
    nbytes = 4 * M * K + K * N + 4 * N + 4 * M * N
    return _bound(nbytes, 2 * M * K * N + M * N)


def int8_kernel_phase() -> dict:
    """Kernel #4 against its plain version at every case (each run twice,
    bit for bit), then timed at the bus path's three shapes (CUDA events
    and the profiler's device time) beside the plain version and the
    library yardstick ``(x @ q.float()) * scale`` (cuBLAS and two
    elementwise launches: no single PyTorch call computes the function),
    its device time every kernel of the call.  Returns the numbers of its
    row, at the recurrent step's shape ``INT8_MAIN``."""
    import torch

    from repro_torch.kernels.int8_matmul import kernel as int8_kernel
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

    max_err = 0.0
    for i, (M, K, N, dtype) in enumerate(INT8_CASES):
        x, q, scale = _int8_inputs(M, K, N, dtype, seed=400 + i)
        y = int8_kernel.int8_matmul(x, q, scale)
        again = int8_kernel.int8_matmul(x, q, scale)
        y_ref = int8_matmul_ref(x, q, scale)
        torch.cuda.synchronize()
        if not torch.equal(y, again):
            raise AssertionError(f"int8_matmul differs from itself at M={M} "
                                 f"K={K} N={N} {dtype}")
        err = float((y.float() - y_ref.float()).abs().max())
        if dtype == "float32":
            tol = INT8_TOL if K <= 40 else INT8_TOL_DEEP
            ok = bool(((y - y_ref).abs() <= tol + tol * y_ref.abs()).all())
            max_err = max(max_err, err)
            limit = f"atol = rtol = {tol}"
        else:
            # both round the same float32 sum once to bf16
            ok = bool(((y.float() - y_ref.float()).abs()
                       <= 2.0**-7 * y_ref.float().abs() + INT8_TOL).all())
            limit = "<= one bf16 step"
        print(f"kernel int8_matmul M={M} K={K} N={N} {dtype}: max|dy|="
              f"{err:.3g} ({limit}); 2 runs bit-identical "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"int8_matmul disagrees with its plain "
                                 f"version at M={M} K={K} N={N} {dtype}: "
                                 f"{err}")

    by_shape = {}
    for M, K, N in INT8_SHAPES:
        x, q, scale = _int8_inputs(M, K, N, "float32", seed=500)
        bound_ms, bound_by = _int8_bound(M, K, N)
        def kern():
            return int8_kernel.int8_matmul(x, q, scale)

        def library():
            return (x @ q.float()) * scale

        numbers = {
            "ms": _median_ms(kern),
            "plain_ms": _median_ms(lambda: int8_matmul_ref(x, q, scale)),
            "library_ms": _median_ms(library),
            "device_ms": _kernel_device_ms(kern, ["int8_matmul_kernel"])[
                "int8_matmul_kernel"],
            "library_device_ms": _device_ms_per_call(library),
            "bound_ms": bound_ms, "bound_by": bound_by}
        by_shape[f"{M}x{K}x{N}"] = numbers
        print(f"timing int8_matmul at (M, K, N) = {(M, K, N)} float32 "
              f"(median of 200, CUDA events): kernel {numbers['ms']:.6f} ms "
              f"(device {numbers['device_ms']} ms, profiler median of 100), "
              f"plain {numbers['plain_ms']:.6f} ms, (x @ q.float()) * scale "
              f"{numbers['library_ms']:.6f} ms (device "
              f"{numbers['library_device_ms']} ms, every kernel of the call, "
              f"mean of 100), bound {bound_ms:.6f} ms ({bound_by})",
              flush=True)
    return {"max_abs_err": max_err, "by_shape": by_shape,
            **by_shape["{}x{}x{}".format(*INT8_MAIN)]}


def _flash_case(B, Sq, Sk, Hq, Hkv, D, dtype, seed, kind="arange"):
    """q, k, v (standard normal, in ``dtype``) and int32 positions on the
    card.  ``kind``: "arange" (the queries at the last Sq positions),
    "holes" (every 7th slot and batch row 1's first 50 slots unwritten),
    "decode" (each row's query at its own position, the slots after it
    unwritten), "last" (generate's last decode step: every query at Sk-2,
    the last slot unwritten), "masked" (batch row 0's slots all unwritten,
    the first half of the queries before every slot), "decode_dead" (a
    decode step whose batch row 0 has no written slot), "ring" (a ring
    buffer of Sk slots holding positions Sk/3 .. Sk/3 + Sk - 1 at slot
    position % Sk, so kv_pos is not sorted, every 5th slot unwritten; the
    queries at the last Sq positions), "full" ("arange", for a call that
    is not causal), "cross" (cross attention: every query at position 0,
    every slot written), "holes_dead" ("holes", and batch row 0's first
    query at position -1, before every slot)."""
    import torch

    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=dt,
                            device="cuda")
               for shape in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    q_pos = np.tile(np.arange(Sk - Sq, Sk, dtype=np.int32), (B, 1))
    kv_pos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    if kind == "holes":
        kv_pos[:, ::7] = -1
        kv_pos[min(1, B - 1), :50] = -1
    elif kind in ("decode", "last"):
        q_pos = (np.full((B, 1), Sk - 2, np.int32) if kind == "last" else
                 (Sk - 1 - 13 * np.arange(B, dtype=np.int32))[:, None])
        kv_pos[kv_pos > q_pos] = -1
    elif kind == "masked":
        kv_pos[0] = -1
        q_pos = np.tile(np.arange(Sq, dtype=np.int32) - Sq // 2, (B, 1))
    elif kind == "decode_dead":
        q_pos = (Sk - 1 - 13 * np.arange(B, dtype=np.int32))[:, None]
        kv_pos[kv_pos > q_pos] = -1
        kv_pos[0] = -1
    elif kind == "cross":
        q_pos = np.zeros((B, Sq), np.int32)
    elif kind == "holes_dead":
        kv_pos[:, ::7] = -1
        kv_pos[min(1, B - 1), :50] = -1
        q_pos[0, 0] = -1
    elif kind == "ring":
        pos = np.arange(Sk // 3, Sk // 3 + Sk, dtype=np.int32)
        kv_pos[:, pos % Sk] = pos
        kv_pos[:, ::5] = -1
        q_pos = np.tile(pos[Sk - Sq:], (B, 1))
    return (q, k, v, torch.tensor(q_pos, device="cuda"),
            torch.tensor(kv_pos, device="cuda"))


def _flash_bound(q, k, q_pos, kv_pos, causal=True, window=0):
    """Bound of one attention call: q and o moved once, K and V of the
    slots written (kv_pos >= 0) read once, the positions read once; the
    operations of the (query, slot) pairs this call's positions let
    through, 4 D per pair and query head (q.k and p v), at the bf16
    tensor-core rate for bf16 inputs, the float32 rate otherwise."""
    import torch

    from repro_torch.kernels.flash_attention.ref import position_mask

    B, Sq, Hq, D = q.shape
    esize = q.element_size()
    pairs = int(position_mask(q_pos, kv_pos, causal, window).sum())
    live = int((kv_pos >= 0).sum())
    nbytes = (2 * B * Sq * Hq * D + 2 * live * k.shape[2] * D) * esize + 4 * (
        q_pos.numel() + kv_pos.numel())
    peak = (PEAK_BF16_FLOP_PER_S if q.dtype == torch.bfloat16
            else PEAK_F32_FLOP_PER_S)
    return _bound(nbytes, 4 * D * Hq * pairs, peak)


def _sdpa_call(q, k, v, q_pos, kv_pos, causal_arange: bool,
               causal: bool = True):
    """``scaled_dot_product_attention(..., enable_gqa=True)`` on (B,H,S,D)
    copies of the inputs, causal for the prefill and a boolean mask from
    the positions for a decode step, neither for a call that is not causal
    over written slots: the library yardstick timed beside the kernel,
    never used by the port."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import position_mask

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if not causal:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True).transpose(1, 2)
    if causal_arange:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    mask = position_mask(q_pos, kv_pos, True, 0)[:, None]  # (B,1,Sq,Sk)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)


def _flash_checks() -> list:
    """Phase 3's cases of kernel #6: (label, (B, Sq, Sk, Hq, Hkv, D),
    causal, window, positions' kind, dtype, p_dtype)."""
    checks = []
    for B, H, S, D, causal, window in FLASH_SWEEP:
        for dtype in FLASH_TOL:
            checks.append(("sweep", (B, S, S, H, H, D), causal, window,
                           "arange", dtype, None))
    checks += [("gqa", (2, 96, 96, 8, 2, 32), True, 0, "arange", "float32",
                None)]
    for dtype in FLASH_TOL:
        checks += [
            ("prefill", FLASH_PREFILL, True, 0, "holes", dtype, None),
            ("decode", FLASH_DECODE, True, 0, "decode", dtype, None),
            ("mha prefill", FLASH_MHA_PREFILL, True, 0, "holes", dtype, None),
            ("mha decode", FLASH_MHA_DECODE, True, 0, "decode", dtype, None),
            ("window", (2, 200, 200, 16, 2, 120), True, 64, "arange", dtype,
             None),
            ("masked", (2, 8, 64, 4, 2, 32), True, 0, "masked", dtype, None),
            # the dispatch's edges: Sq * G = 64 rows (the split decode) and
            # 65 (the prefill kernels); a decode whose batch row 0 has no
            # written slot; ring buffers (kv_pos not sorted) for both
            ("rows 64", (2, 8, 96, 16, 2, 32), True, 0, "arange", dtype,
             None),
            ("rows 65", (2, 65, 96, 4, 4, 32), True, 0, "holes", dtype, None),
            ("decode dead row", FLASH_DECODE, True, 0, "decode_dead", dtype,
             None),
            ("ring decode", FLASH_DECODE, True, 0, "ring", dtype, None),
            ("ring prefill", (2, 128, 544, 32, 4, 64), True, 256, "ring",
             dtype, None)]
    # kernel A at D = 120 (the box's zero columns) and D = 16 (one step of K)
    checks += [("d120", (2, 130, 130, 16, 2, 120), True, 0, "holes",
                "bfloat16", None),
               ("d16", (2, 100, 100, 8, 2, 16), True, 0, "holes", "bfloat16",
                None)]
    # kernel B at the lane groupings the cases above do not reach (1, 2
    # and 32 lanes a key row, beside 4, 8 and 16), a decode whose rows are
    # not 16-byte multiples (the SIMT kernel), and views that start one
    # element past a 16-byte boundary (copied once for kernels A and B)
    checks += [("decode d8", (2, 1, 300, 16, 2, 8), True, 0, "decode",
                "bfloat16", None),
               ("decode d16", (2, 1, 300, 16, 2, 16), True, 0, "decode",
                "bfloat16", None),
               ("decode d120", (2, 1, 300, 16, 2, 120), True, 0, "decode",
                "float32", None),
               ("decode d128", (2, 1, 300, 16, 2, 128), True, 0, "decode",
                "float32", None),
               ("decode d20", (2, 1, 300, 16, 2, 20), True, 0, "decode",
                "bfloat16", None),
               ("unaligned decode", FLASH_DECODE, True, 0, "decode",
                "bfloat16", None),
               ("unaligned prefill", (2, 128, 128, 8, 2, 64), True, 0,
                "holes", "bfloat16", None)]
    # the new configs' served shapes (their GQA ratios, MHA, D = 120, 128
    # and kimi's 112) in bf16, and kimi's D = 112 in float32 (the SIMT
    # prefill and the split decode); every case of these rerun bit for bit
    for label, (prefill, decode) in FLASH_ZOO_SHAPES.items():
        checks += [(f"zoo {label} prefill", prefill, True, 0, "holes",
                    "bfloat16", None),
                   (f"zoo {label} decode", decode, True, 0, "decode",
                    "bfloat16", None)]
    kimi = FLASH_ZOO_SHAPES["kimi 8:1 d112"]
    checks += [("zoo kimi 8:1 d112 prefill", (2, 130, 130, 64, 8, 112), True,
                0, "holes", "float32", None),
               ("zoo kimi 8:1 d112 decode", kimi[1], True, 0, "decode",
                "float32", None)]
    # phase 18's served shapes: seamless's calls that are not causal and
    # paligemma's D = 256 MQA, in both dtypes; every case rerun bit for bit
    for label, (shape, causal, kind) in FLASH_ENCDEC_VLM.items():
        checks += [(f"zoo {label}", shape, causal, 0, kind, dtype, None)
                   for dtype in FLASH_TOL]
    # attend(p_dtype=bfloat16) on the card, through each kernel
    checks += [("p bf16 prefill", (2, 256, 256, 32, 4, 64), True, 0, "holes",
                "bfloat16", "bfloat16"),
               ("p bf16 decode", FLASH_DECODE, True, 0, "decode", "bfloat16",
                "bfloat16"),
               ("p bf16 f32 prefill", (2, 200, 200, 16, 2, 64), True, 0,
                "holes", "float32", "bfloat16"),
               ("p bf16 f32 decode", (2, 1, 300, 16, 2, 64), True, 0, "decode",
                "float32", "bfloat16")]
    return checks


def _unaligned(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _ptxas_lines(log: str) -> dict:
    """``-Xptxas -v``'s registers, shared memory and spills of each kernel
    entry in an nvcc log, and any performance warning of ptxas (a wgmma
    serialized): {mangled name: "...spill...; Used ..."}."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = []
        elif name and ("spill" in line or "Used" in line
                       or "Performance" in line):
            out[name].append(line.split(" : ")[-1].strip())
    return {n: "; ".join(v) for n, v in out.items()}


def flash_kernel_phase() -> dict:
    """Kernel #6 against its plain version: the reference's sweep shapes
    (``gqa_flash`` against ``attention_ref``), its GQA case, the served
    prefill with unwritten slots and decode steps against the cache (GQA
    for tinyllama, MHA for zamba2's shared block), a sliding window at
    D=120, fully masked rows, the dispatch's edges and ring buffers,
    float32 and bf16 at the reference's tolerances, each through the kernel
    ``kernel_for`` picks; ``attend(p_dtype=bfloat16)`` against the
    reference's scan with the same p_dtype; kernel A's bf16 output also
    within FLASH_TC_TOL; every bf16 output of kernels A and B within a
    bf16 step of its own algorithm's float32 result (``ref.attend_tc_ref``,
    ``ref.flash_decode_split_ref``); kernel A's bf16 output differing from
    ``attend_tc_ref``'s in at most FLASH_TC_SHARE of its elements, and
    equal to the SIMT kernel's in more elements than a single bf16 pass of
    P gives; every case of kernels A and B rerun bit for bit.
    Then, at the served prefill and decode shapes of both (bf16), the new
    kernel and the SIMT kernel timed in turns (SIMT, new, new, SIMT) by
    CUDA events and by the profiler, beside the plain version and SDPA.
    Returns the numbers of its row, at tinyllama's prefill shape."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.models import attention as attention_mod

    # the largest |do| by input dtype, and of the p_dtype=bfloat16 cases
    max_err = {key: 0.0 for key in (*FLASH_TOL, "p_bfloat16")}
    tc_err, cases_by_kernel = 0.0, dict.fromkeys(flash_kernel.KERNELS, 0)
    # the largest reading of the bf16-step gate by kernel, the largest
    # share of kernel A's elements off attend_tc_ref's, and the fewest
    # elements by which kernel A beats its single-pass build at matching
    # the SIMT kernel
    step_max = {"prefill_wgmma": 0.0, "decode_split": 0.0}
    tc_share_max, simt_margin_min = 0.0, None
    for i, (label, shape, causal, window, kind, dtype,
            p_dtype) in enumerate(_flash_checks()):
        q, k, v, q_pos, kv_pos = _flash_case(*shape, dtype, 600 + i, kind)
        if label.startswith("unaligned"):
            q, k, v = (_unaligned(t) for t in (q, k, v))
        B, Sq, Sk, Hq, Hkv, D = shape
        which = flash_kernel.kernel_for(Sq, Hq, Hkv, D, q.dtype)
        cases_by_kernel[which] += 1
        if label == "sweep":  # the reference's test: MHA layout, arange
            def run():
                return flash_ops.gqa_flash(q, k, v, causal=causal,
                                           window=window)
            want = flash_ref.attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=window).transpose(1, 2)
        elif p_dtype:  # the repaired attend(p_dtype=...) on the card
            pdt = getattr(torch, p_dtype)

            def run():
                return attention_mod.attend(q, k, v, q_pos, kv_pos,
                                            causal=causal, window=window,
                                            p_dtype=pdt)
            want = attention_mod._attend_chunked(
                q, k, v, q_pos, kv_pos, causal=causal, window=window,
                chunk=1024, scale=None, p_dtype=pdt)
        else:
            def run():
                return flash_kernel.flash_attention(
                    q, k, v, q_pos, kv_pos, causal=causal, window=window)
            want = flash_ref.attend_full_ref(q, k, v, q_pos, kv_pos,
                                             causal=causal, window=window)
        got = run()
        torch.cuda.synchronize()
        # p in bf16 makes the product a bf16 one, whatever the inputs
        tol = FLASH_TOL["bfloat16" if p_dtype else dtype]
        d = (got.float() - want.float()).abs()
        ok = bool((d <= tol + tol * want.float().abs()).all())
        notes = []
        # rows with no slot to attend give exactly 0
        dead = ~flash_ref.position_mask(q_pos, kv_pos, causal, window).any(-1)
        if bool(dead.any()):
            zero = bool((got[dead] == 0).all())
            ok = ok and zero
            notes.append(f"{int(dead.sum())} masked rows "
                         f"{'exactly 0' if zero else 'NOT 0'}")
        if kind in ("masked", "decode_dead") and not bool(dead.any()):
            ok = False
        if which == "prefill_wgmma" and not p_dtype:
            rel = float((d / (FLASH_TC_TOL + FLASH_TC_TOL
                              * want.float().abs())).max())
            tc_err = max(tc_err, float(d.max()))
            ok = ok and rel <= 1.0
            notes.append(f"within atol = rtol = {FLASH_TC_TOL} at "
                         f"{rel:.3g} of it")
        if which != "simt" and dtype == "bfloat16":
            # one bf16 rounding off the f32 result of the kernel's own
            # algorithm on the same inputs
            alg = (flash_ref.attend_tc_ref if which == "prefill_wgmma"
                   else flash_ref.flash_decode_split_ref)
            want32 = alg(q.float(), k.float(), v.float(), q_pos, kv_pos,
                         causal=causal, window=window,
                         p_dtype=getattr(torch, p_dtype) if p_dtype else None)
            step = float(((got.float() - want32).abs() / (
                FLASH_STEP_RTOL * want32.abs() + FLASH_STEP_ATOL)).max())
            step_max[which] = max(step_max[which], step)
            ok = ok and step <= 1.0
            notes.append(f"within a bf16 step (|d| <= 2^-8 |want| + "
                         f"{FLASH_STEP_ATOL}) of {alg.__name__} at "
                         f"{step:.3g} of it")
        if which == "prefill_wgmma":
            share = float((got != want32.to(torch.bfloat16)).float().mean())
            tc_share_max = max(tc_share_max, share)
            ok = ok and share <= FLASH_TC_SHARE
            notes.append(f"{share:.3%} of elements off attend_tc_ref's "
                         f"(at most {FLASH_TC_SHARE:.0%})")
            if not p_dtype:
                def named(kernel, **kw):
                    return flash_kernel._launch(
                        q, k, v, q_pos, kv_pos, kernel=kernel,
                        causal=causal, window=window, **kw)
                simt = named("simt")
                n_two = int((got == simt).sum())
                n_one = int((named("prefill_wgmma", p_bf16=True)
                             == simt).sum())
                margin = n_two - n_one
                simt_margin_min = (margin if simt_margin_min is None
                                   else min(simt_margin_min, margin))
                ok = ok and margin > 0
                notes.append(f"equal to simt's in {n_two} of {got.numel()} "
                             f"elements, a single bf16 P in {n_one}")
        if which != "simt" or label.startswith("zoo "):
            same = torch.equal(run(), got)
            ok = ok and same
            notes.append(f"rerun {'bit-identical' if same else 'DIFFERS'}")
        key = "p_bfloat16" if p_dtype else dtype
        max_err[key] = max(max_err[key], float(d.max()))
        print(f"kernel flash_attention [{which}] {label} (B, Sq, Sk, Hq, "
              f"Hkv, D) = {shape} causal={causal} window={window} {kind} "
              f"{dtype}{' p ' + p_dtype if p_dtype else ''}: "
              f"max|do|={float(d.max()):.3g} (atol = rtol = {tol}); "
              f"{'; '.join(notes)} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"flash_attention [{which}] disagrees with "
                                 f"its plain version: {label} {shape} "
                                 f"{dtype}")
    print(f"kernel flash_attention: cases by kernel {cases_by_kernel}",
          flush=True)

    by_shape = {}
    for label, shape, kind in FLASH_TIMED:
        q, k, v, q_pos, kv_pos = _flash_case(*shape, "bfloat16", 700, kind)
        new = flash_kernel.kernel_for(shape[1], shape[3], shape[4], shape[5],
                                      q.dtype)
        causal = kind not in ("full", "cross")
        sdpa = _sdpa_call(q, k, v, q_pos, kv_pos, kind == "arange", causal)

        def launch(name):
            return lambda: flash_kernel._launch(q, k, v, q_pos, kv_pos,
                                                kernel=name, causal=causal)
        kern, simt = launch(new)(), launch("simt")()
        lib_err = float((sdpa().float() - kern.float()).abs().max())
        simt_diff = float((simt.float() - kern.float()).abs().max())
        bound_ms, bound_by = _flash_bound(q, k, q_pos, kv_pos, causal)
        turns = [_median_ms(launch(name)) for name in
                 ("simt", new, new, "simt")]
        dev = {name: _kernel_device_ms(launch(name), [FLASH_KERNELS[name]])[
            FLASH_KERNELS[name]] for name in ("simt", new)}
        sdpa_dev = _device_ms_per_call(sdpa)
        numbers = {
            "kernel": new, "ms": (turns[1] + turns[2]) / 2,
            "device_ms": dev[new], "simt_ms": (turns[0] + turns[3]) / 2,
            "simt_device_ms": dev["simt"], "ms_in_turns": turns,
            "plain_ms": _median_ms(lambda: flash_ref.attend_full_ref(
                q, k, v, q_pos, kv_pos, causal=causal), n=50),
            "library_ms": _median_ms(sdpa), "library_device_ms": sdpa_dev,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "sdpa_max_abs_diff": lib_err, "simt_max_abs_diff": simt_diff}
        by_shape[label] = numbers
        print(f"timing flash_attention {label} at (B, Sq, Sk, Hq, Hkv, D) = "
              f"{shape} bfloat16{'' if causal else ' not causal'} (median, "
              f"CUDA events; in turns simt, {new}, {new}, simt: "
              f"{', '.join(f'{t:.6f}' for t in turns)} ms): "
              f"{new} {numbers['ms']:.6f} ms, device {dev[new]} ms; simt "
              f"{numbers['simt_ms']:.6f} ms, device {dev['simt']} ms; plain "
              f"{numbers['plain_ms']:.6f} ms, SDPA (enable_gqa) "
              f"{numbers['library_ms']:.6f} ms, device {sdpa_dev} ms (all "
              f"its kernels), bound {bound_ms:.6f} ms "
              f"({bound_by}); max|do| against SDPA {lib_err:.3g}, against "
              f"simt {simt_diff:.3g}", flush=True)
    return {"max_abs_err": max_err["float32"],
            "max_abs_err_bf16": max_err["bfloat16"],
            "max_abs_err_p_bf16": max_err["p_bfloat16"],
            "max_abs_err_wgmma_bf16": tc_err,
            "bf16_step_max": step_max, "wgmma_tc_share_max": tc_share_max,
            "wgmma_simt_margin_min": simt_margin_min,
            "cases_by_kernel": cases_by_kernel, "by_shape": by_shape,
            **by_shape["prefill"]}


def _wkv_case(B, T, H, N, seed, state=False, decay=None, dw=None):
    """Inputs of kernel #7 on the card, float32, drawn as the reference's
    test draws them: r, k, v 0.5 normal, w = sigmoid(normal) * 0.5 + 0.45
    (or uniform on ``decay`` = (low, high), or the model's own
    w = exp(-exp(dw)) with dw uniform on ``dw`` = (low, high)), u (H,N)
    0.1 normal; state0 normal when ``state``, else None."""
    import torch

    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)) * 0.5 for _ in range(3))
    if dw is not None:
        w = np.exp(-np.exp(rng.uniform(*dw, (B, T, H, N))))
    elif decay is not None:
        w = rng.uniform(*decay, (B, T, H, N))
    else:
        w = 0.5 / (1 + np.exp(-rng.standard_normal((B, T, H, N)))) + 0.45
    u = rng.standard_normal((H, N)) * 0.1
    s0 = rng.standard_normal((B, H, N, N)) if state else None
    return [None if a is None else torch.tensor(a, dtype=torch.float32,
                                                device="cuda")
            for a in (r, k, v, w, u, s0)]


def _wkv_bound(B, T, H, N, state_in, chunk=None):
    """Bound of one WKV scan at (B,T,H,N), float32: r, k, v, w read and y
    written once, u read once, the final state written once and the
    initial one read only when ``state_in`` (the model's prefill passes
    none).  Operations, for the step-by-step recurrence (``chunk`` None,
    the decode kernel's form): 5 a state element and step (r_i S_ij
    summed, one FMA; w_i S_ij + k_i v_j, a multiply and an FMA) and 5 a
    (b, t, h, j) for the bonus, factored as y_j += v_j (sum_i r_i u_i k_i),
    at the float32 rate.  For the chunked form in chunks of ``chunk``
    steps (the prefill kernel's): its three products a head and chunk
    (r~ S, A V, k~^T V), three times over (3xTF32) at the TF32 rate, and on
    the CUDA cores at the float32 rate its pairwise term A (a multiply and
    an FMA a pair s < t and i) and decays (r~, k~, D: 4 a step and i)."""
    nbytes = 4 * (5 * B * T * H * N + H * N
                  + (2 if state_in else 1) * B * H * N * N)
    if chunk is None:
        return _bound(nbytes, 5 * B * T * H * N * (N + 1))
    chunks = -(-T // chunk)
    products = 2 * B * H * chunks * (2 * chunk * N * N + chunk * chunk * N)
    pairwise = B * H * chunks * (chunk * (chunk - 1) // 2 * 3 * N
                                 + 4 * chunk * N)
    return _tc_bound(nbytes, 3 * products, pairwise)


def wkv_kernel_phase() -> dict:
    """Kernel #7 against its plain version: the reference's sweep in the
    flat (BH,T,N) layout from a zero state (against ``rwkv6_scan_ref``),
    the model layout, a nonzero state, decays near 0 and near 1, the
    model's own decays exp(-exp(dw)) with dw up to 5 (many exactly 0), head
    sizes that are no power of two or no multiple of 4, T = 1, the
    dispatch's edge (T = 8 and 9), T around the chunk (16 and 17) and
    ragged against it (45), the served prefill and decode step, the state
    updated in place (``out`` is ``state0``), and T = 0 (no launch), at the
    reference's tolerance, each through the kernel ``kernel_for`` picks;
    each model-layout case also against that kernel's own algorithm
    (``ref.wkv_chunked_ref`` in 3xTF32, ``ref.wkv_decode_rows_ref``) run
    on the card; every case run twice, bit for bit.  Then each kernel
    timed at its served shape, the chunked at the prefill and the
    row-split at the decode step (CUDA events and the profiler's device
    time by kernel name) beside the plain version and the bound; no single
    PyTorch call computes the recurrence.  Returns the numbers of its row,
    at the prefill shape."""
    import torch

    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref

    def close(got, want):
        return bool(((got - want).abs() <= WKV_TOL + WKV_TOL * want.abs())
                    .all())

    def algorithm(kind, *args):
        if kind == "chunked":
            return wkv_ref.wkv_chunked_ref(
                *args, chunk=wkv_kernel.CHUNK, cols=wkv_kernel.COLS,
                operand_rounding="tf32x3")
        return wkv_ref.wkv_decode_rows_ref(*args)

    checks = [("sweep", (1, T, BH, N), {}) for BH, T, N in WKV_SWEEP]
    checks += [("model", (2, 40, 3, 16), {}),
               ("state", (3, 77, 5, 32), {"state": True}),
               ("decay~0", (2, 50, 4, 16), {"state": True,
                                            "decay": (1e-6, 1e-3)}),
               ("decay~1", (2, 300, 4, 64), {"state": True,
                                             "decay": (0.999, 1 - 1e-7)}),
               ("dw to 5", (2, 100, 4, 64), {"state": True,
                                             "dw": (-6.0, 5.0)}),
               ("dw to 5 T=1", (2, 1, 4, 64), {"state": True,
                                               "dw": (-6.0, 5.0)}),
               ("N=24", (2, 30, 3, 24), {"state": True}),
               ("N=10", (2, 37, 3, 10), {"state": True}),
               ("T=1 N=10", (2, 1, 3, 10), {"state": True}),
               ("T=1", (3, 1, 5, 32), {"state": True}),
               ("T=8", (2, 8, 3, 64), {"state": True}),
               ("T=9", (2, 9, 3, 64), {"state": True}),
               ("T=16", (2, 16, 3, 64), {"state": True}),
               ("T=17", (2, 17, 3, 64), {"state": True}),
               ("T=45", (2, 45, 3, 64), {"state": True}),
               ("prefill", WKV_PREFILL, {}),
               ("decode", WKV_DECODE, {"state": True})]
    max_err = 0.0
    for i, (label, shape, kw) in enumerate(checks):
        r, k, v, w, u, s0 = _wkv_case(*shape, seed=800 + i, **kw)
        if label == "prefill":  # the model's prefill passes a zero state
            s0 = torch.zeros(shape[0], shape[2], shape[3], shape[3],
                             device="cuda")
        kind = wkv_kernel.kernel_for(shape[1])
        runs = [wkv_ops.wkv(r, k, v, w, u, s0) for _ in range(2)]
        want = wkv_ref.wkv_ref(r, k, v, w, u, s0)
        alg = None
        if label == "sweep":  # the reference's test: the flat (BH,T,N)
            flat = [a[0].transpose(0, 1) for a in (r, k, v, w)]
            y, s = wkv_ref.rwkv6_scan_ref(*flat, u)
            want = (wkv_ref.to_model_layout(y), s[None])
        else:
            alg = algorithm(kind, r, k, v, w, u, s0)
        if label == "decode":  # in place: the state written over state0
            inplace = s0.clone()
            y, s = wkv_ops.wkv(r, k, v, w, u, inplace, out=inplace)
            if s is not inplace:
                raise AssertionError("rwkv6_scan: out is not the state0 "
                                     "given")
            runs.append((y, s))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for run in runs[1:]
                   for a, b in zip(runs[0], run))
        d = max(float((g - e).abs().max()) for g, e in zip(runs[0], want))
        ok = same and all(close(g, e) for g, e in zip(runs[0], want))
        against = ""
        if alg is not None:
            alg_err = max(float((g - e).abs().max())
                          for g, e in zip(runs[0], alg))
            ok = ok and all(close(g, e) for g, e in zip(runs[0], alg))
            against = f", against its algorithm max|d|={alg_err:.3g}"
        max_err = max(max_err, d)
        print(f"kernel rwkv6_scan [{kind}] {label} (B, T, H, N) = {shape}"
              f"{' from a state' if s0 is not None else ''}: max|d|={d:.3g}"
              f"{against} (atol = rtol = {WKV_TOL}); {len(runs)} runs "
              f"{'bit-identical' if same else 'DIFFER'} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"rwkv6_scan disagrees with its plain "
                                 f"version or with itself: {label} {shape}")
    launches = wkv_kernel.rwkv6_scan.launches
    r, k, v, w, u, s0 = _wkv_case(2, 0, 3, 16, seed=899, state=True)
    y, s = wkv_ops.wkv(r, k, v, w, u, s0)
    if (wkv_kernel.rwkv6_scan.launches != launches or y.shape[1] != 0
            or not torch.equal(s, s0)):
        raise AssertionError("rwkv6_scan at T = 0 launched or lost the state")
    print("kernel rwkv6_scan T=0: no launch, the state handed back ok")

    by_shape = {}
    for label, shape, state in (("prefill", WKV_PREFILL, False),
                                ("decode", WKV_DECODE, True)):
        r, k, v, w, u, s0 = _wkv_case(*shape, seed=900, state=state)
        kind = wkv_kernel.kernel_for(shape[1])
        name = WKV_KERNELS[kind]

        def kern():
            return wkv_kernel.rwkv6_scan(r, k, v, w, u, s0)

        bound_ms, bound_by = _wkv_bound(
            *shape, state_in=state,
            chunk=wkv_kernel.CHUNK if kind == "chunked" else None)
        numbers = {
            "kernel": kind, "ms": _median_ms(kern),
            "plain_ms": _median_ms(lambda: wkv_ref.wkv_ref(r, k, v, w, u, s0),
                                   n=10 if label == "prefill" else 50,
                                   warmup=2),
            "device_ms": _kernel_device_ms(kern, [name])[name],
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
        by_shape[label] = numbers
        print(f"timing rwkv6_scan {label} [{kind}, {name}] at (B, T, H, N) = "
              f"{shape} float32 (median, CUDA events): kernel "
              f"{numbers['ms']:.6f} ms (device {numbers['device_ms']} ms, "
              f"profiler median of 100), plain {numbers['plain_ms']:.6f} ms, "
              f"bound {bound_ms:.6f} ms ({bound_by}); no single PyTorch call "
              f"computes it", flush=True)
    return {"max_abs_err": max_err, "by_shape": by_shape,
            **by_shape["prefill"]}


def _ssm_case(B, T, H, P, N, seed, state=False, dt_scale=1.0):
    """Inputs of kernel #8 on the card in the model layout, float32, drawn
    with the reference test's laws: x normal (B,T,H,P), b and c 0.3
    normal (B,T,N), dt softplus(normal) (B,T,H) times ``dt_scale``, a =
    -exp(normal) and d normal (H,); state0 normal when ``state``, else
    None."""
    import torch

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P))
    b, c = (rng.standard_normal((B, T, N)) * 0.3 for _ in range(2))
    raw = rng.standard_normal((B, T, H))
    dt = (np.log1p(np.exp(-np.abs(raw))) + np.maximum(raw, 0)) * dt_scale
    a = -np.exp(rng.standard_normal(H))
    d = rng.standard_normal(H)
    s0 = rng.standard_normal((B, H, P, N)) if state else None
    return [None if v is None else torch.tensor(v, dtype=torch.float32,
                                                device="cuda")
            for v in (x, b, c, dt, a, d, s0)]


def _ssm_bound(B, T, H, P, N, state_in, chunk=None):
    """Bound of one selective scan at (B,T,H,P,N), float32: x read and y
    written once, b, c, dt, a and d read once, the final state written
    once and the initial one read only when ``state_in`` (the model's
    prefill starts from zero).  Operations, for the step-by-step
    recurrence (``chunk`` None, the decode kernel's form): 5 a state
    element and step (decay h + u b, a multiply and an FMA; h c summed, an
    FMA), 3 a (b, t, h, p) (u = dt x; d x added, an FMA) and 2 a (b, t, h)
    (dt a and its exp), at the float32 rate.  For the chunked form in
    chunks of ``chunk`` steps (the prefill kernel's): its products, C B^T
    once a batch row and chunk, M x, (e C) h^T and x^T W B a head and
    chunk, three times over (3xTF32) at the TF32 rate."""
    nbytes = 4 * (2 * B * T * H * P + 2 * B * T * N + B * T * H + 2 * H
                  + (2 if state_in else 1) * B * H * P * N)
    if chunk is None:
        flops = 5 * B * T * H * P * N + 3 * B * T * H * P + 2 * B * T * H
        return _bound(nbytes, flops)
    chunks = -(-T // chunk)
    products = 2 * B * chunks * (chunk * chunk * N + H * (
        chunk * chunk * P + 2 * chunk * N * P))
    return _bound(nbytes, 3 * products, PEAK_TF32_FLOP_PER_S)


def ssm_kernel_phase() -> dict:
    """Kernel #8 against its plain version: the reference's sweep in the
    flat (BH,T,P) layout from a zero state (each row its own launch, b and
    c its own, against ``ssm_scan_ref``), the model layout, a nonzero
    state, steps near 0 and large (decays near 1 and near 0), dims that
    are no power of two or no multiple of 4, T = 1, the dispatch's edge
    (T = 8 and 9), T ragged against the chunk (63, 65) and whole chunks
    (64, 128), the served prefill at B = 4 and 1 and the decode step, the
    state updated in place (``out`` is ``state0``), and T = 0 (no launch),
    at the reference's tolerance, each through the kernel ``kernel_for``
    picks; each model-layout case also against that kernel's own
    algorithm (``ref.ssd_chunked_ref`` in 3xTF32, ``ref.
    ssm_decode_rows_ref``) run on the card; every case run twice, bit for
    bit.  Then each kernel timed at its served shape, the chunked at the
    prefill and the row-split at the decode step (CUDA events and the
    profiler's device time by kernel name) beside the plain version and
    the bound; no single PyTorch call computes the recurrence.  Returns
    the numbers of its row, at the prefill shape."""
    import torch

    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan import ref as ssm_ref

    def close(got, want):
        return bool(((got - want).abs() <= SSM_TOL + SSM_TOL * want.abs())
                    .all())

    def algorithm(kind, *args):
        if kind == "chunked":
            return ssm_ref.ssd_chunked_ref(*args, chunk=ssm_kernel.CHUNK,
                                           operand_rounding="tf32x3")
        return ssm_ref.ssm_decode_rows_ref(*args)

    max_err = 0.0
    for i, (BH, T, P, N) in enumerate(SSM_SWEEP):
        x, b, c, dt, *_ = _ssm_case(BH, T, 1, P, N, seed=1000 + i)
        rng = np.random.default_rng(1050 + i)  # a and d of each row
        a, d = (torch.tensor(v, dtype=torch.float32, device="cuda") for v in
                (-np.exp(rng.standard_normal(BH)), rng.standard_normal(BH)))
        runs = [[ssm_kernel.ssm_scan(x[r:r + 1], b[r:r + 1], c[r:r + 1],
                                     dt[r:r + 1], a[r:r + 1], d[r:r + 1])
                 for r in range(BH)] for _ in range(2)]
        got = [(torch.cat([y[:, :, 0] for y, _ in run]),
                torch.cat([s[:, 0] for _, s in run])) for run in runs]
        want = ssm_ref.ssm_scan_ref(x[:, :, 0], b, c, dt[..., 0], a, d)
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(*got))
        err = max(float((g - e).abs().max()) for g, e in zip(got[0], want))
        ok = same and all(close(g, e) for g, e in zip(got[0], want))
        max_err = max(max_err, err)
        print(f"kernel ssm_scan [{ssm_kernel.kernel_for(T)}] sweep (BH, T, P, "
              f"N) = {(BH, T, P, N)} from a zero state: max|d|={err:.3g} "
              f"(atol = rtol = {SSM_TOL}); 2 runs "
              f"{'bit-identical' if same else 'DIFFER'} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"ssm_scan disagrees with its plain version "
                                 f"or with itself: sweep {(BH, T, P, N)}")

    checks = [("model", (2, 40, 3, 16, 8), {}),
              ("state", (3, 77, 5, 32, 16), {"state": True}),
              ("dt~0", (2, 50, 4, 16, 16), {"state": True, "dt_scale": 1e-6}),
              ("dt large", (2, 300, 4, 64, 64), {"state": True,
                                                 "dt_scale": 40.0}),
              ("P=24 N=24", (2, 30, 3, 24, 24), {"state": True}),
              ("P=12 N=10", (2, 70, 3, 12, 10), {"state": True}),
              ("T=1 N=10", (2, 1, 3, 12, 10), {"state": True}),
              ("T=1", (3, 1, 5, 32, 16), {"state": True}),
              ("T=8", (2, 8, 3, 64, 64), {"state": True}),
              ("T=9", (2, 9, 3, 64, 64), {"state": True}),
              ("T=63", (2, 63, 3, 64, 64), {"state": True}),
              ("T=64", (2, 64, 3, 64, 64), {"state": True}),
              ("T=65", (2, 65, 3, 64, 64), {"state": True}),
              ("T=128", (2, 128, 3, 64, 64), {"state": True}),
              ("prefill", SSM_PREFILL, {}),
              ("prefill B=1", (1, *SSM_PREFILL[1:]), {}),
              ("decode", SSM_DECODE, {"state": True})]
    for i, (label, shape, kw) in enumerate(checks):
        x, b, c, dt, a, d, s0 = _ssm_case(*shape, seed=1100 + i, **kw)
        kind = ssm_kernel.kernel_for(shape[1])
        runs = [ssm_ops.selective_scan(x, b, c, dt, a, d, s0)
                for _ in range(2)]
        want = ssm_ref.selective_scan_ref(x, b, c, dt, a, d, s0)
        alg = algorithm(kind, x, b, c, dt, a, d, s0)
        if label == "decode":  # in place: the state written over state0
            inplace = s0.clone()
            y, s = ssm_ops.selective_scan(x, b, c, dt, a, d, inplace,
                                          out=inplace)
            if s is not inplace:
                raise AssertionError("ssm_scan: out is not the state0 given")
            runs.append((y, s))
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for run in runs[1:]
                   for u, v in zip(runs[0], run))
        err = max(float((g - e).abs().max()) for g, e in zip(runs[0], want))
        alg_err = max(float((g - e).abs().max())
                      for g, e in zip(runs[0], alg))
        ok = same and all(close(g, e) for g, e in zip(runs[0], want)) and all(
            close(g, e) for g, e in zip(runs[0], alg))
        max_err = max(max_err, err)
        print(f"kernel ssm_scan [{kind}] {label} (B, T, H, P, N) = {shape}"
              f"{' from a state' if s0 is not None else ''}: max|d|={err:.3g}"
              f", against its algorithm max|d|={alg_err:.3g} (atol = rtol = "
              f"{SSM_TOL}); {len(runs)} runs "
              f"{'bit-identical' if same else 'DIFFER'} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"ssm_scan disagrees with its plain version "
                                 f"or with itself: {label} {shape}")
    launches = ssm_kernel.ssm_scan.launches
    x, b, c, dt, a, d, s0 = _ssm_case(2, 0, 3, 16, 8, seed=1199, state=True)
    y, s = ssm_ops.selective_scan(x, b, c, dt, a, d, s0)
    if (ssm_kernel.ssm_scan.launches != launches or y.shape[1] != 0
            or not torch.equal(s, s0)):
        raise AssertionError("ssm_scan at T = 0 launched or lost the state")
    print("kernel ssm_scan T=0: no launch, the state handed back ok")

    by_shape = {}
    for label, shape, state in (("prefill", SSM_PREFILL, False),
                                ("decode", SSM_DECODE, True)):
        x, b, c, dt, a, d, s0 = _ssm_case(*shape, seed=1200, state=state)
        kind = ssm_kernel.kernel_for(shape[1])
        name = SSM_KERNELS[kind]

        def kern():
            return ssm_kernel.ssm_scan(x, b, c, dt, a, d, s0)

        bound_ms, bound_by = _ssm_bound(
            *shape, state_in=state,
            chunk=ssm_kernel.CHUNK if kind == "chunked" else None)
        numbers = {
            "kernel": kind, "ms": _median_ms(kern),
            "plain_ms": _median_ms(
                lambda: ssm_ref.selective_scan_ref(x, b, c, dt, a, d, s0),
                n=10 if label == "prefill" else 50, warmup=2),
            "device_ms": _kernel_device_ms(kern, [name])[name],
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
        by_shape[label] = numbers
        print(f"timing ssm_scan {label} [{kind}, {name}] at (B, T, H, P, N) = "
              f"{shape} float32 (median, CUDA events): kernel "
              f"{numbers['ms']:.6f} ms (device {numbers['device_ms']} ms, "
              f"profiler median of 100), plain {numbers['plain_ms']:.6f} ms, "
              f"bound {bound_ms:.6f} ms ({bound_by}); no single PyTorch call "
              f"computes it", flush=True)
    return {"max_abs_err": max_err, "by_shape": by_shape,
            **by_shape["prefill"]}


def _stacked(make, S, seed):
    """``make(seed + s)`` for each of S streams, each output stacked along a
    new leading stream axis."""
    import torch

    parts = [make(seed + s) for s in range(S)]
    return tuple(torch.stack(p).contiguous() for p in zip(*parts))


def _fleet_lstm_inputs(S, B, T, F, H, dtype, seed):
    """A fleet of S LSTMs on the card: x (S,B,T,F), stacked weights, and
    random cotangents dh (S,B,H) of the final state."""
    import torch

    def one(k):
        x, wx, wh, b = _kernel_inputs(B, T, F, H, dtype, k)
        g = torch.Generator(device="cuda").manual_seed(k)
        return x, wx, wh, b, torch.randn((B, H), generator=g, device="cuda")

    return _stacked(one, S, seed)


def _fleet_int8_inputs(S, M, K, N, dtype, seed):
    return _stacked(lambda k: _int8_inputs(M, K, N, dtype, k), S, seed)


def fleet_kernel_phase() -> dict:
    """The stream axis of #1, #2 + #3 and #4: each held to its plain
    version (the single-stream plain version on every stream) at S in
    ``FLEET_KERNEL_S``, rerun bit for bit, every stream of a fleet launch
    equal bit for bit to a single-stream launch of that stream, and S = 0
    and B = 0 launching nothing.  Then each timed at the fleet path's shapes
    at S in ``FLEET_STREAMS`` (and S = 1): CUDA events and the profiler's
    device time, beside its bound (S times one stream's), the plain
    version, and for #4 the yardstick ``torch.bmm(x, q.float()) * scale``
    (three calls: no single PyTorch call computes it); #1-#3 have no
    library call that runs a fleet of LSTMs with per-stream weights, so S
    calls of ``torch.nn.LSTM`` are timed for context only.  Returns
    {kernel name: its fleet numbers}."""
    import torch

    from repro_torch.kernels.int8_matmul import kernel as int8_kernel
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.lstm_cell import ref

    fused = lstm_kernel.lstm_sequence_fused
    fwd_train = lstm_kernel.lstm_sequence_fwd_train
    bwd = lstm_kernel.lstm_sequence_bwd
    int8 = int8_kernel.int8_matmul

    def within(got, want, atol, rtol):
        return bool(((got - want).abs() <= atol + rtol * want.abs()).all())

    errs = {"lstm_sequence_fused": 0.0, "lstm_sequence_fwd_train": 0.0,
            "lstm_sequence_bwd": 0.0, "int8_matmul": 0.0}
    for S in FLEET_KERNEL_S:
        for i, (B, T, F, H, dtype) in enumerate(FLEET_LSTM_CASES):
            x, wx, wh, b, dh = _fleet_lstm_inputs(S, B, T, F, H, dtype,
                                                  700 + 10 * i)
            dc = torch.zeros_like(dh)
            with torch.inference_mode():
                h, c = fused(x, wx, wh, b)
                again = fused(x, wx, wh, b)
                h_ref, c_ref = ref.lstm_sequence_ref(x, wx, wh, b,
                                                     return_state=True)
                ones = [fused(x[s], wx[s], wh[s], b[s]) for s in range(S)]
                res = fwd_train(x, wx, wh, b)
                res_again = fwd_train(x, wx, wh, b)
                res_ref = ref.lstm_sequence_fwd_train_ref(x, wx, wh, b)
                res_ones = [fwd_train(x[s], wx[s], wh[s], b[s])
                            for s in range(S)]
                g = bwd(x, *res, wx, wh, dh, dc)
                g_again = bwd(x, *res, wx, wh, dh, dc)
                g_ref = ref.lstm_sequence_bwd_ref(x, *res, wx, wh, dh, dc)
                g_ones = [bwd(x[s], *(r[s] for r in res), wx[s], wh[s],
                              dh[s], dc[s]) for s in range(S)]
            torch.cuda.synchronize()
            same = (torch.equal(h, again[0]) and torch.equal(c, again[1])
                    and all(torch.equal(u, v) for u, v in zip(res, res_again))
                    and all(torch.equal(u, v) for u, v in zip(g, g_again)))
            per_stream = all(
                torch.equal(h[s], ones[s][0]) and torch.equal(c[s], ones[s][1])
                and all(torch.equal(u[s], v)
                        for u, v in zip(res, res_ones[s]))
                and all(torch.equal(u[s], v) for u, v in zip(g, g_ones[s]))
                for s in range(S))
            fwd_err = max(float((u.float() - v.float()).abs().max())
                          for u, v in zip((h, c, *res),
                                          (h_ref, c_ref, *res_ref)))
            bwd_err = max(float((u - v).abs().max())
                          for u, v in zip(g, g_ref))
            if dtype == "float32":
                ok = (fwd_err <= KERNEL_ATOL and all(
                    within(u, v, BWD_ATOL, BWD_RTOL) for u, v in zip(g, g_ref)))
                errs["lstm_sequence_fused"] = max(
                    errs["lstm_sequence_fused"],
                    float((h - h_ref).abs().max()),
                    float((c - c_ref).abs().max()))
                errs["lstm_sequence_fwd_train"] = max(
                    errs["lstm_sequence_fwd_train"],
                    *(float((u - v).abs().max())
                      for u, v in zip(res, res_ref)))
                errs["lstm_sequence_bwd"] = max(errs["lstm_sequence_bwd"],
                                                bwd_err)
            else:
                ok = (_within(h, h_ref, KERNEL_ATOL)
                      and _within(c, c_ref, KERNEL_ATOL)
                      and max(float((u - v).abs().max())
                              for u, v in zip(res, res_ref)) <= KERNEL_ATOL
                      and _within(g[0].to(x.dtype), g_ref[0].to(x.dtype),
                                  KERNEL_ATOL)
                      and all(within(u, v, BWD_ATOL, BWD_RTOL)
                              for u, v in zip(g[1:], g_ref[1:])))
            ok = ok and same and per_stream
            print(f"fleet kernels #1, #2, #3 S={S} B={B} T={T} F={F} H={H} "
                  f"{dtype}: forward max|d|={fwd_err:.3g}, backward "
                  f"max|d|={bwd_err:.3g}; reruns "
                  f"{'bit-identical' if same else 'DIFFER'}; every stream "
                  f"{'equal to' if per_stream else 'DIFFERS from'} its "
                  f"single-stream launch {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise AssertionError(
                    f"the LSTM kernels' stream axis at S={S} B={B} T={T} "
                    f"F={F} H={H} {dtype}: forward {fwd_err}, backward "
                    f"{bwd_err}, reruns {same}, per stream {per_stream}")
        for i, (M, K, N, dtype) in enumerate(FLEET_INT8_CASES):
            x, q, scale = _fleet_int8_inputs(S, M, K, N, dtype, 800 + 10 * i)
            y, again = int8(x, q, scale), int8(x, q, scale)
            y_ref = int8_matmul_ref(x, q, scale)
            ones = [int8(x[s], q[s], scale[s]) for s in range(S)]
            torch.cuda.synchronize()
            same = torch.equal(y, again)
            per_stream = all(torch.equal(y[s], ones[s]) for s in range(S))
            err = float((y.float() - y_ref.float()).abs().max())
            if dtype == "float32":
                tol = INT8_TOL if K <= 40 else INT8_TOL_DEEP
                ok = within(y, y_ref, tol, tol)
                errs["int8_matmul"] = max(errs["int8_matmul"], err)
            else:
                ok = _within(y, y_ref, KERNEL_ATOL)
            ok = ok and same and per_stream
            print(f"fleet kernel #4 S={S} M={M} K={K} N={N} {dtype}: "
                  f"max|dy|={err:.3g}; rerun "
                  f"{'bit-identical' if same else 'DIFFERS'}; every stream "
                  f"{'equal to' if per_stream else 'DIFFERS from'} its "
                  f"single-stream launch {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise AssertionError(
                    f"int8_matmul's stream axis at S={S} M={M} K={K} N={N} "
                    f"{dtype}: {err}, rerun {same}, per stream {per_stream}")

    # nothing launched, nothing counted, at S = 0 and at B = 0
    _reset_launches(fused, fwd_train, bwd, int8)
    for S, B in ((0, 64), (3, 0)):
        x, wx, wh, b, dh = _fleet_lstm_inputs(max(S, 1), max(B, 1), 5, 5, 40,
                                              "float32", 900)
        x, wx, wh, b, dh = x[:S, :B], wx[:S], wh[:S], b[:S], dh[:S, :B]
        x, dh = x.contiguous(), dh.contiguous()
        h, _ = fused(x, wx, wh, b)
        res = fwd_train(x, wx, wh, b)
        grads = bwd(x, *res, wx, wh, dh, torch.zeros_like(dh))
        xq, q, scale = _fleet_int8_inputs(max(S, 1), max(B, 1), 40, 160,
                                          "float32", 901)
        y = int8(xq[:S, :B].contiguous(), q[:S], scale[:S])
        shapes_ok = (tuple(h.shape) == (S, B, 40)
                     and tuple(grads[1].shape) == (S, 5, 160)
                     and not bool(grads[1].abs().sum())
                     and tuple(y.shape) == (S, B, 160))
        if not shapes_ok:
            raise AssertionError(f"S={S}, B={B}: outputs {tuple(h.shape)}, "
                                 f"{tuple(grads[1].shape)}, {tuple(y.shape)}")
    counted = {w.__name__: w.launches for w in (fused, fwd_train, bwd, int8)}
    print(f"fleet kernels at S = 0 and B = 0: launches {counted} (none)",
          flush=True)
    if any(counted.values()):
        raise AssertionError(f"an empty fleet launched: {counted}")

    # timed at the fleet path's shapes
    out = {name: {"max_abs_err": err, "by_streams": {}}
           for name, err in errs.items()}
    B_pred, B_fit, T, F, H = FLEET_PREDICT_ROWS, FLEET_BATCH, 5, 5, 40
    for S in (1, *FLEET_STREAMS):
        x, wx, wh, b, _ = _fleet_lstm_inputs(S, B_pred, T, F, H, "float32",
                                             1000)
        xf, wxf, whf, bf, dh = _fleet_lstm_inputs(S, B_fit, T, F, H,
                                                  "float32", 1100)
        dc = torch.zeros_like(dh)
        res = fwd_train(xf, wxf, whf, bf)
        lstms = [_cudnn_lstm(wx[s], wh[s], b[s]) for s in range(S)]
        cases = {
            "lstm_sequence_fused": (
                lambda: fused(x, wx, wh, b),
                lambda: ref.lstm_sequence_ref(x, wx, wh, b),
                [SERVE_FWD_KERNEL], _lstm_bound(B_pred, T, F, H),
                (B_pred, T, F, H)),
            "lstm_sequence_fwd_train": (
                lambda: fwd_train(xf, wxf, whf, bf),
                lambda: ref.lstm_sequence_fwd_train_ref(xf, wxf, whf, bf),
                [TRAIN_FWD_KERNEL], _fwd_train_bound(B_fit, T, F, H),
                (B_fit, T, F, H)),
            "lstm_sequence_bwd": (
                lambda: bwd(xf, *res, wxf, whf, dh, dc),
                lambda: ref.lstm_sequence_bwd_ref(xf, *res, wxf, whf, dh, dc),
                BWD_KERNELS, _bwd_bound(B_fit, T, F, H), (B_fit, T, F, H)),
        }
        with torch.inference_mode():
            lstm_ms = _median_ms(lambda: [lstm(x[s]) for s, lstm
                                          in enumerate(lstms)], n=50)
            for name, (kern, plain, names, (one_ms, by), shape) in \
                    cases.items():
                dev = _kernel_device_ms(kern, names, calls=50)
                numbers = {
                    "shape": (S, *shape), "ms": _median_ms(kern, n=100),
                    "device_ms": (None if None in dev.values()
                                  else sum(dev.values())),
                    "plain_ms": _median_ms(plain, n=5, warmup=1),
                    "bound_ms": S * one_ms, "bound_by": by,
                    "library_ms": None,
                    "nn_lstm_x_S_ms": (lstm_ms if name == "lstm_sequence_fused"
                                       else None)}
                out[name]["by_streams"][S] = numbers
                print(f"timing fleet {name} at S={S} {(S, *shape)} float32: "
                      f"kernel {numbers['ms']:.6f} ms (CUDA events, median of "
                      f"100), device {numbers['device_ms']} ms (profiler, "
                      f"median of 50), plain {numbers['plain_ms']:.6f} ms, "
                      f"bound {numbers['bound_ms']:.6f} ms ({by}); no library "
                      f"call computes a fleet of LSTMs"
                      + (f"; {S} calls of torch.nn.LSTM (context only) "
                         f"{lstm_ms:.6f} ms" if name == "lstm_sequence_fused"
                         else ""), flush=True)
        for M, K, N in FLEET_INT8_SHAPES:
            xq, q, scale = _fleet_int8_inputs(S, M, K, N, "float32", 1200)
            one_ms, by = _int8_bound(M, K, N)

            def library():
                return torch.bmm(xq, q.float()) * scale[:, None, :]

            numbers = {
                "shape": (S, M, K, N),
                "ms": _median_ms(lambda: int8(xq, q, scale), n=100),
                "device_ms": _kernel_device_ms(
                    lambda: int8(xq, q, scale), ["int8_matmul_kernel"],
                    calls=50)["int8_matmul_kernel"],
                "plain_ms": _median_ms(lambda: int8_matmul_ref(xq, q, scale),
                                       n=5, warmup=1),
                "library_ms": _median_ms(library, n=100),
                "library_device_ms": _device_ms_per_call(library, calls=50),
                "bound_ms": S * one_ms, "bound_by": by}
            out["int8_matmul"]["by_streams"].setdefault(S, {})[
                f"{M}x{K}x{N}"] = numbers
            print(f"timing fleet int8_matmul at S={S} {(S, M, K, N)} "
                  f"float32: kernel {numbers['ms']:.6f} ms (device "
                  f"{numbers['device_ms']} ms), plain "
                  f"{numbers['plain_ms']:.6f} ms, bmm(x, q.float()) * scale "
                  f"{numbers['library_ms']:.6f} ms (device "
                  f"{numbers['library_device_ms']} ms, its three calls), "
                  f"bound {numbers['bound_ms']:.6f} ms ({by})", flush=True)
    return out


def _device_intervals(prof):
    """(name, start_us, end_us) of every device-side event of a profile:
    kernels, copies and memsets."""
    import torch

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _profile(fn, cpu: bool = True):
    """Device intervals of one profiled call of ``fn``, which ends synced;
    without ``cpu``, the host's operators are not traced (a call of many
    thousand operators)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        fn()
    return _device_intervals(prof)


def _profile_calls(fn, calls):
    """Device intervals of ``calls`` profiled calls of ``fn`` after
    warm-up."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()

    def many():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    return _profile(many)


def _device_ms_per_call(fn, calls=100):
    """Device time of one call of ``fn``, every kernel, copy and memset it
    runs: their sum over ``calls`` profiled calls after warm-up, over
    ``calls``; None where the profiler saw none."""
    spans = _profile_calls(fn, calls)
    return sum(e - s for _, s, e in spans) / calls / 1e3 if spans else None


def _kernel_device_ms(fn, names, calls=100):
    """Median device time per call of each kernel in ``names`` (a substring
    of its name), over ``calls`` profiled calls of ``fn`` after warm-up;
    None where the profiler saw none."""
    spans = _profile_calls(fn, calls)
    out = {}
    for n in names:
        kern = [e - s for name, s, e in spans if n in name]
        out[n] = statistics.median(kern) / 1e3 if kern else None
    return out


def _busy(fn, label: str, calls: int = 1, cpu: bool = True) -> dict:
    """Wall of one unprofiled warm call of ``fn`` (which ends synced), and
    the device's busy time, idle share and top kernels by name over a
    profiled call (``cpu``: the host's operators traced too).  With
    ``calls`` > 1, each a mean over that many calls after warm-up: a call
    of a few device events can end before the profiler has collected
    them."""
    if calls > 1:
        for _ in range(10):
            fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall_s = (time.perf_counter() - t0) / calls
    spans = _profile(fn, cpu) if calls == 1 else _profile_calls(fn, calls)
    if not spans:
        print(f"profile {label}: the profiler saw no device events; device "
              "time not measured")
        return {"wall_s": wall_s, "busy_ms": None, "idle_share": None}
    busy_us, covered = 0.0, float("-inf")
    for s, e in sorted((s, e) for _, s, e in spans):  # union of intervals
        busy_us += max(0.0, e - max(s, covered))
        covered = max(covered, e)
    busy_us /= calls
    by_name: dict = {}
    for name, s, e in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / calls
    idle = 1 - busy_us / 1e6 / wall_s
    per = f" a call (means over {calls} calls)" if calls > 1 else ""
    print(f"profile {label}: device busy {busy_us / 1e3:.3f} ms in "
          f"{len(spans) / calls:g} device events against {1e3 * wall_s:.3f} "
          f"ms of unprofiled wall{per}: idle share {idle:.4f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile {label}: device time {us / 1e3:.3f} ms  {name[:90]}")
    return {"wall_s": wall_s, "busy_ms": busy_us / 1e3, "idle_share": idle,
            "device_ms_by_name": {n: us / 1e3 for n, us in by_name.items()}}


def profile_phase(fx: dict) -> dict:
    """Where the time goes, from ``torch.profiler``: each kernel's own
    device time per call (the serving kernel at the serving shape, the
    training pair at its step shapes), the device's busy time over a warm
    drive of the serving path, over one warm speed fit and over one warm
    pretrain; the flash kernel at the served prefill and decode shapes.
    Measures only; where the profiler sees no device events it reports
    "not measured"."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import lstm_forecaster, make_supervised
    from repro_torch.kernels.int8_matmul import kernel as int8_kernel
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel

    out = {}
    x, q, scale = _int8_inputs(*INT8_MAIN, "float32", seed=500)
    dev = _kernel_device_ms(lambda: int8_kernel.int8_matmul(x, q, scale),
                            ["int8_matmul_kernel"])["int8_matmul_kernel"]
    out["int8_matmul"] = {"device_ms": dev}
    print(f"profile: int8_matmul device time at (M, K, N) = {INT8_MAIN} "
          f"{dev} ms (median of 100)")
    x, wx, wh, b = _kernel_inputs(*MAIN_SHAPE, "float32", seed=100)
    with torch.inference_mode():
        dev = _kernel_device_ms(
            lambda: lstm_kernel.lstm_sequence_fused(x, wx, wh, b),
            [SERVE_FWD_KERNEL])
    out["lstm_sequence_fused"] = {"device_ms": dev[SERVE_FWD_KERNEL]}
    print(f"profile: lstm_sequence_fused ({SERVE_FWD_KERNEL}) device time at "
          f"{MAIN_SHAPE} {dev[SERVE_FWD_KERNEL]} ms (median of 100)")
    for B, T, F, H in TRAIN_SHAPES:
        (x, wx, wh, b), res, dh, dc = _train_case(B, T, F, H, "float32", 300)

        def fwd_call():
            lstm_kernel.lstm_sequence_fwd_train(x, wx, wh, b)

        def bwd_call():
            lstm_kernel.lstm_sequence_bwd(x, *res, wx, wh, dh, dc)

        fwd = _kernel_device_ms(fwd_call, [TRAIN_FWD_KERNEL])[TRAIN_FWD_KERNEL]
        bwd = _kernel_device_ms(bwd_call, BWD_KERNELS)
        pair = (None if None in bwd.values() else sum(bwd.values()))
        # every device event of a call, by any name: a kernel the names
        # above missed would show here
        every = {"fwd": _device_ms_per_call(fwd_call),
                 "bwd": _device_ms_per_call(bwd_call)}
        out.setdefault("lstm_sequence_fwd_train", {})[B] = {
            "device_ms": fwd, "device_ms_every_event": every["fwd"]}
        out.setdefault("lstm_sequence_bwd", {})[B] = {
            "device_ms": pair, "device_ms_parts": bwd,
            "device_ms_every_event": every["bwd"]}
        print(f"profile: device time at {(B, T, F, H)} (median of 100): "
              f"{TRAIN_FWD_KERNEL} {fwd} ms; " + " + ".join(
                  f"{n} {ms} ms" for n, ms in bwd.items()) + f" = {pair} ms; "
              f"every device event a call (mean of 100): forward "
              f"{every['fwd']} ms, backward {every['bwd']} ms")

    def serve():
        run_main_path(fx, "cuda")
        torch.cuda.synchronize()

    out["serving"] = _busy(serve, "serving path, 5 modes")

    def bus_int8():
        run_bus_replay(fx, "cuda", "edge-cloud-integrated", quantized=True)
        torch.cuda.synchronize()

    bus_int8()  # warm
    out["bus_int8"] = _busy(bus_int8, "int8 bus run, integrated")
    int8_ms = sum(ms for n, ms in out["bus_int8"].get(
        "device_ms_by_name", {}).items() if "int8_matmul_kernel" in n)
    print(f"profile int8 bus run, integrated: int8_matmul_kernel device "
          f"time {int8_ms:.6f} ms in all")

    setup = unflatten(fx, "setup")
    ws, hist = port_data(setup)
    fits = {
        "speed_fit": ("one warm speed fit (window 1)",
                      setup["speed_epochs"], setup["speed_batch_size"],
                      ws.supervised(1), speed_draws(fx)[1]),
        "pretrain": ("one warm pretrain", setup["batch_epochs"],
                     setup["batch_size"],
                     make_supervised(hist, int(setup["lag"]), 0),
                     (unflatten(fx, "batch_init"), fx["batch_idx"])),
    }
    for key, (label, epochs, batch_size, data, (init, idx)) in fits.items():
        eng = lstm_forecaster(get_config("lstm-paper"), epochs=int(epochs),
                              batch_size=int(batch_size),
                              device="cuda").engine

        def fit():
            eng.fit_window(data, params_from_numpy(init, "cuda"),
                           torch.as_tensor(idx.astype(np.int64)))

        fit()  # warm: the bucket's mask check
        out[key] = _busy(fit, label)
    return out


def decode_equivalence_config(cfg):
    """The config step-by-step decode is held to one full forward at: an
    MoE config's capacity factor raised to its expert count, so that the
    forward, which dispatches at capacity, drops no slot, as the
    reference's tests/test_decode_equivalence.py does (serving drops none
    at E <= 64, and a decode step none at any E)."""
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def window_check(cfg, params, device, seed: int = ZOO_SEED,
                 shape=WINDOW_CHECK) -> dict:
    """A sliding-window config's decode past its window: the first 2
    layers of ``params``, a prompt of ``shape[0]`` tokens and ``shape[1]``
    decode steps, against one full forward over all of them
    (``decode_equivalence``); the ring buffer of ``cfg.window_size``
    slots wraps.  Returns {"tokens", "window", "err"}."""
    n = 2
    cfg2 = cfg.replace(n_layers=n)
    p2 = {**params, "layers": {k: v[:n] for k, v in params["layers"].items()}}
    prompt, steps = shape
    toks = zoo_prompts(cfg2, seed + 4, (1, prompt + steps))
    err = decode_equivalence(cfg2, p2, toks, prompt, device)
    return {"tokens": prompt + steps, "window": cfg.window_size, "err": err}


def zoo_phase(arch: str, fixture: Path, kernels: dict, plain: dict,
              served_layers: int = 0) -> dict:
    """A zoo model's serving path on the card, ``arch`` at full width
    through the port's ``Engine``.  (b) Parity in float32 at the config
    the fixture records (full depth, or the depth and experts it was cut
    to): the reference's ``fixture`` reproduced (greedy tokens equal,
    logits within ``ZOO_LOGIT_ATOL``; for an MoE config the routing and
    the kept slots of every dispatch too, ``check_zoo_routes``), and
    step-by-step decode against one full forward (for a sliding window,
    also past the window, ``window_check``).  (c) The served run in the
    config's bf16, at its full depth or ``served_layers``, params from a
    ``torch.Generator`` on the card: ``Engine.generate`` with every call of
    the path's kernels through their wrappers, ``kernels`` ({wrapper:
    launches per forward, or (launches a prefill, launches a decode
    step)}, 0 for a kernel the path must not launch), and none of the
    plain versions ``plain`` names ({label: (module, attribute)}), the
    device's idle share over a warm generate, and ``Engine.serve``
    finishing every request.  A config with a frontend is given its
    prefix embeddings (``zoo_prefix``) in every generate and in decode
    equivalence; the encoder-decoder's ``Engine.serve``, which carries
    none, must raise, as the reference's does.  Returns the measured
    numbers."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import get_model
    from repro_torch.serving.engine import Engine

    out = {}
    t_phase = time.perf_counter()
    fx = load_fixture(fixture)
    if str(fx["arch"]) != arch or bool(fx["reduced"]):
        raise AssertionError(f"{fixture} is not the full-width {arch} "
                             "fixture")
    t0 = time.perf_counter()
    with recording_routes() as routes:
        cfg, params, tokens, steps = run_zoo_parity(fx, "cuda")
    torch.cuda.synchronize()
    routing = (check_zoo_routes(fx, tokens, routes)
               if "route_prefill_idx" in fx else None)
    parity = check_zoo_parity(fx, tokens, steps, ZOO_LOGIT_ATOL,
                              routing and routing["stops"])
    cut = (f"{cfg.n_layers} of {get_config(arch).n_layers} layers"
           if cfg.n_layers != get_config(arch).n_layers
           else f"{cfg.n_layers} layers")
    if cfg.moe is not None:
        cut += (f", {cfg.moe.n_experts} of "
                f"{get_config(arch).moe.n_experts} experts top-"
                f"{cfg.moe.top_k}")
    print(f"zoo parity {arch} float32 full width ({cut}, d_model "
          f"{cfg.d_model}): params from numpy seed {int(fx['seed'])} "
          f"and {fx['tokens'].shape[0]} x {fx['tokens'].shape[1]} greedy "
          f"tokens in {time.perf_counter() - t0:.3f} s; tokens "
          f"{'equal' if not parity['near_ties'] else 'equal up to near ties '}"
          f"{parity['near_ties'] or ''} the reference's; top-{ZOO_TOPK} "
          f"logits max|d|={parity['logit_err']:.3g}, logsumexp "
          f"max|d|={parity['lse_err']:.3g} (atol {ZOO_LOGIT_ATOL})",
          flush=True)
    if routing is not None:
        print(f"zoo routing {arch} float32: every dispatch's top-"
              f"{cfg.moe.top_k} experts and kept slots equal the "
              f"reference's{' up to routing near ties ' if routing['route_near_ties'] else ''}"
              f"{routing['route_near_ties'] or ''} (routing margin atol "
              f"{ZOO_ROUTE_ATOL}); {routing['dropped']} slots dropped by the "
              f"capacity among those compared, as the reference's (its run "
              f"dropped {routing['dropped_ref']})", flush=True)
        if cfg.moe.n_experts > 64 and not (routing["dropped"]
                                           and routing["dropped_ref"]):
            raise AssertionError(f"{arch}: the capacity dropped no slot: "
                                 f"{routing}")
        out.update(route_near_ties=routing["route_near_ties"],
                   dropped_slots=routing["dropped"],
                   dropped_slots_ref=routing["dropped_ref"])
    toks = np.concatenate([fx["prompts"], fx["tokens"]], axis=1)
    eq = decode_equivalence(decode_equivalence_config(cfg), params, toks,
                            fx["prompts"].shape[1], "cuda",
                            fixture_prefix(cfg, fx))
    print(f"zoo decode equivalence {arch} float32 full width: prefill "
          f"{fx['prompts'].shape[1]} then {fx['tokens'].shape[1]} decode "
          f"steps against one forward over {toks.shape[1]} tokens, logits "
          f"max|d|={eq:.3g} (atol {DECODE_EQ_ATOL})", flush=True)
    if eq > DECODE_EQ_ATOL:
        raise AssertionError(f"decode differs from the full forward: {eq}")
    out.update(parity_logit_err=parity["logit_err"],
               parity_lse_err=parity["lse_err"],
               near_ties=parity["near_ties"], decode_equivalence_err=eq)
    if cfg.attention == "swa":
        t0 = time.perf_counter()
        win = window_check(cfg, params, "cuda")
        torch.cuda.synchronize()
        print(f"zoo window {arch} float32 full width, 2 layers: prefill "
              f"{WINDOW_CHECK[0]} then {WINDOW_CHECK[1]} decode steps past "
              f"the window of {win['window']} (ring buffer) against one "
              f"forward over {win['tokens']} tokens, logits "
              f"max|d|={win['err']:.3g} (atol {DECODE_EQ_ATOL}) in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        if win["err"] > DECODE_EQ_ATOL:
            raise AssertionError(f"decode past the window differs from the "
                                 f"full forward: {win}")
        out["window_check"] = win

    # Engine.serve in float32 on the same params, held to the reference's
    # serve run request by request; the encoder-decoder's raises
    _reset_launches(*kernels)
    t0 = time.perf_counter()
    engine = Engine(cfg, params, max_len=SERVE_CHECK_MAX_LEN, device="cuda")
    if cfg.family == "audio":
        out["serve_refused"] = serve_refusal(
            lambda: serve_check(engine, cfg), cfg.name, "float32", kernels)
        del params, engine
        gc.collect()
        torch.cuda.empty_cache()
        return served_run(arch, kernels, plain, served_layers, out, t_phase)
    done = serve_check(engine, cfg)
    torch.cuda.synchronize()
    served = check_zoo_serve(fx, done, ZOO_LOGIT_ATOL)
    order = sorted(done, key=lambda r: r.uid)
    ties = (f", then near ties {served['near_ties']}"
            if served["near_ties"] else "")
    print(f"zoo serve parity {arch} float32 full width: {len(done)} "
          f"requests (prompts {[len(r.prompt) for r in order]}, new tokens "
          f"{[r.max_new_tokens for r in order]}) on "
          f"{SERVE_CHECK_SLOTS} slots in "
          f"{time.perf_counter() - t0:.3f} s; admitted at "
          f"{[r.admitted_at for r in order]}, finished at "
          f"{[r.finished_at for r in order]} as the reference's; "
          f"{served['tokens']} tokens equal the reference's{ties} (smallest "
          f"reference margin among them {served['min_margin']:.3g}, a near "
          f"tie below {ZOO_LOGIT_ATOL}); launches "
          f"{ {w.__name__: w.launches for w in kernels} }, by kernel "
          f"{_by_kernel(kernels)}", flush=True)
    out.update(serve_parity_tokens=served["tokens"],
               serve_parity_near_ties=served["near_ties"],
               serve_parity_min_margin=served["min_margin"])
    # the engines' recording wrappers close over them: free the cycles
    # before the bf16 params need the card
    del params, engine
    gc.collect()
    torch.cuda.empty_cache()
    return served_run(arch, kernels, plain, served_layers, out, t_phase)


def serve_refusal(serve, arch: str, dtype: str, kernels: dict) -> str:
    """The encoder-decoder's ``Engine.serve`` (``serve()`` runs it): its
    text-only prefill has no frames to encode, so it must raise before any
    launch of ``kernels``, as the reference's does.  Returns the error's
    message."""
    _reset_launches(*kernels)
    try:
        serve()
    except ValueError as e:
        launched = {w.__name__: w.launches for w in kernels if w.launches}
        print(f"zoo serve {arch} {dtype}: Engine.serve raised before any "
              f"launch, as the reference's does: {e}", flush=True)
        if launched:
            raise AssertionError(f"serve launched {launched} before it "
                                 "raised") from e
        return str(e)
    raise AssertionError(f"Engine.serve of {arch} did not raise")


def _per_call(n) -> tuple:
    """(launches a prefill, launches a decode step) of a wrapper, from
    ``zoo_phase``'s ``kernels`` value."""
    return n if isinstance(n, tuple) else (n, n)


def served_run(arch: str, kernels: dict, plain: dict, served_layers: int,
               out: dict, t_phase: float) -> dict:
    """``zoo_phase`` (c): the served run in the config's bf16."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import get_model
    from repro_torch.serving.engine import Engine

    cfg = get_config(arch)
    if served_layers:
        cfg = cfg.replace(n_layers=served_layers)
    t0 = time.perf_counter()
    params = get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(ZOO_SEED), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S, new = SERVE_GENERATE
    prompts = zoo_prompts(cfg, ZOO_SEED + 1, (B, S))
    prefix = zoo_prefix(cfg, PREFIX_SEED + 1, B)
    engine = Engine(cfg, params, device="cuda",
                    max_len=SERVE_MAX_LEN + prefix_len(cfg, prefix))
    # warm: cuBLAS handles, the allocator
    engine.generate(prompts, new, prefix_embed=prefix)

    with counting_calls(plain) as counts:
        _reset_launches(*kernels)
        tokens, stats = engine.generate(prompts, new, prefix_embed=prefix)
        launches = {w.__name__: w.launches for w in kernels}
        by_kernel = _by_kernel(kernels)
    # the prefill and new - 1 decode steps; in bf16 with D % 8 == 0 every
    # prefill attention (S x G > 64 rows a KV head) takes flash attention's
    # wgmma prefill, every decode step (G <= 64 rows) its split decode; every
    # prefill scan (T = 512) the chunked selective scan, every decode step
    # (T = 1) its row-split decode
    per_call = {w: _per_call(n) for w, n in kernels.items()}
    expected = {w.__name__: pf + dc * (new - 1)
                for w, (pf, dc) in per_call.items()}
    expected_by_kernel = {
        w.__name__: {**dict.fromkeys(w.launches_by_kernel, 0),
                     PREFILL_DECODE[w.__name__][0]: pf,
                     PREFILL_DECODE[w.__name__][1]: dc * (new - 1)}
        for w, (pf, dc) in per_call.items()
        if hasattr(w, "launches_by_kernel")}
    decode_ms = 1e3 * stats.decode_s / (new - 1)
    after = ("" if prefix is None
             else f" after a prefix of {tuple(prefix.shape[1:])}")
    print(f"zoo generate {arch} bf16 full width ({cfg.n_layers} of "
          f"{get_config(arch).n_layers} layers), batch {B}, prompt {S}"
          f"{after}, {new} new tokens (max_len {engine.max_len}; params "
          f"initialised on the card in {init_s:.3f} s): prefill "
          f"{1e3 * stats.prefill_s:.3f} ms, decode {decode_ms:.3f} ms per "
          f"step, {stats.tokens_per_s:.1f} tokens/s; launches {launches}, expected {expected}; by kernel "
          f"{by_kernel}, expected {expected_by_kernel}; plain calls "
          f"{counts}", flush=True)
    if (launches != expected or by_kernel != expected_by_kernel
            or any(counts.values())):
        raise AssertionError(f"generate: launches {launches} (expected "
                             f"{expected}), by kernel {by_kernel} (expected "
                             f"{expected_by_kernel}), plain calls {counts}")
    if tokens.shape != (B, new) or not ((tokens >= 0)
                                        & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"generate returned {tokens.shape} tokens out "
                             "of the vocabulary")
    out.update(prefill_ms=1e3 * stats.prefill_s, decode_ms_per_step=decode_ms,
               tokens_per_s=stats.tokens_per_s, generate_launches=launches,
               generate_launches_by_kernel=by_kernel)
    # the device's events only: the host's ~10^5 operators a generate
    # would cost the profiler more than the generate
    out["busy"] = _busy(lambda: engine.generate(prompts, new,
                                                prefix_embed=prefix),
                        f"zoo generate {arch} {B} x {S} + {new}, bf16",
                        cpu=False)
    by_name = out["busy"].get("device_ms_by_name", {})
    port_ms = {k: sum(ms for n, ms in by_name.items() if k in n)
               for k in PORT_KERNELS}
    port_ms = {k: ms for k, ms in port_ms.items() if ms}
    out["busy"]["port_kernel_ms"] = port_ms
    for k, ms in port_ms.items():
        print(f"profile zoo generate {arch}: port kernel {k} device time "
              f"{ms:.6f} ms in all")
    if by_name:
        print(f"profile zoo generate {arch}: the port's kernels "
              f"{sum(port_ms.values()):.6f} ms of {out['busy']['busy_ms']:.6f}"
              f" ms busy")

    reqs = zoo_requests(cfg, ZOO_SEED + 2)
    if cfg.family == "audio":
        out["serve_refused_bf16"] = serve_refusal(
            lambda: engine.serve(reqs, n_slots=SERVE_SLOTS), arch, "bf16",
            kernels)
        out.update(serve_launches={w.__name__: 0 for w in kernels},
                   serve_launches_by_kernel=_by_kernel(kernels),
                   served_layers=cfg.n_layers)
        del engine, params
        return _close_zoo_phase(arch, out, t_phase)
    _reset_launches(*kernels)
    t0 = time.perf_counter()
    done = engine.serve(reqs, n_slots=SERVE_SLOTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in kernels}
    serve_by_kernel = _by_kernel(kernels)
    finished = sorted(r.uid for r in done)
    ok = finished == list(range(len(reqs))) and all(
        len(r.generated) == r.max_new_tokens
        and all(0 <= t < cfg.vocab_size for t in r.generated) for r in done)
    # each forward of serve launches each kernel as a forward of generate
    # does, so its count is a multiple of the count per forward
    whole = all(launches[w.__name__] % math.gcd(*n) == 0 if any(n) else
                not launches[w.__name__] for w, n in per_call.items())
    # bf16 at D % 8 == 0: never the SIMT kernel
    whole = whole and not any(c.get("simt") for c in serve_by_kernel.values())
    print(f"zoo serve {arch}: {len(reqs)} requests (prompts "
          f"{SERVE_PROMPT_LENS}, new tokens {SERVE_NEW_TOKENS}) on "
          f"{SERVE_SLOTS} slots in {wall:.3f} s, "
          f"{sum(r.max_new_tokens for r in reqs)} tokens, finished at ticks "
          f"{[r.finished_at for r in done]}; launches {launches}, by kernel "
          f"{serve_by_kernel} "
          f"{'whole forwards' if whole else 'NOT whole forwards'}; every "
          f"request "
          f"{'finished with its max_new_tokens' if ok else 'NOT finished'}",
          flush=True)
    if not ok or not whole:
        raise AssertionError(f"serve finished {finished}, launches "
                             f"{launches}")
    out.update(serve_wall_s=wall, serve_launches=launches,
               serve_launches_by_kernel=serve_by_kernel,
               served_layers=cfg.n_layers)
    del engine, params
    return _close_zoo_phase(arch, out, t_phase)


def _close_zoo_phase(arch: str, out: dict, t_phase: float) -> dict:
    """Free what the served run left on the card (its caller has dropped
    the engine and params), and print the phase's wall."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"zoo phase {arch}: {out['wall_s']:.3f} s", flush=True)
    return out


def expected_fleet_launches(datas_by_window: list, epochs: int,
                            batch_size: int) -> dict:
    """The launches one ungated ``InProcessFleetExecutor`` run must make,
    from its windows' sizes (``datas_by_window[t]``: window t's data of
    every stream): a fleet fit a window, one launch of #2 and one of #3 a
    step (epochs x the bucket's steps), whatever S; one launch of #1 per
    stacked predict (2 eval predicts a window, batch and speed inference
    from window 1 on) and 2 for the mask check of each padded bucket."""
    _import_port()
    from repro_torch.training.compiled import bucket_examples

    steps = fused = 0
    padded = set()
    for t, datas in enumerate(datas_by_window):
        sizes = [len(d["x"]) for d in datas]
        nb = bucket_examples(max(sizes), batch_size)
        steps += epochs * nb // batch_size
        if min(sizes) < nb:
            padded.add(nb)
        fused += 2 + (2 if t >= 1 else 0)
    return {"lstm_sequence_fwd_train": steps, "lstm_sequence_bwd": steps,
            "lstm_sequence_fused": fused + 2 * len(padded),
            "int8_matmul": 0}


def fleet_phase() -> dict:
    """The fleet on the card.  (a) The fixture's four runs replayed from
    the reference's draws (``run_fleet_replay``): every fit and every
    record within ``FLEET_ATOL``.  (b) At scale with the port's own draws,
    ``lstm-paper`` at its published width: ``InProcessFleetExecutor`` over
    ``FLEET_WINDOWS`` windows of ``FLEET_RPW`` records, ``FLEET_EPOCHS``
    epochs at batch ``FLEET_BATCH``, at each S of ``FLEET_STREAMS``; window
    0's fit of streams 0, S/2 and S-1 against a sequential
    ``CompiledForecaster.train`` with the same key, to 1e-5.  (c) Its
    launches: one of #2 and one of #3 a fit step, one of #1 a stacked
    predict, whatever S; an int8 fleet predict seven of #4.  (e) The
    per-window fleet fit's wall, device busy time and idle share at S = 1
    and each S, beside S = 8 sequential single-stream fits.  (f) The fleet
    launcher, ``--streams 8 --windows 4 --fast --gated --deployment
    integrated``.  (d), the kernels, is ``fleet_kernel_phase``.  Returns
    the phase's numbers."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import (
        FleetStages,
        lstm_fleet_forecaster,
        lstm_forecaster,
        pretrain_batch_model,
    )
    from repro_torch.kernels.int8_matmul import kernel as int8_kernel
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.launch import edge_cloud
    from repro_torch.runtime import InProcessFleetExecutor
    from repro_torch.runtime.executor import fleet_key_chains
    from repro_torch.serving.quantize import quantize_fleet
    from repro_torch.streams.sources import fleet_windowed_streams
    from repro_torch.training.optimizer import tree_leaves

    wrappers = (lstm_kernel.lstm_sequence_fused,
                lstm_kernel.lstm_sequence_fwd_train,
                lstm_kernel.lstm_sequence_bwd, int8_kernel.int8_matmul)
    out = {"launches": {}}
    t_phase = time.perf_counter()

    # (a) the fixture's replays
    fx = load_fixture(FLEET_FIXTURE)
    worst_fit = worst_rec = 0.0
    t0 = time.perf_counter()
    for name in FLEET_RUNS:
        res, fits, _ = run_fleet_replay(fx, "cuda", name)
        worst_fit = max(worst_fit, check_fleet_fits(fx, fits, FLEET_ATOL))
        worst_rec = max(worst_rec, check_fleet_records(
            fx, name, res, rtol=FLEET_ATOL, atol=FLEET_ATOL))
    print(f"fleet (a): the fixture's {len(FLEET_RUNS)} runs "
          f"({', '.join(FLEET_RUNS)}) replayed from the reference's draws in "
          f"{time.perf_counter() - t0:.3f} s: every fit within "
          f"{worst_fit:.3g} of the reference's, every record within "
          f"{worst_rec:.3g} relative (<= {FLEET_ATOL})", flush=True)
    out["replay"] = {"worst_fit": worst_fit, "worst_record": worst_rec}

    # (b), (c) and (e) at scale
    cfg = get_config("lstm-paper")
    for S in FLEET_STREAMS:
        streams, hist0 = fleet_windowed_streams(
            S, FLEET_WINDOWS, FLEET_RPW, "gradual",
            alphas=np.full(5, 1.5e-3))
        ids = list(streams)
        bp, _ = pretrain_batch_model(
            lstm_forecaster(cfg, epochs=8, batch_size=256, device="cuda"),
            hist0, 0)
        ff = lstm_fleet_forecaster(cfg, epochs=FLEET_EPOCHS,
                                   batch_size=FLEET_BATCH, device="cuda")
        first = {}
        train_fleet = ff.train_fleet

        def keeping(datas, keys, train_fleet=train_fleet, first=first):
            params, wall = train_fleet(datas, keys)
            first.setdefault("fit", (datas, keys, params))
            return params, wall

        ff.train_fleet = keeping
        want = expected_fleet_launches(
            [[streams[sid].supervised(t) for sid in ids]
             for t in range(FLEET_WINDOWS)], FLEET_EPOCHS, FLEET_BATCH)
        _reset_launches(*wrappers)
        t0 = time.perf_counter()
        res = InProcessFleetExecutor(FleetStages.build(ff)).run(
            streams, bp, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {w.__name__: w.launches for w in wrappers}
        out["launches"][f"fleet_S{S}"] = got
        walls = [r.t_speed_train for rr in res.results.values()
                 for r in rr.records]
        print(f"fleet (b) S={S}: {FLEET_WINDOWS} windows x {FLEET_RPW} "
              f"records, {FLEET_EPOCHS} epochs, batch {FLEET_BATCH}, in "
              f"{wall:.3f} s (fit wall median "
              f"{1e3 * statistics.median(walls):.3f} ms); launches {got}, "
              f"expected {want}; fleet mean RMSE {res.mean_rmse()}",
              flush=True)
        if got != want or res.train_dispatches != FLEET_WINDOWS:
            raise AssertionError(f"fleet S={S}: launches {got}, expected "
                                 f"{want}; {res.train_dispatches} fits")
        if any(len(r.records) != FLEET_WINDOWS - 1
               for r in res.results.values()):
            raise AssertionError(f"fleet S={S}: a stream missed a window")
        datas, keys, params = first["fit"]
        worst = 0.0
        for i in (0, S // 2, S - 1):
            seq, _ = ff.single.train(datas[i], None, keys[i])
            worst = max(worst, max(
                float((a - b).abs().max()) for a, b in zip(
                    tree_leaves(seq), tree_leaves(params[i]))))
        print(f"fleet (b) S={S}: window 0's fit of streams 0, {S // 2}, "
              f"{S - 1} against sequential CompiledForecaster.train with "
              f"the same keys: max|dparam| {worst:.3g} (<= 1e-5)",
              flush=True)
        if worst > 1e-5:
            raise AssertionError(f"fleet S={S}: the fleet fit differs from "
                                 f"the sequential fits by {worst}")
        xs = [d["x"] for d in datas]
        q8 = quantize_fleet(params, min_size=64)
        _reset_launches(*wrappers)
        preds = ff.predict_fleet(q8, xs)
        int8_launches = int8_kernel.int8_matmul.launches
        _reset_launches(*wrappers)
        ff.predict_fleet(params, xs)
        fused_launches = lstm_kernel.lstm_sequence_fused.launches
        lag = xs[0].shape[1]
        print(f"fleet (c) S={S}: an int8 fleet predict launched #4 "
              f"{int8_launches} times (expected {lag + 2}), a float one #1 "
              f"{fused_launches} time(s) (expected 1); int8 predictions "
              f"finite {all(np.isfinite(p).all() for p in preds)}",
              flush=True)
        if int8_launches != lag + 2 or fused_launches != 1 or not all(
                np.isfinite(p).all() and p.shape == (len(x), 1)
                for p, x in zip(preds, xs)):
            raise AssertionError(f"fleet S={S}: int8 predict launched "
                                 f"{int8_launches}, float {fused_launches}")

        # (e) one window's fit: the fleet at S, one stream, and (at S = 8)
        # the S streams one after another
        d1 = [streams[sid].supervised(1) for sid in ids]
        k1 = [fleet_key_chains(1, ids, 2)[sid][1] for sid in ids]
        times = {f"fleet_S{S}": _busy(lambda: train_fleet(d1, k1),
                                      f"fleet fit S={S}, one window")}
        if S == FLEET_STREAMS[0]:
            times["fleet_S1"] = _busy(lambda: train_fleet(d1[:1], k1[:1]),
                                      "fleet fit S=1, one window")
            times[f"sequential_x{S}"] = _busy(
                lambda: [ff.single.train(d, None, k)
                         for d, k in zip(d1, k1)],
                f"{S} sequential single-stream fits, one window")
        out.setdefault("fits", {}).update(times)

    # (f) the fleet launcher
    _reset_launches(*wrappers)
    t0 = time.perf_counter()
    runs = edge_cloud.run_real_fleet(edge_cloud.parse_args(
        ["--real", "--streams", "8", "--windows", "4", "--fast", "--gated",
         "--deployment", "integrated"]), device="cuda")
    torch.cuda.synchronize()
    res = runs["edge-cloud-integrated"]
    got = {w.__name__: w.launches for w in wrappers}
    out["launches"]["launcher"] = got
    # the pretrain (8 epochs of 1595 -> 2048 rows at 256) and the warm-up's
    # fit besides the run's fits, each 10 epochs x 4 steps
    steps = 8 * 8 + 10 * 4 * (res.train_dispatches + 1)
    print(f"fleet (f) launcher --streams 8 --windows 4 --fast --gated: "
          f"{time.perf_counter() - t0:.3f} s, {res.train_dispatches} fleet "
          f"fits for {res.total_retrains()} retrains "
          f"({res.skipped_retrains()} skipped), e2e {res.mean_e2e_s():.6f} "
          f"s, launches {got} (training kernels expected {steps} each)",
          flush=True)
    if (any(len(r.records) != 3 for r in res.results.values())
            or got["lstm_sequence_fwd_train"] != steps
            or got["lstm_sequence_bwd"] != steps
            or not got["lstm_sequence_fused"] or got["int8_matmul"]):
        raise AssertionError(f"fleet launcher: launches {got}, records "
                             f"{[len(r.records) for r in res.results.values()]}")
    out["launcher"] = {"fits": res.train_dispatches,
                       "retrains": res.total_retrains(),
                       "skipped": res.skipped_retrains(),
                       "table3": res.table3(), "e2e_s": res.mean_e2e_s()}
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"fleet phase: {out['wall_s']:.3f} s without its kernel checks",
          flush=True)
    return out


@contextlib.contextmanager
def counting_calls(plain: dict):
    """Count the calls of each plain version ``plain`` names ({label:
    (module, attribute)}) while the block runs; yields {label: calls}."""
    counts = {label: 0 for label in plain}
    saved = {label: getattr(mod, attr) for label, (mod, attr) in plain.items()}

    def counting(label, fn):
        def call(*args, **kwargs):
            counts[label] += 1
            return fn(*args, **kwargs)
        return call

    for label, (mod, attr) in plain.items():
        setattr(mod, attr, counting(label, saved[label]))
    try:
        yield counts
    finally:
        for label, (mod, attr) in plain.items():
            setattr(mod, attr, saved[label])


def _lstm_plain():
    from repro_torch.kernels.int8_matmul import ref as int8_ref
    from repro_torch.kernels.lstm_cell import ref as lstm_ref

    return {"lstm_sequence_ref": (lstm_ref, "lstm_sequence_ref"),
            "lstm_sequence_fwd_train_ref": (lstm_ref,
                                            "lstm_sequence_fwd_train_ref"),
            "lstm_sequence_bwd_ref": (lstm_ref, "lstm_sequence_bwd_ref"),
            "int8_matmul_ref": (int8_ref, "int8_matmul_ref")}


def tick_patterns(S: int, slots: int, x_row: np.ndarray) -> dict:
    """Serving ticks' batches over S streams: every stream at ``slots``
    rows, one stream with 3 rows and the rest none, and only the last
    stream with one row."""
    def rows(counts):
        return [np.repeat(x_row[None], n, axis=0) for n in counts]

    return {"all": rows([slots] * S),
            "one_of_S": rows([3] + [0] * (S - 1)),
            "last_only": rows([0] * (S - 1) + [1])}


def check_tick_launches(ff, params_float: list, x_row: np.ndarray,
                        slots: int, label: str) -> dict:
    """A serving tick's launches at every ``tick_patterns`` batch: a float
    tick exactly one of #1, an int8 tick exactly ``lag + 2`` of #4 (the
    input projection, the recurrent steps, Dense(10)), and no other kernel
    and no plain version, whatever S and however many streams have no
    rows."""
    _import_port()
    from repro_torch.core.stages import ServingStage
    from repro_torch.kernels.int8_matmul import kernel as int8_kernel
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.serving.quantize import quantize_fleet

    wrappers = (lstm_kernel.lstm_sequence_fused,
                lstm_kernel.lstm_sequence_fwd_train,
                lstm_kernel.lstm_sequence_bwd, int8_kernel.int8_matmul)
    lag = x_row.shape[0]
    stage = ServingStage(ff)
    out = {}
    for sync, params in (("float", params_float),
                         ("int8", quantize_fleet(params_float,
                                                 min_size=64))):
        want = {"lstm_sequence_fused": 1 if sync == "float" else 0,
                "lstm_sequence_fwd_train": 0, "lstm_sequence_bwd": 0,
                "int8_matmul": lag + 2 if sync == "int8" else 0}
        for pattern, xs in tick_patterns(len(params), slots, x_row).items():
            stage(params_seq=params, xs=xs)  # the restack, if any
            with counting_calls(_lstm_plain()) as plain:
                _reset_launches(*wrappers)
                preds = stage(params_seq=params, xs=xs)["preds"]
                got = {w.__name__: w.launches for w in wrappers}
            ok = (got == want and not any(plain.values()) and all(
                p.shape == (len(x), 1) and np.isfinite(p).all()
                for p, x in zip(preds, xs)))
            out[f"{sync}_{pattern}"] = got
            print(f"{label}: a {sync} tick at S={len(params)}, {pattern}: "
                  f"launches {got}, plain calls {plain} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{label}: {sync} tick {pattern} "
                                     f"launched {got} (want {want}), plain "
                                     f"{plain}")
    return out


def plane_kernel_timings() -> dict:
    """#1-#4 timed at the planes' shapes, each beside its plain version and
    its bound: #1 at a float serving tick's stacked batch (S = 8 at 4 rows,
    S = 64 at 16: every slot busy) and at the LoadForecaster's forecast
    (1, 4, 1, 8) beside cuDNN; #2 and #3 at its fit step (16, 4, 1, 8)
    beside cuDNN's forward and backward; #4 at an int8 tick's three
    products at S = 8 and 64 beside ``bmm(x, q.float()) * scale``.
    Returns {kernel: {shape: numbers}}."""
    import torch

    from repro_torch.kernels.int8_matmul import kernel as int8_kernel
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.lstm_cell import ref

    fused = lstm_kernel.lstm_sequence_fused
    fwd_train = lstm_kernel.lstm_sequence_fwd_train
    bwd = lstm_kernel.lstm_sequence_bwd
    int8 = int8_kernel.int8_matmul
    out: dict = {"lstm_sequence_fused": {}, "lstm_sequence_fwd_train": {},
                 "lstm_sequence_bwd": {}, "int8_matmul": {}}

    def record(name, shape, kern, plain, names, bound, library=None):
        dev = _kernel_device_ms(kern, names, calls=50)
        numbers = {"ms": _median_ms(kern, n=100),
                   "device_ms": (None if None in dev.values()
                                 else sum(dev.values())),
                   "plain_ms": _median_ms(plain, n=20, warmup=2),
                   "bound_ms": bound[0], "bound_by": bound[1],
                   "library_ms": (None if library is None
                                  else _median_ms(library, n=100))}
        out[name]["x".join(map(str, shape))] = numbers
        print(f"timing {name} at {shape} float32 (the planes' shape): "
              f"kernel {numbers['ms']:.6f} ms (device "
              f"{numbers['device_ms']} ms), plain {numbers['plain_ms']:.6f} "
              f"ms, library {numbers['library_ms']} ms, bound "
              f"{numbers['bound_ms']:.6f} ms ({numbers['bound_by']})",
              flush=True)

    T, F, H = 5, 5, 40
    with torch.inference_mode():
        for S, _, slots in REQUEST_SCALE:
            x, wx, wh, b, _ = _fleet_lstm_inputs(S, slots, T, F, H,
                                                 "float32", 1300 + S)
            one_ms, by = _lstm_bound(slots, T, F, H)
            record("lstm_sequence_fused", (S, slots, T, F, H),
                   lambda: fused(x, wx, wh, b),
                   lambda: ref.lstm_sequence_ref(x, wx, wh, b),
                   [SERVE_FWD_KERNEL], (S * one_ms, by))
            for M, K, N in ((slots * T, F, 4 * H), (slots, H, 4 * H),
                            (slots, H, 10)):
                xq, q, scale = _fleet_int8_inputs(S, M, K, N, "float32",
                                                  1400 + S)
                one_ms, by = _int8_bound(M, K, N)
                record("int8_matmul", (S, M, K, N),
                       lambda: int8(xq, q, scale),
                       lambda: int8_matmul_ref(xq, q, scale),
                       ["int8_matmul_kernel"], (S * one_ms, by),
                       lambda: torch.bmm(xq, q.float()) * scale[:, None, :])
        B, T, F, H = LOAD_PREDICT_SHAPE
        x, wx, wh, b = _kernel_inputs(B, T, F, H, "float32", seed=1500)
        lstm = _cudnn_lstm(wx, wh, b)
        record("lstm_sequence_fused", LOAD_PREDICT_SHAPE,
               lambda: fused(x, wx, wh, b),
               lambda: ref.lstm_sequence_ref(x, wx, wh, b),
               [SERVE_FWD_KERNEL], _lstm_bound(B, T, F, H),
               lambda: lstm(x))
    B, T, F, H = LOAD_FIT_SHAPE
    (x, wx, wh, b), res, dh, _ = _train_case(B, T, F, H, "float32", 1600)
    dc = torch.zeros_like(dh)
    lstm = _cudnn_lstm(wx, wh, b)
    x_lib = x.clone().requires_grad_(True)
    wrt = [x_lib, lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_ih_l0]
    h_lib = lstm(x_lib)[1][0][0]
    record("lstm_sequence_fwd_train", LOAD_FIT_SHAPE,
           lambda: fwd_train(x, wx, wh, b),
           lambda: ref.lstm_sequence_fwd_train_ref(x, wx, wh, b),
           [TRAIN_FWD_KERNEL], _fwd_train_bound(B, T, F, H),
           lambda: lstm(x_lib))
    record("lstm_sequence_bwd", LOAD_FIT_SHAPE,
           lambda: bwd(x, *res, wx, wh, dh, dc),
           lambda: ref.lstm_sequence_bwd_ref(x, *res, wx, wh, dh, dc),
           BWD_KERNELS, _bwd_bound(B, T, F, H),
           lambda: torch.autograd.grad(h_lib, wrt, grad_outputs=dh,
                                       retain_graph=True))
    return out


def load_kernel_check() -> float:
    """#1, #2 and #3 at the LoadForecaster's shapes (``LOAD_FIT_SHAPE``,
    ``LOAD_PREDICT_SHAPE``) against their plain versions, each run twice,
    bit for bit.  Returns the largest difference."""
    import torch

    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.lstm_cell import ref

    worst = 0.0
    for i, (B, T, F, H) in enumerate((LOAD_FIT_SHAPE, LOAD_PREDICT_SHAPE)):
        (x, wx, wh, b), res, dh, dc = _train_case(B, T, F, H, "float32",
                                                  1700 + i)
        with torch.inference_mode():
            fwd = [lstm_kernel.lstm_sequence_fused(x, wx, wh, b)
                   for _ in range(2)]
            fwd_ref = ref.lstm_sequence_ref(x, wx, wh, b, return_state=True)
        trains = [lstm_kernel.lstm_sequence_fwd_train(x, wx, wh, b)
                  for _ in range(2)]
        train_ref = ref.lstm_sequence_fwd_train_ref(x, wx, wh, b)
        grads = [lstm_kernel.lstm_sequence_bwd(x, *res, wx, wh, dh, dc)
                 for _ in range(2)]
        grads_ref = ref.lstm_sequence_bwd_ref(x, *res, wx, wh, dh, dc)
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for a, b2 in (fwd, trains, grads)
                   for u, v in zip(a, b2))
        errs = {"#1": max(float((u - v).abs().max())
                          for u, v in zip(fwd[0], fwd_ref)),
                "#2": max(float((u - v).abs().max())
                          for u, v in zip(trains[0], train_ref)),
                "#3": max(float((u - v).abs().max())
                          for u, v in zip(grads[0], grads_ref))}
        ok = (same and errs["#1"] <= KERNEL_ATOL and errs["#2"] <= KERNEL_ATOL
              and all(bool(((u - v).abs() <= BWD_ATOL + BWD_RTOL * v.abs())
                           .all()) for u, v in zip(grads[0], grads_ref)))
        print(f"placement (a) kernels at the LoadForecaster's {(B, T, F, H)}: "
              f"max|d| {errs}; two runs each "
              f"{'bit-identical' if same else 'DIFFER'} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"#1-#3 at {(B, T, F, H)}: {errs}, reruns "
                                 f"equal {same}")
        worst = max(worst, *errs.values())
    return worst


@contextlib.contextmanager
def logging_stages(ex, period: float):
    """Log every stage ``ex`` (a bus executor) schedules during a run:
    wraps the instance's ``_schedule`` to record the stage's kind, its
    window (the virtual clock over ``period``), its measured wall, the
    host clock at its end and the card's reserved memory after it; and
    Python's collector through ``gc.callbacks``: each collection's
    generation and host-clock span; and, at the first stage, how many
    objects were frozen out of the collector's reach
    (``runtime/executor.py: frozen_heap``).  Yields (stages,
    collections)."""

    import torch

    stages: list = []
    collections: list = []
    schedule = ex._schedule
    started: dict = {}

    def _schedule(module, wall_s, *args, **kw):
        stages.append({"kind": module, "window": int(ex.kernel.now // period),
                       "wall_s": float(wall_s), "end": time.perf_counter(),
                       # counted at the first stage only: the count walks
                       # the frozen heap
                       "frozen": None if stages else gc.get_freeze_count(),
                       "reserved": (torch.cuda.memory_reserved()
                                    if torch.cuda.is_available() else 0)})
        return schedule(module, wall_s, *args, **kw)

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            collections.append({"generation": info["generation"],
                                "start": started.pop("t"),
                                "end": time.perf_counter()})

    ex._schedule = _schedule
    gc.callbacks.append(on_gc)
    try:
        yield stages, collections
    finally:
        gc.callbacks.remove(on_gc)
        del ex._schedule


def stage_report(stages: list, collections: list, n: int = 5) -> dict:
    """The slowest ``n`` stages of ``logging_stages``' log, each with the
    collections that overlapped it on the host clock and the card's
    reserved-memory growth at it; the collector's count and total time by
    generation; each kind's count, median and largest wall."""
    slow = []
    order = sorted(range(len(stages)), key=lambda i: -stages[i]["wall_s"])
    for i in order[:n]:
        st = stages[i]
        begin = st["end"] - st["wall_s"]
        gcs = [(c["generation"], c["end"] - c["start"]) for c in collections
               if c["end"] > begin and c["start"] < st["end"]]
        grew = st["reserved"] - (stages[i - 1]["reserved"] if i else 0)
        slow.append({"kind": st["kind"], "window": st["window"],
                     "wall_ms": 1e3 * st["wall_s"], "index": i,
                     "gc_ms": [(g, 1e3 * t) for g, t in gcs],
                     "reserved_growth_bytes": int(grew)})
    by_gen: dict = {}
    for c in collections:
        count, total = by_gen.get(c["generation"], (0, 0.0))
        by_gen[c["generation"]] = (count + 1, total + c["end"] - c["start"])
    kinds: dict = {}
    for st in stages:
        kinds.setdefault(st["kind"], []).append(st["wall_s"])
    return {"slowest": slow,
            "frozen_objects": stages[0]["frozen"] if stages else None,
            "gc_by_generation": {g: {"count": c, "total_ms": 1e3 * t}
                                 for g, (c, t) in sorted(by_gen.items())},
            "by_kind": {k: {"count": len(w),
                            "median_ms": 1e3 * statistics.median(w),
                            "max_ms": 1e3 * max(w)}
                        for k, w in kinds.items()}}


def request_phase() -> dict:
    """The request plane on the card.  (a) The fixture's ``serve_float``
    and ``serve_int8`` runs replayed from the reference's draws
    (``run_request_replay``): answers within ``REQUEST_ATOL``, every stamp,
    latency and statistic exactly.  (b) ``serve_mix`` batched against
    unbatched over the float replay's installed models, float and int8,
    within ``UNBATCHED_ATOL``.  (c) A tick's launches
    (``check_tick_launches``).  (d) At scale, ``REQUEST_SCALE``, with
    measured walls: every request answered, none starved, one stacked
    predict a tick, sustained >= offered QPS, a finite p99; the latency
    percentiles, the median tick wall, a warm tick's busy device time and
    idle share, staleness, fallback share and restacks printed.  Returns
    the phase's numbers."""
    import torch

    from repro_torch.kernels.int8_matmul import kernel as int8_kernel
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.launch import edge_cloud
    from repro_torch.runtime import (
        FleetBusExecutor,
        edge_cloud_integrated,
        paper_topology,
    )
    from repro_torch.serving.quantize import quantize_fleet

    wrappers = (lstm_kernel.lstm_sequence_fused,
                lstm_kernel.lstm_sequence_fwd_train,
                lstm_kernel.lstm_sequence_bwd, int8_kernel.int8_matmul)
    out: dict = {"launches": {}}
    t_phase = time.perf_counter()
    fx, fleet_fx = load_fixture(REQUEST_FIXTURE), load_fixture(FLEET_FIXTURE)

    # (a) the replays
    replays = {}
    for name in ("serve_float", "serve_int8"):
        _reset_launches(*wrappers)
        t0 = time.perf_counter()
        res, ex, ff, _ = run_request_replay(fx, "cuda", name, fleet_fx)
        wall = time.perf_counter() - t0
        out["launches"][name] = {w.__name__: w.launches for w in wrappers}
        worst = check_request_run(fx, name, res, ex, REQUEST_ATOL)
        s = res.serving
        print(f"request (a) {name}: replayed in {wall:.3f} s; "
              f"{s['n_answered']}/{s['n_requests']} answered over "
              f"{s['ticks']} ticks at {s['dispatches_per_tick']} stacked "
              f"predicts a tick; answers within {worst['answer']:.3g} of the "
              f"reference's (<= {REQUEST_ATOL}), every stamp, latency, "
              f"window and fallback flag and the statistics equal; records "
              f"within {worst['records']:.3g}; launches "
              f"{out['launches'][name]}", flush=True)
        replays[name] = (res, ex, ff)
        out[name] = {"worst": worst, "serving": s}

    # (b) batched against unbatched on the installed models
    res, ex, ff = replays["serve_float"]
    setup = unflatten(fleet_fx, "fsetup")
    streams, _ = fleet_data(setup)
    last = int(setup["n_windows"]) - 1
    windows = {sid: streams[sid].supervised(last)["x"] for sid in ex.ids}
    params = [ex._fleet.state(sid).speed_params for sid in ex.ids]
    out["batched"] = {}
    for sync, ps in (("float", params),
                     ("int8", quantize_fleet(params, min_size=64))):
        got = batched_vs_unbatched(ff, ps, windows)
        out["batched"][sync] = got
        print(f"request (b) {sync}: {got['queries']} queries in "
              f"{got['ticks']} ticks ({got['dispatches']} stacked "
              f"predicts); batched within {got['worst']:.3g} of unbatched "
              f"(<= {UNBATCHED_ATOL})", flush=True)
        if got["worst"] > UNBATCHED_ATOL or got["dispatches"] != got["ticks"]:
            raise AssertionError(f"request (b) {sync}: {got}")

    # (c) a tick's launches at S = 3
    x_row = np.asarray(windows[ex.ids[0]])[-1]
    out["tick_launches"] = {"S3": check_tick_launches(
        ff, params, x_row, int(unflatten(fx, "rsetup")["slots"]),
        "request (c)")}

    # (d) at scale, measured walls
    out["scale"] = {}
    for S, qps, slots in REQUEST_SCALE:
        t0 = time.perf_counter()
        stages, bp, fleet, cost = edge_cloud.build_fleet_pipeline(
            S, REQUEST_WINDOWS, fast=True, device="cuda")
        ff = stages.speed_training.forecaster
        ex = FleetBusExecutor(stages, edge_cloud_integrated(),
                              paper_topology(), cost,
                              window_period_s=REQUEST_SCALE_PERIOD, qps=qps,
                              serve_slots=slots)
        _reset_launches(*wrappers)
        with counting_calls(_lstm_plain()) as plain, logging_stages(
                ex, REQUEST_SCALE_PERIOD) as (stages, collections):
            t1 = time.perf_counter()
            res = ex.run(fleet, bp, 1)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t1
        walls = stage_report(stages, collections)
        s = res.serving
        scale = ex._site("serving").compute_scale
        tick_walls = [w * scale for w in res.ledger.comp["serving"]]
        ids = ex.ids
        params = [ex._fleet.state(sid).speed_params for sid in ids]
        x_row = np.asarray(fleet[ids[0]].supervised(REQUEST_WINDOWS - 1)
                           ["x"])[-1]
        xs = [x_row[None] if i < slots else np.zeros((0,) + x_row.shape,
                                                     np.float32)
              for i in range(S)]
        busy = _busy(lambda: ex.stages.serving(params_seq=params, xs=xs),
                     f"request (d) a warm serving tick, S={S}, {slots} rows",
                     calls=TICK_PROFILE_CALLS)
        numbers = {
            "S": S, "slots": slots, "offered_qps": s["offered_qps"],
            "sustained_qps": s["sustained_qps"], "p50_s": s["p50_s"],
            "p99_s": s["p99_s"], "ticks": s["ticks"],
            "dispatches_per_tick": s["dispatches_per_tick"],
            "n_requests": s["n_requests"], "n_answered": s["n_answered"],
            "n_starved": s["n_starved"],
            "tick_wall_median_ms": 1e3 * statistics.median(tick_walls),
            "tick_busy_ms": busy["busy_ms"],
            "tick_idle_share": busy["idle_share"],
            "max_staleness": s["max_staleness"],
            "fallback_frac": s["fallback_frac"], "restacks": ff.restacks,
            "run_s": run_s, "launches": {w.__name__: w.launches
                                         for w in wrappers},
            "plain_calls": dict(plain), "stage_report": walls,
            "stage_walls": [(st["kind"], st["window"], st["wall_s"])
                            for st in stages]}
        out["scale"][f"S{S}"] = numbers
        for st in walls["slowest"]:
            print(f"request (d) S={S} slow stage: {st['kind']} window "
                  f"{st['window']} (stage {st['index']} of {len(stages)}) "
                  f"{st['wall_ms']:.3f} ms; collections over it "
                  f"(generation, ms) {st['gc_ms']}; card reserved memory "
                  f"grew {st['reserved_growth_bytes']} B", flush=True)
        print(f"request (d) S={S} stages by kind (count, median ms, max ms): "
              + ", ".join(f"{k} {v['count']} {v['median_ms']:.3f} "
                          f"{v['max_ms']:.3f}"
                          for k, v in walls["by_kind"].items())
              + f"; collector by generation {walls['gc_by_generation']}; "
              f"{walls['frozen_objects']} objects frozen over the run",
              flush=True)
        print(f"request (d) S={S}, {qps} qps offered, {slots} slots, "
              f"{REQUEST_WINDOWS} windows x 250 records: run {run_s:.3f} s "
              f"(build and pretrain {t1 - t0:.3f} s); "
              f"{s['n_answered']}/{s['n_requests']} answered, "
              f"{s['n_starved']} starved, {s['ticks']} ticks at "
              f"{s['dispatches_per_tick']} stacked predicts a tick; offered "
              f"{s['offered_qps']:.3f} qps, sustained "
              f"{s['sustained_qps']:.3f} qps; latency p50 "
              f"{1e3 * s['p50_s']:.3f} ms p99 {1e3 * s['p99_s']:.3f} ms "
              f"(virtual); tick wall median "
              f"{numbers['tick_wall_median_ms']:.3f} ms (host clock after a "
              f"sync); max staleness {s['max_staleness']}, fallback share "
              f"{s['fallback_frac']:.3f}; {ff.restacks} restacks; launches "
              f"{numbers['launches']}; plain calls {dict(plain)}",
              flush=True)
        if (s["n_answered"] != s["n_requests"] or s["n_starved"]
                or s["dispatches_per_tick"] != 1.0
                or s["sustained_qps"] < s["offered_qps"]
                or not np.isfinite(s["p99_s"]) or any(plain.values())):
            raise AssertionError(f"request (d) S={S}: {s}, plain {plain}")
        out["tick_launches"][f"S{S}"] = check_tick_launches(
            ff, params, x_row, slots, f"request (c) S={S}")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"request phase: {out['wall_s']:.3f} s", flush=True)
    return out


def placement_phase() -> dict:
    """The placement plane on the card.  (a) The fixture's
    ``LoadForecaster`` fits (the ramp's and the spike's) replayed from the
    reference's draws: every forecast within ``FORECAST_RTOL``, one launch
    of #2 and of #3 a fit step, one of #1 a forecast (and two a padded
    bucket's mask check), no plain version; #1-#3 at its shapes against
    their plain versions (``load_kernel_check``).  (b) The fixture's
    ``elastic_spike`` run replayed (``check_request_run``).  (c) The fleet
    launcher with both planes on (``PLANES_LAUNCHER``), float and
    ``--quantized``: the request plane's and the placement lines printed,
    every request answered at one stacked predict a tick, every
    post-warm-up window of every stream scored.  Returns the phase's
    numbers."""
    import io

    import torch

    from repro_torch.kernels.int8_matmul import kernel as int8_kernel
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.launch import edge_cloud
    from repro_torch.training.compiled import bucket_examples

    wrappers = (lstm_kernel.lstm_sequence_fused,
                lstm_kernel.lstm_sequence_fwd_train,
                lstm_kernel.lstm_sequence_bwd, int8_kernel.int8_matmul)
    out: dict = {"launches": {}}
    t_phase = time.perf_counter()
    fx, fleet_fx = load_fixture(REQUEST_FIXTURE), load_fixture(FLEET_FIXTURE)

    # (a) the forecaster's fits
    out["kernels_worst"] = load_kernel_check()
    for run in ("ramp", "elastic_spike"):
        lf, log = _load_forecaster(fx, run, "cuda")
        series = [fx[f"lf/{run}/series{i}"]
                  for i in range(len(fx[f"lf/{run}/value"]))]
        _reset_launches(*wrappers)
        t0 = time.perf_counter()
        with counting_calls(_lstm_plain()) as plain:
            for s in series:
                lf.forecast(s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {w.__name__: w.launches for w in wrappers}
        worst = check_forecasts(fx, run, log, FORECAST_RTOL)
        sizes = [len(s[-lf.history:]) - lf.lag
                 for s, (_, _, fitted) in zip(series, log["calls"])
                 if fitted]
        buckets = [bucket_examples(n, 16) for n in sizes]
        steps = sum(lf.epochs * nb // 16 for nb in buckets)
        padded = {nb for n, nb in zip(sizes, buckets) if n < nb}
        want = {"lstm_sequence_fused": len(sizes) + 2 * len(padded),
                "lstm_sequence_fwd_train": steps, "lstm_sequence_bwd": steps,
                "int8_matmul": 0}
        out["launches"][f"load_{run}"] = got
        out[f"load_{run}"] = {"fits": len(sizes), "worst_rel": worst,
                              "wall_s": wall}
        print(f"placement (a) LoadForecaster {run}: {len(series)} forecasts, "
              f"{len(sizes)} fits ({lf.epochs} epochs of one step at batch "
              f"16) in {wall:.3f} s, every forecast within {worst:.3g} "
              f"(relative) of the reference's; launches {got}, expected "
              f"{want}; plain calls {dict(plain)}", flush=True)
        if got != want or any(plain.values()) or not sizes:
            raise AssertionError(f"LoadForecaster {run}: launches {got}, "
                                 f"expected {want}, plain {plain}")

    # (b) the spike
    _reset_launches(*wrappers)
    t0 = time.perf_counter()
    res, ex, _, log = run_request_replay(fx, "cuda", "elastic_spike",
                                         fleet_fx)
    wall = time.perf_counter() - t0
    worst = check_request_run(fx, "elastic_spike", res, ex, REQUEST_ATOL)
    worst["forecast"] = check_forecasts(fx, "elastic_spike", log,
                                        FORECAST_RTOL)
    pl, s = res.placement, res.serving
    out["spike"] = {"worst": worst, "migrations": pl["migrations"],
                    "final_workers": pl["final_workers"],
                    "controller": {k: v for k, v in pl["controller"].items()
                                   if k != "events"},
                    "serving": s, "wall_s": wall}
    print(f"placement (b) elastic_spike replayed in {wall:.3f} s: "
          f"{len(pl['migrations'])} migrations "
          f"{[(m['t'], m['sid'], m['to']) for m in pl['migrations']]}, "
          f"{pl['controller']['scale_events']} scale events "
          f"({pl['controller']['proactive_scale_events']} proactive), "
          f"workers {pl['base_workers']} -> {pl['final_workers']}, all equal "
          f"to the reference's; answers within {worst['answer']:.3g}, "
          f"forecasts within {worst['forecast']:.3g}; "
          f"{s['n_answered']}/{s['n_requests']} answered", flush=True)

    # (c) the launcher with both planes on
    out["launcher"] = {}
    for path, flags in (("float", []), ("int8", ["--quantized"])):
        args = edge_cloud.parse_args([*PLANES_LAUNCHER, *flags])
        buf = io.StringIO()
        _reset_launches(*wrappers)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            runs = edge_cloud.run_real_fleet(args, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        print(text, end="")
        res = runs["edge-cloud-integrated"]
        s, pl = res.serving, res.placement
        scored = {sid: len(r.records) for sid, r in res.results.items()}
        dropped = sum(args.windows - 1 - n for n in scored.values())
        out["launches"][f"planes_launcher_{path}"] = {
            w.__name__: w.launches for w in wrappers}
        out["launcher"][path] = {
            "wall_s": wall, "serving": s, "dropped_windows": dropped,
            "migrations": len(pl["migrations"]),
            "scale_events": pl["controller"]["scale_events"],
            "forecaster_fits": pl["controller"]["forecaster_fits"],
            "final_workers": pl["final_workers"],
            "e2e_s": res.mean_e2e_s()}
        print(f"placement (c) launcher {' '.join(PLANES_LAUNCHER + flags)}: "
              f"{wall:.3f} s; {s['n_answered']}/{s['n_requests']} answered "
              f"at {s['dispatches_per_tick']} stacked predicts a tick; "
              f"{dropped} dropped windows; {len(pl['migrations'])} "
              f"migrations, {pl['controller']['scale_events']} scale "
              f"events, {pl['controller']['forecaster_fits']} forecaster "
              f"fits; launches {out['launches'][f'planes_launcher_{path}']}",
              flush=True)
        if ("request plane:" not in text or "elastic (proactive" not in text
                or s["n_answered"] != s["n_requests"] or s["n_starved"]
                or s["dispatches_per_tick"] != 1.0 or dropped):
            raise AssertionError(f"placement (c) {path}: {s}, scored "
                                 f"{scored}")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"placement phase: {out['wall_s']:.3f} s", flush=True)
    return out


@contextlib.contextmanager
def counting_forwards():
    """Count the LSTM forwards the port runs while the block runs, by kind
    (``models.lstm.forward``, which every predict, fit step and mask check
    goes through): ``float`` (no gradient), ``int8`` (a ``QTensor`` tree)
    and ``train`` (a fit step's forward, its backward follows); yields the
    counts.  ``forward_launches`` turns them into the launches #1-#4 must
    make."""
    from repro_torch.models import lstm as lstm_mod
    from repro_torch.serving.quantize import QTensor

    counts = {"float": 0, "int8": 0, "train": 0}
    forward = lstm_mod.forward

    def counting(cfg, p, x):
        import torch

        if any(isinstance(v, QTensor) for sub in p.values()
               for v in sub.values()):
            counts["int8"] += 1
        elif torch.is_grad_enabled() and p["lstm"]["kernel"].requires_grad:
            counts["train"] += 1
        else:
            counts["float"] += 1
        return forward(cfg, p, x)

    lstm_mod.forward = counting
    try:
        yield counts
    finally:
        lstm_mod.forward = forward


def forward_launches(counts: dict, lag: int) -> dict:
    """The launches of #1-#4 the forwards ``counts`` must make: one of #1 a
    float forward (a stacked predict or a mask check's loss), one of #2 and
    one of #3 a fit step, ``lag + 2`` of #4 an int8 forward (the input
    projection, one a step of the recurrence, Dense)."""
    return {"lstm_sequence_fused": counts["float"],
            "lstm_sequence_fwd_train": counts["train"],
            "lstm_sequence_bwd": counts["train"],
            "int8_matmul": (lag + 2) * counts["int8"]}


@contextlib.contextmanager
def auditing_installs(ex):
    """Record every publish ``ex``'s ``ModelSync`` accepts while the block
    runs, and recompute each one's checksum and HMAC signature afterwards:
    yields a dict whose ``accepted`` and ``tampered`` (accepted but not
    what the training site stamped and signed) are filled in at exit."""
    from repro_torch.runtime.health import verify_tree
    from repro_torch.serving.quantize import tree_checksum

    stage = ex.stages.single.model_sync
    compute = stage.compute
    seen: list = []
    audit = {"accepted": 0, "tampered": 0}

    def recording(**kw):
        out = compute(**kw)
        if out["ok"]:
            seen.append(kw)
        return out

    stage.compute = recording
    try:
        yield audit
    finally:
        del stage.compute
        for kw in seen:
            bad = ((kw.get("checksum") is not None
                    and tree_checksum(kw["params"]) != kw["checksum"])
                   or (kw.get("sig_key") is not None
                       and not verify_tree(kw["params"], kw["sig_key"],
                                           kw.get("signature"))))
            audit["tampered"] += bool(bad)
        audit["accepted"] = len(seen)


def _sign_verify_ms(tree, key, n: int = 200) -> float:
    """Median host ms of ``sign_tree`` and ``verify_tree`` of one publish."""
    from repro_torch.runtime.health import sign_tree, verify_tree

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        sig = sign_tree(tree, key)
        if not verify_tree(tree, key, sig):
            raise AssertionError("a publish fails its own signature")
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def chaos_phase() -> dict:
    """The chaos and health planes on the card.  (a) The fixture's runs
    (``CHAOS_RUNS`` and ``WATCHDOG_RUN``) replayed from the reference's
    draws (``run_chaos_replay``, ``check_chaos_run``): the fault schedule,
    bus signature, verdicts, adaptations, every stamp, latency and
    statistic exactly; answers and records to ``REQUEST_ATOL``; the
    envelope's counts exactly, its RMSE to ``CHAOS_RMSE_RTOL``.  (b) The
    port's ``ChaosHarness`` at ``CHAOS_BENCH`` (BENCH_chaos.json's config),
    all eight scenarios, under ``torch.use_deterministic_algorithms``:
    ``tests/test_chaos.py``'s properties (the RMSE ratio to ``fault_free``
    within ``RMSE_RATIO_MAX``, every corrupt and forged publish rejected
    and none installed, the partition suspected within two heartbeat
    intervals, no verdict in ``fault_free``, the adaptive calm run
    byte-identical to the static one, seed 0 twice byte-identical and seed
    1 different, no exception).  (c) ``CHAOS_SCALE_SCENARIOS`` at S = 64
    (``CHAOS_SCALE``) beside ``fault_free``: rejections, detection, no
    exception, every request answered or counted starved; each RMSE ratio
    printed against its envelope.  (d) Every run's launches of #1-#4 equal
    those of the forwards it ran (``forward_launches``), with no plain
    version.  (e) A ``forged_sync`` run's wall, busy device time and idle
    share at each size, and the host cost of signing and verifying one
    publish.  Returns the phase's numbers."""
    import torch

    from repro_torch.convert import params_from_numpy
    from repro_torch.core.scenarios import (
        RMSE_RATIO_MAX,
        ChaosHarness,
        bus_signature,
        forecast_signature,
        ledger_signature,
        scenario_plane,
        scenario_quantized,
    )
    from repro_torch.kernels.int8_matmul import kernel as int8_kernel
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.runtime.health import derive_sync_key
    from repro_torch.serving.quantize import quantize_tree
    from repro_torch.stacked import FleetParamView, _FleetStack

    wrappers = (lstm_kernel.lstm_sequence_fused,
                lstm_kernel.lstm_sequence_fwd_train,
                lstm_kernel.lstm_sequence_bwd, int8_kernel.int8_matmul)
    lag = 5  # lstm-paper's
    out: dict = {"launches": {}}
    t_phase = time.perf_counter()
    fx, fleet_fx = load_fixture(CHAOS_FIXTURE), load_fixture(FLEET_FIXTURE)

    def gate_launches(label: str, counts: dict, plain: dict) -> dict:
        got = {w.__name__: w.launches for w in wrappers}
        want = forward_launches(counts, lag)
        out["launches"][label] = got
        if got != want or any(plain.values()) or not counts["train"]:
            raise AssertionError(f"chaos {label}: launches {got}, the "
                                 f"forwards {counts} need {want}; plain "
                                 f"calls {dict(plain)}")
        return got

    # (a) the fixture's runs, replayed
    out["replays"] = {}
    for name in (*CHAOS_RUNS, WATCHDOG_RUN):
        _reset_launches(*wrappers)
        t0 = time.perf_counter()
        with counting_calls(_lstm_plain()) as plain, \
                counting_forwards() as counts:
            res, ex, fits = run_chaos_replay(fx, "cuda", name, fleet_fx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = gate_launches(f"replay_{name}", counts, plain)
        worst = check_chaos_run(fx, name, res, ex, fits, REQUEST_ATOL)
        env = json.loads(str(fx[f"env/{name}"]))
        out["replays"][name] = {"worst": worst, "wall_s": wall,
                                "fault_events": env.get("n_fault_events"),
                                "messages": len(res.message_log)}
        print(f"chaos (a) {name}: replayed in {wall:.3f} s; "
              f"{env.get('n_fault_events')} fault events, "
              f"{len(res.message_log)} bus messages, the schedule, bus "
              f"signature, verdicts, adaptations, fits and every stamp "
              f"equal to the reference's; answers within "
              f"{worst['answer']:.3g}, records within "
              f"{worst['records']:.3g}, RMSE within {worst['rmse']:.3g} "
              f"(relative); launches {got}", flush=True)

    # (b) and (c): the port's own harness, deterministic algorithms on
    torch.use_deterministic_algorithms(True)
    try:
        for label, cfg, names in (
                ("bench", CHAOS_BENCH, CHAOS_SCENARIOS),
                ("scale", CHAOS_SCALE,
                 ("fault_free", *CHAOS_SCALE_SCENARIOS))):
            t0 = time.perf_counter()
            h = ChaosHarness(**cfg, device="cuda")
            build_s = time.perf_counter() - t0
            envs, runs = {}, {}
            for name in names:
                ex = h.executor(scenario_plane(name, 0, h.period),
                                quantized=scenario_quantized(name),
                                health_plane=h.health)
                _reset_launches(*wrappers)
                with counting_calls(_lstm_plain()) as plain, \
                        counting_forwards() as counts, \
                        auditing_installs(ex) as audit:
                    t1 = time.perf_counter()
                    res = ex.run(h.streams_for(name), h.bp, h.run_key)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t1
                env = h.envelope(name, 0, res)
                got = gate_launches(f"{label}_{name}", counts, plain)
                envs[name], runs[name] = env, res
                s = res.serving
                health = {k: env["health"][k] for k in (
                    "n_suspected", "n_site_down", "n_recovered",
                    "byz_flagged", "threshold_adaptations")}
                print(f"chaos ({'b' if label == 'bench' else 'c'}) "
                      f"S={cfg['n_streams']} {name}: {wall:.3f} s; hybrid "
                      f"RMSE {env['rmse_hybrid']:.6f}; "
                      f"{s['n_answered']}/{s['n_requests']} answered, "
                      f"{s['n_starved']} starved, fallback "
                      f"{s['fallback_frac']:.3f}; faults "
                      f"{env.get('fault_stats')}; health {health}; "
                      f"{audit['accepted']} publishes installed, "
                      f"{audit['tampered']} of them tampered; launches "
                      f"{got}", flush=True)
                if (env["unhandled_exception"] is not None
                        or audit["tampered"]
                        or s["n_answered"] + s["n_starved"]
                        != s["n_requests"]):
                    raise AssertionError(f"chaos {label} {name}: {env}, "
                                         f"audit {audit}")
                envs[name]["wall_s"] = wall
            ff = envs["fault_free"]
            ratios = {n: e["rmse_hybrid"] / ff["rmse_hybrid"]
                      for n, e in envs.items()}
            stats = {n: e.get("fault_stats", {}) for n, e in envs.items()}
            for n in ("corrupted_int8_sync", "forged_sync"):
                if n not in envs:
                    continue
                kind = "msg_corrupt" if n.startswith("corrupt") \
                    else "msg_forge"
                rejected = envs[n]["corrupt_rejected" if kind
                                   == "msg_corrupt" else "forged_rejected"]
                if not rejected == stats[n][kind] > 0:
                    raise AssertionError(f"chaos {label} {n}: {rejected} "
                                         f"rejected of {stats[n][kind]}")
            if "partitioned_sync" in envs:
                hl = envs["partitioned_sync"]["health"]
                if not hl["n_suspected"] or not \
                        hl["detection_latency_hb_intervals"] <= 2.0:
                    raise AssertionError(f"chaos {label}: partition "
                                         f"detection {hl}")
            hff = runs["fault_free"].health
            if hff["verdicts"] or hff["threshold_adaptations"]:
                raise AssertionError(f"chaos {label}: fault_free verdicts "
                                     f"{hff['verdicts']}")
            for n, r in ratios.items():
                ok = r <= RMSE_RATIO_MAX[n]
                print(f"chaos ({'b' if label == 'bench' else 'c'}) "
                      f"S={cfg['n_streams']} {n}: RMSE ratio {r:.6f} to "
                      f"fault_free, envelope {RMSE_RATIO_MAX[n]} "
                      f"{'within' if ok else 'EXCEEDED'}", flush=True)
                if label == "bench" and not ok:
                    raise AssertionError(f"chaos bench {n}: RMSE ratio {r}")
            numbers = {"build_s": build_s, "ratios": ratios,
                       "envelopes": envs}
            if label == "bench":
                _, static = h.run_scenario("fault_free", 0, adaptive=False)
                _, again = h.run_scenario("sensor_chaos", 0)
                _, seed1 = h.run_scenario("sensor_chaos", 1)
                a, b = runs["fault_free"], runs["sensor_chaos"]
                calm = (bus_signature(a) == bus_signature(static)
                        and ledger_signature(a) == ledger_signature(static)
                        and forecast_signature(a)
                        == forecast_signature(static))
                rerun = (bus_signature(b) == bus_signature(again)
                         and ledger_signature(b) == ledger_signature(again)
                         and forecast_signature(b)
                         == forecast_signature(again))
                differs = bus_signature(b) != bus_signature(seed1)
                print(f"chaos (b) determinism: adaptive calm run "
                      f"{'byte-identical to' if calm else 'DIFFERS from'} "
                      f"the static one; sensor_chaos seed 0 twice "
                      f"{'byte-identical' if rerun else 'DIFFERS'}; seed 1 "
                      f"{'differs' if differs else 'EQUAL'}", flush=True)
                if not (calm and rerun and differs):
                    raise AssertionError("chaos (b) determinism failed")
            # (e) one forged_sync run's wall, busy time and idle share
            name = "forged_sync"

            def timed():
                env, _ = h.run_scenario(name, 0)
                torch.cuda.synchronize()
                if env["unhandled_exception"] is not None:
                    raise AssertionError(f"chaos (e) {name}: {env}")

            busy = _busy(timed, f"chaos (e) S={cfg['n_streams']} {name} run",
                         cpu=False)
            numbers["timed"] = {"scenario": name, **{
                k: busy[k] for k in ("wall_s", "busy_ms", "idle_share")}}
            out[label] = numbers
    finally:
        torch.use_deterministic_algorithms(False)

    # (e) the host cost of one signed publish, sign and verify
    model = params_from_numpy(unflatten(fleet_fx, "batch"), "cuda")
    stacked = {k: {j: torch.stack([v, v]) for j, v in sub.items()}
               for k, sub in model.items()}
    view = FleetParamView(_FleetStack(stacked), 0)
    key = derive_sync_key(0)
    out["hmac_ms"] = {"float": _sign_verify_ms(view, key),
                      "int8": _sign_verify_ms(
                          quantize_tree(model, min_size=64), key)}
    print(f"chaos (e) sign_tree + verify_tree a publish (host): float "
          f"{FLOAT_MODEL_NBYTES} B (a fleet view) "
          f"{out['hmac_ms']['float']:.4f} ms, int8 {INT8_MODEL_NBYTES} B "
          f"(on the card) {out['hmac_ms']['int8']:.4f} ms", flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"chaos phase: {out['wall_s']:.3f} s", flush=True)
    return out


def zoo_rest_phase(flash, others, plain: dict) -> dict:
    """Phases 16 (``DENSE_ARCHS``) and 17 (``MOE_ARCHS``): ``zoo_phase`` of
    each arch from its parity fixture, at its served depth
    (``SERVED_LAYERS``), with #6 launched once a layer and forward and
    ``others`` (the other zoo kernels) never.  Returns {arch: its
    numbers}."""
    from repro_torch.configs import get_config

    runs = {}
    for phase, archs in ((16, DENSE_ARCHS), (17, MOE_ARCHS)):
        t0 = time.perf_counter()
        for arch in archs:
            layers = SERVED_LAYERS.get(arch, get_config(arch).n_layers)
            runs[arch] = zoo_phase(
                arch, zoo_fixture(arch),
                {flash: layers, **dict.fromkeys(others, 0)}, plain,
                served_layers=layers)
        print(f"phase {phase} ({', '.join(archs)}): "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    return runs


def zoo_encdec_vlm_phase(flash, others, plain: dict) -> dict:
    """Phase 18: ``zoo_phase`` of the encoder-decoder
    (``seamless-m4t-medium``) and the VLM (``paligemma-3b``), each from its
    parity fixture at full width and depth, with their prefix embeddings;
    #6 launched once an attention (seamless: its encoder's, its decoder's
    self and cross attentions a prefill, the decoder's two a decode step;
    paligemma: once a layer and forward), exactly ``ENCDEC_VLM_LAUNCHES``
    in a bf16 generate, and ``others`` (the other zoo kernels) never.
    Returns {arch: its numbers}."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    seamless, pali = get_config(ENCDEC_ARCH), get_config(VLM_ARCH)
    L, none = seamless.n_layers, dict.fromkeys(others, 0)
    per_call = {ENCDEC_ARCH: (seamless.encdec.n_encoder_layers + 2 * L,
                              2 * L),
                VLM_ARCH: (pali.n_layers, pali.n_layers)}
    runs = {}
    for arch in ENCDEC_VLM_ARCHS:
        runs[arch] = zoo_phase(arch, zoo_fixture(arch),
                               {flash: per_call[arch], **none}, plain)
        got = runs[arch]["generate_launches"][flash.__name__]
        if got != ENCDEC_VLM_LAUNCHES[arch]:
            raise AssertionError(f"{arch}: generate launched #6 {got} "
                                 f"times, not {ENCDEC_VLM_LAUNCHES[arch]}")
    print(f"phase 18 ({', '.join(ENCDEC_VLM_ARCHS)}): "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return runs


# the work of the backward and of each of its kernels: (query-shaped
# tensors moved, key-shaped tensors moved, float32 row statistics moved,
# products), a tensor moved once, a product 2 D operations a (query,
# slot) pair and query head.  The whole backward reads q, o, dO, k, v and
# writes dq, dk, dv: the five products of a flash backward (q k^T, dO
# v^T, P^T dO, dS K, dS^T q).  bwd_dq's function (dq and each row's lse
# and delta) reads q, o, dO, k, v and writes dq and the statistics: q k^T,
# dO v^T, dS K.  bwd_dkdv's (dk, dv) reads q, dO, k, v and the statistics
# and writes dk, dv: q k^T, dO v^T, P^T dO, dS^T q; each route's pair
# computes these two functions
FLASH_BWD_WORK = {None: (4, 4, 0, 5), "bwd_dq": (4, 2, 2, 3),
                  "bwd_dkdv": (2, 4, 2, 4), "bwd_dq_wgmma": (4, 2, 2, 3),
                  "bwd_dkdv_wgmma": (2, 4, 2, 4)}


def _flash_bwd_bound(q, k, q_pos, kv_pos, causal=True, window=0, part=None):
    """Bound of one backward call (``part`` None) or of one of its kernels
    (``part`` a key of ``FLASH_BWD_WORK``), by ``FLASH_BWD_WORK``: the query-
    and key-shaped tensors moved once (K and V of the written slots
    only), the positions once, the products over the (query, slot) pairs
    the positions let through, at the bf16 tensor-core rate for bf16
    inputs, the float32 rate otherwise."""
    import torch

    from repro_torch.kernels.flash_attention.ref import position_mask

    B, Sq, Hq, D = q.shape
    esize = q.element_size()
    n_q, n_k, n_stats, products = FLASH_BWD_WORK[part]
    pairs = int(position_mask(q_pos, kv_pos, causal, window).sum())
    live = int((kv_pos >= 0).sum())
    nbytes = (n_q * B * Sq * Hq * D + n_k * live * k.shape[2] * D) * esize \
        + 4 * (n_stats * B * Sq * Hq + q_pos.numel() + kv_pos.numel())
    peak = (PEAK_BF16_FLOP_PER_S if q.dtype == torch.bfloat16
            else PEAK_F32_FLOP_PER_S)
    return _bound(nbytes, 2 * products * D * Hq * pairs, peak)


def _sdpa_backward(q, k, v, do, causal: bool, mask=None):
    """A call that takes the gradient of ``scaled_dot_product_attention(...,
    enable_gqa=True)`` (causal or not, arange positions; or with the
    boolean ``mask`` (B, Sq, Sk) of the positions as ``attn_mask``) on
    (B,H,S,D) copies of the inputs, its forward run once: the library
    yardstick of the backward, never used by the port."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=None if mask is None else mask[:, None],
        is_causal=causal and mask is None, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def flash_backward_phase() -> dict:
    """Phase 19 (a): #6's backward (``kernel.flash_attention_backward``,
    the route ``bwd_kernel_for`` picks: the SIMT pair ``bwd_dq`` +
    ``bwd_dkdv`` in float32, the tensor-core pair ``bwd_dq_wgmma`` +
    ``bwd_dkdv_wgmma`` in bf16) against its plain version
    (``ref.flash_attend_bwd_ref`` in float32 on the same inputs and the
    forward kernel's own o) at ``FLASH_BWD_SHAPES`` in float32 and bf16;
    every rerun bit for bit, and again with the statistics scratch filled
    with NaN first; a fully masked row's dq exactly 0.  A bf16
    case is also held, for the record, to its own arithmetic
    (``ref.flash_attend_bwd_tc_ref`` on the card), and the SIMT pair,
    forced, is held to the same gate.  Each case timed: CUDA events over
    the call, each kernel's device time by the profiler, the plain
    version, the bound (``_flash_bwd_bound``) and the device time of
    SDPA's backward where it computes the same function (arange
    positions, with the positions' mask as ``attn_mask`` under a window;
    not where a row attends nothing, where SDPA gives NaN); in bf16 the
    two routes in turns (wgmma, simt, simt, wgmma).  Returns every
    case's numbers, and the tinyllama case's in each dtype at the top."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ref as flash_ref

    bwd = flash_kernel.flash_attention_backward
    cases, max_err = {}, {"float32": 0.0, "bfloat16": 0.0}

    def gate_of(got, want, dtype):
        errs, gates = [], []
        for g, w in zip(got, want):
            d = (g.float() - w).abs()
            errs.append(float(d.max()))
            gates.append(float((d / (
                FLASH_BWD_TOL * (1 + w.abs()) if dtype == "float32"
                else FLASH_STEP_RTOL * w.abs() + FLASH_STEP_ATOL)).max()))
        return errs, max(gates)

    for i, (label, (shape, causal, window, kind)) in enumerate(
            FLASH_BWD_SHAPES.items()):
        for dtype in ("float32", "bfloat16"):
            q, k, v, q_pos, kv_pos = _flash_case(*shape, dtype, 800 + i, kind)
            do = torch.tensor(np.random.default_rng(900 + i).standard_normal(
                q.shape), dtype=q.dtype, device="cuda")
            o = flash_kernel.flash_attention(q, k, v, q_pos, kv_pos,
                                             causal=causal, window=window)
            route = flash_kernel.bwd_kernel_for(shape[5], q.dtype)

            def run(kernel=None, stats_fill=None):
                return bwd(q, k, v, o, do, q_pos, kv_pos, causal=causal,
                           window=window, kernel=kernel,
                           stats_fill=stats_fill)
            got = run()
            want = flash_ref.flash_attend_bwd_ref(
                q.float(), k.float(), v.float(), o.float(), do.float(), q_pos,
                kv_pos, causal=causal, window=window)
            torch.cuda.synchronize()
            errs, gate = gate_of(got, want, dtype)
            same = all(torch.equal(a, b) for a, b in zip(run(), got))
            # the statistics scratch filled with NaN first: a slot no kernel
            # writes must not reach the gradients
            nan_same = all(torch.equal(a, b) for a, b in zip(
                run(stats_fill=float("nan")), got))
            dead = ~flash_ref.position_mask(q_pos, kv_pos, causal,
                                            window).any(-1)
            dead_zero = bool((got[0][dead] == 0).all())
            ok = gate <= 1.0 and same and nan_same and dead_zero and (
                kind != "holes_dead" or bool(dead.any()))
            max_err[dtype] = max(max_err[dtype], *errs)
            bound_ms, bound_by = _flash_bwd_bound(q, k, q_pos, kv_pos, causal,
                                                  window)
            names = flash_kernel.BWD_ROUTES[route]
            bounds = {part: _flash_bwd_bound(q, k, q_pos, kv_pos, causal,
                                             window, part)
                      for part in FLASH_BWD_KERNELS}
            profiled = [FLASH_BWD_KERNELS[n] for n in names]
            numbers = {
                "route": route, "max_abs_err": dict(zip(("dq", "dk", "dv"),
                                                        errs)),
                "gate": gate, "rerun_identical": same,
                "nan_stats_identical": nan_same,
                "ms": _median_ms(run, n=50, warmup=5),
                "device_ms": _kernel_device_ms(run, profiled, calls=20),
                "plain_ms": _median_ms(lambda: flash_ref.flash_attend_bwd_ref(
                    q, k, v, o, do, q_pos, kv_pos, causal=causal,
                    window=window), n=10, warmup=2),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_by_kernel": bounds,
                "library_device_ms": None, "library_ms": None}
            extra = ""
            if route == "wgmma":
                # the tensor-core arithmetic's own plain version (within a
                # bf16 step of it, for the record), and the SIMT pair forced:
                # its gate, and both pairs timed in turns
                tc = flash_ref.flash_attend_bwd_tc_ref(
                    q, k, v, o, do, q_pos, kv_pos, causal=causal,
                    window=window)
                numbers["tc_gate"] = gate_of(got, tc, "bfloat16")[1]
                simt = run("simt")
                numbers["simt_gate"] = gate_of(simt, want, dtype)[1]
                ok = ok and numbers["simt_gate"] <= 1.0
                turns = [("wgmma", None), ("simt", "simt"), ("simt", "simt"),
                         ("wgmma", None)]
                numbers["ms_turns"] = [
                    (r, _median_ms(lambda: run(kn), n=50, warmup=5))
                    for r, kn in turns]
                simt_names = [FLASH_BWD_KERNELS[n]
                              for n in flash_kernel.BWD_ROUTES["simt"]]
                numbers["simt_device_ms"] = _kernel_device_ms(
                    lambda: run("simt"), simt_names, calls=20)
                numbers["device_ms_again"] = _kernel_device_ms(
                    run, profiled, calls=20)
                extra = (f"; tc_ref gate {numbers['tc_gate']:.3g}; SIMT pair "
                         f"forced: gate {numbers['simt_gate']:.3g}, device "
                         f"{numbers['simt_device_ms']} ms; events in turns "
                         f"{numbers['ms_turns']}; {route} again "
                         f"{numbers['device_ms_again']}")
                del tc, simt
            if kind in ("arange", "full", "cross"):
                # cross: every query at 0, every slot written, not causal:
                # SDPA's function too; a window through the positions' mask
                mask = flash_ref.position_mask(q_pos, kv_pos, causal,
                                               window) if window else None
                sdpa = _sdpa_backward(q, k, v, do, causal, mask)
                numbers["library_ms"] = _median_ms(sdpa, n=50, warmup=5)
                numbers["library_device_ms"] = _device_ms_per_call(sdpa, 20)
            cases[f"{label} {dtype}"] = numbers
            dev = numbers["device_ms"]
            print(f"kernel flash_attention_backward {label} (B, Sq, Sk, Hq, "
                  f"Hkv, D) = {shape} causal={causal} window={window} {kind} "
                  f"{dtype} [{route}]: max|d| dq {errs[0]:.3g} dk "
                  f"{errs[1]:.3g} dv {errs[2]:.3g} ({gate:.3g} of the gate); "
                  f"rerun {'bit-identical' if same else 'DIFFERS'}, on NaN "
                  f"statistics {'bit-identical' if nan_same else 'DIFFERS'}; "
                  f"{int(dead.sum())} dead rows, dq "
                  f"{'exactly 0' if dead_zero else 'NOT 0'}; "
                  f"{numbers['ms']:.6f} ms (events), device "
                  + " + ".join(f"{n} {dev[FLASH_BWD_KERNELS[n]]}"
                               for n in names)
                  + f" ms; plain {numbers['plain_ms']:.6f} ms; bound "
                  f"{bound_ms:.6f} ms ({bound_by}); by kernel "
                  + ", ".join(f"{n} {bounds[n][0]:.6f} ({bounds[n][1]})"
                              for n in names)
                  + f"; SDPA backward {numbers['library_ms']} ms, device "
                  f"{numbers['library_device_ms']} ms{extra} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"flash_attention_backward disagrees "
                                     f"with its plain version: {label} "
                                     f"{shape} {dtype}")
            del q, k, v, o, do, got, want
    main = cases["tinyllama train bfloat16"]
    return {"max_abs_err": max_err["float32"],
            "max_abs_err_bf16": max_err["bfloat16"], "cases": cases,
            "ms": main["ms"], "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_device_ms": main["library_device_ms"]}


def train_batch(cfg, seed: int, shape=TRAIN_BATCH) -> dict:
    """One training batch from numpy ``seed``: tokens uniform on the vocab
    (B, S + 1), split into ``tokens`` and next-token ``targets``, int32."""
    B, S = shape
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()}


def flat_tree(tree: dict, prefix: str = "") -> dict:
    """{"a/b": leaf} of a nested dict, in sorted key order."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(flat_tree(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tree[k]
    return out


def grad_summary(grads: dict, seed: int) -> dict:
    """A gradient tree's summary ({path: tensor}, on any device): each
    leaf's norm in float64 (a norm per layer of a stacked leaf, one under
    ``STACK_NAMES``), its element count, ``TRAIN_SAMPLES`` entries at
    indices drawn from (seed, crc32 of its path), and the global norm."""
    import torch

    out, total = {}, 0.0
    for path in sorted(grads):
        g = grads[path].detach()
        sq = g.double() ** 2
        norm = (torch.sqrt(sq.reshape(g.shape[0], -1).sum(1))
                if path.split("/")[0] in STACK_NAMES else torch.sqrt(sq.sum()))
        del sq
        total += float((norm ** 2).sum())
        idx = np.random.default_rng([seed, zlib.crc32(path.encode())]).integers(
            0, g.numel(), TRAIN_SAMPLES)
        out[f"norm/{path}"] = norm.cpu().numpy()
        out[f"numel/{path}"] = np.int64(g.numel())
        out[f"sample/{path}"] = g.reshape(-1)[torch.as_tensor(
            idx, device=g.device)].float().cpu().numpy()
        out[f"sample_idx/{path}"] = idx
    out["grad_norm"] = np.float64(np.sqrt(total))
    return out


def train_fixture_arrays(arch: str, reduced: bool, run: dict,
                         extra: Optional[dict] = None) -> dict:
    """The phase-19 (b) and 20 (b) fixtures: the run's config, seed, batch
    and schedule, and its losses and ``grad_summary`` (no weights); phase
    20's add ``extra``, ``fixture_cuts``' record of the depth."""
    return {**(extra or {}), "arch": np.array(arch),
            "reduced": np.array(reduced),
            "seed": np.int64(TRAIN_SEED), "draw_chunk": np.int64(DRAW_CHUNK),
            "batch_shape": np.array(TRAIN_BATCH, np.int64),
            "schedule": np.array(TRAIN_SCHEDULE, np.float64),
            "steps": np.int64(TRAIN_STEPS),
            **{k: np.asarray(v) for k, v in run.items()}}


def run_train_parity(fx: dict, device) -> dict:
    """The fixture's training on the port: params from ``numpy_params``
    and the batch from ``train_batch`` on ``device``, step 1's loss, xent
    and ``grad_summary`` through ``model.loss_fn`` and autograd, then
    the fixture's steps of adamw(warmup_cosine(*schedule)) (step 1 from
    those gradients, the rest through ``make_train_step``).  Returns the
    numbers the fixture holds."""
    _import_port()
    import torch

    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import get_model
    from repro_torch.training.optimizer import (adamw, tree_leaves, tree_map,
                                                tree_unflatten, warmup_cosine)
    from repro_torch.training.train_loop import make_train_step

    cfg = zoo_config(fx)
    seed = int(fx["seed"])
    params = params_from_numpy(numpy_params(cfg, seed, int(fx["draw_chunk"])),
                               device)
    batch = {k: torch.as_tensor(v, device=device) for k, v in train_batch(
        cfg, seed, tuple(int(n) for n in fx["batch_shape"])).items()}
    model = get_model(cfg)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = model.loss_fn(live, batch)
    grads = tree_unflatten(live, list(torch.autograd.grad(
        loss, tree_leaves(live))))
    del live
    loss = loss.detach()
    out = {"loss": np.float64(float(loss)),
           "xent": np.float64(float(metrics["xent"].detach())),
           **grad_summary(flat_tree(grads), seed)}
    lr, warmup, total = (float(x) for x in fx["schedule"])
    opt = adamw(warmup_cosine(lr, int(warmup), int(total)))
    state = opt.init(params)
    params, state, _ = opt.update(grads, state, params)
    del grads
    losses = [float(loss)]
    step = make_train_step(model, opt)
    for _ in range(int(fx["steps"]) - 1):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    out["losses"] = np.array(losses, np.float64)
    return out


def check_train_parity(fx: dict, got: dict) -> dict:
    """``got`` (``run_train_parity``'s) against the fixture: the losses
    within TRAIN_LOSS_ATOL, the global and each leaf's norms within
    TRAIN_NORM_RTOL, every sampled entry within TRAIN_SAMPLE_RTOL of its
    leaf's rms.  Returns the worst readings; raises on a miss."""
    paths = sorted(k[len("norm/"):] for k in fx if k.startswith("norm/"))
    if paths != sorted(k[len("norm/"):] for k in got
                       if k.startswith("norm/")):
        raise AssertionError("the port's gradient tree differs from the "
                             "fixture's")
    loss_err = max(abs(float(got[k]) - float(fx[k])) for k in ("loss",
                                                             "xent"))
    loss_err = max(loss_err, float(np.abs(got["losses"]
                                          - fx["losses"]).max()))
    norm_rel = abs(float(got["grad_norm"]) / float(fx["grad_norm"]) - 1)
    sample_gate = 0.0
    for path in paths:
        want, have = fx[f"norm/{path}"], got[f"norm/{path}"]
        norm_rel = max(norm_rel, float((np.abs(have - want) / np.maximum(
            want, 1e-30)).max()))
        if not np.array_equal(fx[f"sample_idx/{path}"],
                              got[f"sample_idx/{path}"]):
            raise AssertionError(f"{path}: sampled at other indices")
        rms = float(np.sqrt((want ** 2).sum() / float(fx[f"numel/{path}"])))
        d = np.abs(got[f"sample/{path}"] - fx[f"sample/{path}"]).max()
        sample_gate = max(sample_gate, float(d) / max(
            TRAIN_SAMPLE_RTOL * rms, 1e-30))
    readings = {"loss_max_abs_err": loss_err, "norm_max_rel_err": norm_rel,
                "sample_gate": sample_gate,
                "losses": [float(x) for x in got["losses"]],
                "fixture_losses": [float(x) for x in fx["losses"]]}
    if (loss_err > TRAIN_LOSS_ATOL or norm_rel > TRAIN_NORM_RTOL
            or sample_gate > 1.0):
        raise AssertionError(f"training parity missed: {readings}")
    return readings


def bf16_train_run(flash, bwd, plain: dict) -> dict:
    """Phase 19 (c): ``ZOO_ARCH`` at full width and depth in its own dtypes
    (bf16 params from ``numpy_params``, float32 moments),
    ``BF16_TRAIN_STEPS`` steps of adamw(warmup_cosine(*BF16_SCHEDULE)) on
    one batch of ``BF16_TRAIN_BATCH`` through ``make_train_step``: every
    loss finite, the last below the first; #6 launched exactly once a
    layer as ``prefill_wgmma`` and its backward once a layer each as
    ``bwd_dq_wgmma`` and ``bwd_dkdv_wgmma`` a step, no other kernel of #6
    (the SIMT backward pair none) and no plain version ``plain`` names.
    Then a step's wall (median over steps 2..),
    the device's busy time and idle share over a profiled step, #6's
    backward device time summed over it, and the peak memory."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import nn
    from repro_torch.models.model import get_model
    from repro_torch.training.optimizer import adamw, warmup_cosine
    from repro_torch.training.train_loop import make_train_step

    cfg = get_config(ZOO_ARCH)
    L = cfg.n_layers
    grown = MemoryGrowth()
    with grown:
        params = nn.tree_cast(params_from_numpy(numpy_params(
            zoo_parity_config(cfg), ZOO_SEED, DRAW_CHUNK), "cuda"),
            getattr(torch, cfg.param_dtype))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in train_batch(
        cfg, TRAIN_SEED, BF16_TRAIN_BATCH).items()}
    model = get_model(cfg)
    opt = adamw(warmup_cosine(*BF16_SCHEDULE),
                moment_dtype=cfg.opt_moment_dtype)
    with grown:
        state = opt.init(params)
    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, per_step = [], [], []
    counter = FlopCounterMode(display=False)
    with counting_calls(plain) as plain_calls:
        for i in range(BF16_TRAIN_STEPS):
            _reset_launches(flash, bwd)
            t0 = time.perf_counter()
            # phase 21 (b): the first step's FLOPs as the card ran it
            with counter if i == 0 else contextlib.nullcontext():
                params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_step.append({**dict(flash.launches_by_kernel),
                             **dict(bwd.launches_by_kernel)})
    peak_bytes = torch.cuda.max_memory_allocated()
    peak_gb = peak_bytes / 2**30
    # a bf16 step's backward takes the tensor-core pair, and no SIMT kernel
    want = {"simt": 0, "prefill_wgmma": L, "decode_split": 0, "bwd_dq": 0,
            "bwd_dkdv": 0, "bwd_dq_wgmma": L, "bwd_dkdv_wgmma": L}
    print(f"phase 19 (c) {ZOO_ARCH} bf16 train (B, S) = {BF16_TRAIN_BATCH}: "
          f"losses {losses}; step walls {[round(w, 6) for w in walls]} s; "
          f"#6 launches a step {per_step[0]} (want {want}); plain calls "
          f"{plain_calls}; peak memory {peak_gb:.3f} GiB", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 training: losses {losses} are not "
                             "finite and falling")
    if any(c != want for c in per_step) or any(plain_calls.values()):
        raise AssertionError(f"bf16 training launched {per_step}, plain "
                             f"{plain_calls}; want {want} a step")

    def one_step():
        nonlocal params, state
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()

    busy = _busy(one_step, f"{ZOO_ARCH} bf16 train step")
    bwd_ms = sum(ms for name, ms in busy.get("device_ms_by_name", {}).items()
                 if any(k in name for k in FLASH_BWD_KERNELS.values()))
    fwd_ms = sum(ms for name, ms in busy.get("device_ms_by_name", {}).items()
                 if FLASH_KERNELS["prefill_wgmma"] in name)
    out = {"losses": losses, "step_walls_s": walls,
           "step_wall_s": statistics.median(walls[1:]),
           "launches_per_step": per_step[0], "peak_memory_gib": peak_gb,
           "busy_ms": busy["busy_ms"], "idle_share": busy["idle_share"],
           "profiled_wall_s": busy["wall_s"],
           "flash_bwd_device_ms_per_step": bwd_ms,
           "flash_fwd_device_ms_per_step": fwd_ms,
           **dryrun_readings(grown, counter, peak_bytes)}
    print(f"phase 19 (c): step wall {out['step_wall_s']:.6f} s (median of "
          f"steps 2-{BF16_TRAIN_STEPS}); profiled step busy "
          f"{busy['busy_ms']} ms, idle share {busy['idle_share']}; #6's "
          f"backward {bwd_ms:.6f} ms and forward {fwd_ms:.6f} ms of device "
          f"a step", flush=True)
    return out


def local_train_runs(flash, bwd) -> dict:
    """Phase 19 (d): ``launch/train.py``'s ``train_local`` on the card for
    each of ``ZOO_TRAIN_ARCHS`` reduced (``LOCAL_TRAIN``): every loss
    finite, #6 launched and both kernels of the backward's route for the
    reduced config's dtype and head dim (``bwd_kernel_for``).  Then reduced tinyllama's
    trained params through ``checkpoint.save`` and ``load``: the restored
    params' ``Engine.generate`` gives the same tokens and logits as the
    in-memory params'."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.launch.train import train_local
    from repro_torch.serving.engine import Engine
    from repro_torch.training import checkpoint

    steps, batch, seq, lr = LOCAL_TRAIN
    runs = {}
    for arch in ZOO_TRAIN_ARCHS:
        _reset_launches(flash, bwd)
        t0 = time.perf_counter()
        res = train_local(arch, steps, batch, seq, lr, log_every=0,
                          device="cuda")
        torch.cuda.synchronize()
        runs[arch] = {"losses": res["losses"],
                      "wall_s": time.perf_counter() - t0,
                      "flash_launches": flash.launches,
                      "bwd_launches": dict(bwd.launches_by_kernel)}
        rcfg = get_config(arch).reduced()
        route = flash_kernel.BWD_ROUTES[flash_kernel.bwd_kernel_for(
            rcfg.resolved_head_dim, getattr(torch, rcfg.dtype))]
        runs[arch]["bwd_route"] = route
        print(f"phase 19 (d) train_local {arch} reduced: {runs[arch]}",
              flush=True)
        if not all(np.isfinite(res["losses"])) or not flash.launches or (
                not all(bwd.launches_by_kernel[n] for n in route)):
            raise AssertionError(f"train_local {arch}: {runs[arch]}")
        if arch == ZOO_ARCH:
            trained = res["params"]
        del res
    cfg = get_config(ZOO_ARCH).reduced()
    prompts = zoo_prompts(cfg, ZOO_SEED, (2, 16))
    with tempfile.TemporaryDirectory() as d:
        h = checkpoint.save(f"{d}/final", trained, step=steps)
        restored = checkpoint.load(h.path, device="cuda")
    outs = []
    for params in (trained, restored):
        engine = Engine(cfg, params, max_len=24, device="cuda")
        logits = record_logits(engine)
        tokens, _ = engine.generate(prompts, 8)
        outs.append((tokens, np.stack(logits)))
    same = (np.array_equal(outs[0][0], outs[1][0])
            and np.array_equal(outs[0][1], outs[1][1]))
    print(f"phase 19 (d) checkpoint of reduced {ZOO_ARCH}: {h.nbytes} "
          f"bytes; the restored params generate "
          f"{'the same tokens and logits' if same else 'OTHER OUTPUTS'}",
          flush=True)
    if not same:
        raise AssertionError("a checkpoint's restored params serve "
                             "otherwise than the trained ones")
    return {"runs": runs, "checkpoint_nbytes": h.nbytes}


def zoo_train_phase(flash, bwd, plain: dict) -> dict:
    """Phase 19: the transformer zoo's training on the card.  (a) #6's
    backward against its plain version (``flash_backward_phase``, run in
    phase 3); (b) ``ZOO_ARCH`` at full width and depth in float32 against
    ``TRAIN_FIXTURE`` (``run_train_parity``, ``check_train_parity``),
    #6's SIMT forward and its backward's two kernels once a layer and
    step; (c) ``bf16_train_run``; (d) ``local_train_runs``.  Returns the
    numbers."""
    import torch

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    L = get_config(ZOO_ARCH).n_layers
    fx = load_fixture(TRAIN_FIXTURE)
    if str(fx["arch"]) != ZOO_ARCH or bool(fx["reduced"]):
        raise AssertionError(f"{TRAIN_FIXTURE} is not the full-width "
                             f"{ZOO_ARCH} training fixture")
    _reset_launches(flash, bwd)
    t0 = time.perf_counter()
    with counting_calls(plain) as plain_calls:
        got = run_train_parity(fx, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = int(fx["steps"])
    launches = {**dict(flash.launches_by_kernel),
                **dict(bwd.launches_by_kernel)}
    # float32 takes the SIMT backward pair, and none of the tensor-core one
    want = {"simt": steps * L, "prefill_wgmma": 0, "decode_split": 0,
            "bwd_dq": steps * L, "bwd_dkdv": steps * L, "bwd_dq_wgmma": 0,
            "bwd_dkdv_wgmma": 0}
    readings = check_train_parity(fx, got)
    print(f"phase 19 (b) {ZOO_ARCH} float32 train parity, (B, S) = "
          f"{tuple(int(n) for n in fx['batch_shape'])}, {steps} steps in "
          f"{wall:.3f} s: {readings} (gates: losses {TRAIN_LOSS_ATOL}, "
          f"norms {TRAIN_NORM_RTOL} relative, samples {TRAIN_SAMPLE_RTOL} "
          f"of the leaf's rms); launches {launches} (want {want}); plain "
          f"calls {plain_calls}", flush=True)
    if launches != want or any(plain_calls.values()):
        raise AssertionError(f"float32 training launched {launches}, plain "
                             f"{plain_calls}; want {want}")
    del got
    torch.cuda.empty_cache()
    out = {"parity": readings, "parity_launches": launches,
           "parity_wall_s": wall,
           "bf16": bf16_train_run(flash, bwd, plain)}
    torch.cuda.empty_cache()
    out["local"] = local_train_runs(flash, bwd)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 19 (zoo training): {out['wall_s']:.3f} s", flush=True)
    return out


def _split_bound(nbytes, tc, f32, own_bytes, design_bytes, part):
    """The bound of a call whose work ``_tc_bound`` prices from
    ``nbytes`` (each of its inputs read once, each output written once)
    and its kernels' products ``tc`` (once; three times over in 3xTF32)
    and CUDA-core operations ``f32``, by kernel.  ``part`` None gives the
    call's; a kernel's is the call's bound split by the call's limiting
    side: by ``own_bytes[part]``, the call's inputs and outputs that the
    kernel is charged with, when bytes bound the call, else by its own
    operations' time, so that the kernels' bounds add up to the call's.
    ``part`` "design:<kernel>" gives that kernel's own floor, with the
    boundary-state scratch it writes or reads (``design_bytes``), which
    the function does not need."""
    call_ms, by = _tc_bound(nbytes, 3 * sum(tc.values()), sum(f32.values()))
    if part is None:
        return call_ms, by
    if part.startswith("design:"):
        k = part.split(":", 1)[1]
        return _tc_bound(design_bytes[k], 3 * tc[k], f32[k])
    if by == "bytes":
        return call_ms * own_bytes[part] / nbytes, by

    def ops_s(k):
        return 3 * tc[k] / PEAK_TF32_FLOP_PER_S + f32[k] / PEAK_F32_FLOP_PER_S

    return call_ms * ops_s(part) / sum(ops_s(k) for k in tc), by


def _wkv_bwd_bound(B, T, H, N, state_in, dstate_in, part=None, chunk=16):
    """Bound of one WKV backward at (B,T,H,N), float32, by the kernels'
    chunked form in chunks of ``chunk`` steps (``_split_bound``: the call,
    a kernel's share of it, or a kernel's own floor).  Bytes: the call
    reads r, k, v, w, dy and writes dr, dk, dv, dw once, u and du once,
    state0 and dstate0 when a state is given, dstate when given; "bounds"
    is charged with r, k, v, w, dy, the states and dstate0, "chunk" with
    u, dr, dk, dv, dw and du.  Its own floor adds the boundary states and
    gradients (2 B H chunks N^2) that "bounds" writes and "chunk" reads,
    and "chunk"'s second read of r, k, v, w, dy and its du a chunk.
    Operations: the products, three times over (3xTF32) at the TF32 rate
    ("bounds": k~^T V and r~^T dY, C N^2 a chunk each; "chunk": dY S_b^T,
    V G_e^T and k~ G_e, C N^2 each, dY V^T and A^T dY, C^2 N each); on the
    CUDA cores at the float32 rate the decays and carries ("bounds": 4 C N
    + 4 N^2 a chunk) and the pairs s < t ("chunk": 14 a pair and column,
    A's running products and the recurrences of dr, dk and dw, 16 C N for
    the steps' own terms, 2 N^2 for rowsum(G_e . S_b))."""
    chunks = -(-T // chunk)
    bhc = B * H * chunks
    steps, state = B * T * H * N, B * H * N * N
    states = (2 * state if state_in else 0) + (state if dstate_in else 0)
    scratch = 2 * bhc * N * N
    pairs = chunk * (chunk - 1) // 2
    tc = {"bounds": 2 * 2 * bhc * chunk * N * N,
          "chunk": 2 * bhc * (3 * chunk * N * N + 2 * chunk * chunk * N)}
    f32 = {"bounds": bhc * (4 * chunk * N + 4 * N * N),
           "chunk": bhc * (14 * pairs * N + 16 * chunk * N + 2 * N * N)}
    own = {"bounds": 4 * (5 * steps + states),
           "chunk": 4 * (4 * steps + 2 * H * N)}
    design = {"bounds": own["bounds"] + 4 * scratch,
              "chunk": 4 * (5 * steps + H * N + scratch + 4 * steps
                            + B * chunks * H * N)}
    return _split_bound(sum(own.values()), tc, f32, own, design, part)


def _ssm_bwd_bound(B, T, H, P, N, state_in, dstate_in, part=None,
                   chunk=64):
    """Bound of one selective-scan backward at (B,T,H,P,N), float32, by
    the kernels' chunked SSD form in chunks of ``chunk`` steps
    (``_split_bound``).  Bytes: the call reads x, dy, b, c, dt, a, d and
    writes dx, db, dc, ddt, da, dd once, state0 and dstate0 when a state
    is given, dstate when given; "bounds" is charged with x, dy, b, c, dt,
    a, the states and dstate0, "chunk" with d, dx, db, dc, ddt, da and
    dd.  Its own floor adds the boundary states and gradients (2 B H
    chunks P N) that "bounds" writes and "chunk" reads, "chunk"'s second
    read of x, dy, b, c, dt, a, and each head's db and dc (2 B T H N) and
    da, dd a chunk that it writes.  Operations: the products, three times
    over (3xTF32) at the TF32 rate ("bounds": (w X)^T B and (e dY)^T C, C
    P N a chunk each; "chunk": C B^T, dG B and dG^T C on the C(C+1)/2
    pairs s <= t, N each, dY X^T and M^T dY, P each; (w B) dh_e^T, (e dY)
    h_b and X dh_e, C P N each); on the CUDA cores at the float32 rate the
    decays and carries ("bounds": 2 C P + 2 P N a chunk) and the pairs
    ("chunk": 10 a pair s <= t for M, dG, Q and their sums, 4 P N for
    <dh_e, h_b> and dy . x)."""
    chunks = -(-T // chunk)
    bhc = B * H * chunks
    lower = chunk * (chunk + 1) // 2
    rows, state = B * T * H * P, B * H * P * N
    states = (2 * state if state_in else 0) + (state if dstate_in else 0)
    scratch = 2 * bhc * P * N
    tc = {"bounds": 2 * 2 * bhc * chunk * P * N,
          "chunk": 2 * bhc * (lower * (3 * N + 2 * P) + 3 * chunk * P * N)}
    f32 = {"bounds": bhc * (2 * chunk * P + 2 * P * N),
           "chunk": bhc * (10 * lower + 4 * P * N)}
    own = {"bounds": 4 * (2 * rows + 2 * B * T * N + B * T * H + H
                          + states),
           "chunk": 4 * (rows + 2 * B * T * N + B * T * H + 3 * H)}
    design = {"bounds": own["bounds"] + 4 * scratch,
              "chunk": 4 * (2 * rows + 2 * B * T * N + B * T * H + 2 * H
                            + scratch + rows + 2 * B * T * H * N + B * T * H
                            + 2 * B * chunks * H)}
    return _split_bound(sum(own.values()), tc, f32, own, design, part)


def _wkv_bwd_case(shape, seed, state, dstate, dw=None):
    """#7's forward inputs (``_wkv_case``), then dy normal and the final
    state's gradient normal when ``dstate``, else None."""
    import torch

    r, k, v, w, u, s0 = _wkv_case(*shape, seed=seed, state=state, dw=dw)
    rng = np.random.default_rng(seed + 1)
    B, T, H, N = shape
    dy = torch.tensor(rng.standard_normal((B, T, H, N)), dtype=torch.float32,
                      device="cuda")
    ds = (torch.tensor(rng.standard_normal((B, H, N, N)), dtype=torch.float32,
                       device="cuda") if dstate else None)
    return r, k, v, w, u, s0, dy, ds


def _ssm_bwd_case(shape, seed, state, dstate, dt_scale=1.0):
    """#8's forward inputs (``_ssm_case``), then dy normal and the final
    state's gradient normal when ``dstate``, else None."""
    import torch

    x, b, c, dt, a, d, s0 = _ssm_case(*shape, seed=seed, state=state,
                                      dt_scale=dt_scale)
    rng = np.random.default_rng(seed + 1)
    B, T, H, P, N = shape
    dy = torch.tensor(rng.standard_normal((B, T, H, P)), dtype=torch.float32,
                      device="cuda")
    ds = (torch.tensor(rng.standard_normal((B, H, P, N)), dtype=torch.float32,
                       device="cuda") if dstate else None)
    return x, b, c, dt, a, d, s0, dy, ds


def recurrent_backward_phase() -> dict:
    """Phase 20 (a), run in phase 3: the backward of #7
    (``kernel.rwkv6_scan_backward``) at ``WKV_BWD_CASES`` and of #8
    (``kernel.ssm_scan_backward``) at ``SSM_BWD_CASES`` against their plain
    versions (``ref.wkv_bwd_ref``, ``ref.selective_scan_bwd_ref``) on the
    same inputs: the training shapes, a ragged T (no multiple of the
    kernels' 16-step chunk), with and without state0 and a final state's
    gradient, decays that round to 0, T = 1, a head size past no multiple
    of 4 and the reduced configs' sizes; every gradient within
    ``RECURRENT_BWD_TOL`` of its largest |value|, dstate0 None exactly
    when state0 is; each case run three times, bit for bit.  Then each
    timed at its training shape from a zero state (the model's): CUDA
    events for the call, the profiler's device time of each of its two
    kernels and their sum, the plain version, the bound of the call, its
    split between the two kernels and each kernel's own floor with the
    boundary states it writes or reads; no single PyTorch call computes
    either.  Returns each
    call's row, with its kernels' numbers by name."""
    import torch

    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan import ref as ssm_ref

    specs = (
        ("rwkv6_scan_backward", WKV_BWD_CASES, WKV_TRAIN_SHAPE,
         ("dr", "dk", "dv", "dw", "du", "dstate0"),
         wkv_kernel.rwkv6_scan_backward, wkv_ref.wkv_bwd_ref,
         _wkv_bwd_bound, WKV_BWD_KERNELS,
         lambda shape, seed, st, ds, label: _wkv_bwd_case(
             shape, seed, st, ds, dw=(-6.0, 5.0) if "w = 0" in label
             else None)),
        ("ssm_scan_backward", SSM_BWD_CASES, SSM_TRAIN_SHAPE,
         ("dx", "db", "dc", "ddt", "da", "dd", "dstate0"),
         ssm_kernel.ssm_scan_backward, ssm_ref.selective_scan_bwd_ref,
         _ssm_bwd_bound, SSM_BWD_KERNELS,
         lambda shape, seed, st, ds, label: _ssm_bwd_case(
             shape, seed, st, ds, dt_scale=40.0 if "e = 0" in label
             else 1.0)))
    rows = {}
    for name, cases, train_shape, grads, kern, plain, bound, prof, make in (
            specs):
        max_err, worst_gate, readings = 0.0, 0.0, {}
        for i, (label, (shape, state, dstate)) in enumerate(cases.items()):
            args = make(shape, 1000 + 10 * i, state, dstate, label)
            runs = [kern(*args) for _ in range(3)]
            want = plain(*args)
            torch.cuda.synchronize()
            same = all((a is None and b is None) or torch.equal(a, b)
                       for run in runs[1:] for a, b in zip(runs[0], run))
            errs, ok = {}, same
            for g, got, ref_g in zip(grads, runs[0], want):
                if g == "dstate0" and not state:
                    ok = ok and got is None
                    continue
                scale = float(ref_g.abs().max())
                d = float((got - ref_g).abs().max())
                gate = d / max(RECURRENT_BWD_TOL * scale, 1e-30)
                errs[g] = d
                max_err = max(max_err, d)
                worst_gate = max(worst_gate, gate)
                ok = ok and gate <= 1.0
            readings[label] = {"shape": shape, "state0": state,
                               "dstate": dstate, "max_abs_err": errs}
            print(f"kernel {name} {label} {shape}"
                  f"{' from a state' if state else ''}"
                  f"{' with the final state gradient' if dstate else ''}: "
                  f"max|d| by gradient {errs} (each within "
                  f"{RECURRENT_BWD_TOL} of its largest |value|); 3 runs "
                  f"{'bit-identical' if same else 'DIFFER'} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version or with itself: {label} "
                                     f"{shape}")
            del runs, want, args
        args = make(train_shape, 1999, False, False, "train")
        bound_ms, bound_by = bound(*train_shape, False, False)
        device = _kernel_device_ms(lambda: kern(*args), list(prof.values()),
                                   calls=10)
        numbers = {
            "max_abs_err": max_err, "worst_gate": worst_gate,
            "cases": readings, "shape": train_shape,
            "ms": _median_ms(lambda: kern(*args), n=30, warmup=3),
            "device_ms": (None if None in device.values()
                          else sum(device.values())),
            "device_ms_by_kernel": {k: device[n] for k, n in prof.items()},
            "bound_by_kernel": {k: bound(*train_shape, False, False, part=k)
                                for k in prof},
            "design_bound_by_kernel": {
                k: bound(*train_shape, False, False, part=f"design:{k}")
                for k in prof},
            "plain_ms": _median_ms(lambda: plain(*args), n=3, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        print(f"timing {name} at {train_shape} float32 from a zero state "
              f"(median, CUDA events): kernels {numbers['ms']:.6f} ms "
              f"(device {numbers['device_ms']} ms: "
              + " + ".join(f"{n} {device[n]}" for n in prof.values())
              + f", profiler median of 10), plain "
              f"{numbers['plain_ms']:.6f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}; split by kernel {numbers['bound_by_kernel']}; "
              f"each kernel's own floor with the boundary states "
              f"{numbers['design_bound_by_kernel']}); no "
              f"single PyTorch call computes it", flush=True)
        rows[name] = numbers
        del args
        torch.cuda.empty_cache()
    return rows


def recurrent_bf16_run(arch: str, wrappers: tuple, plain: dict,
                       want: dict) -> dict:
    """Phase 20 (c): ``arch`` at full width and depth in its own dtypes
    (params from the model's init on the card, seeded ``TRAIN_SEED``;
    float32 moments), ``BF16_TRAIN_STEPS`` steps of
    adamw(warmup_cosine(*BF16_SCHEDULE)) on one batch of
    ``BF16_TRAIN_BATCH`` through ``make_train_step``: every loss finite,
    the last below the first, each step's launches by kernel of
    ``wrappers`` exactly ``want`` and no plain version ``plain`` names.
    Then a step's wall (median over steps 2..), the device's busy time and
    idle share over a profiled step, the scans' backward kernels' (both
    of each) and the scans' forward device time in it, and the peak
    memory."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.models.model import get_model
    from repro_torch.training.optimizer import adamw, warmup_cosine
    from repro_torch.training.train_loop import make_train_step

    cfg = get_config(arch)
    model = get_model(cfg)
    grown = MemoryGrowth()
    with grown:
        params = model.init(torch.Generator(device="cuda").manual_seed(
            TRAIN_SEED), "cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in train_batch(
        cfg, TRAIN_SEED, BF16_TRAIN_BATCH).items()}
    opt = adamw(warmup_cosine(*BF16_SCHEDULE),
                moment_dtype=cfg.opt_moment_dtype)
    with grown:
        state = opt.init(params)
    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, per_step = [], [], []
    counter = FlopCounterMode(display=False)
    with counting_calls(plain) as plain_calls:
        for i in range(BF16_TRAIN_STEPS):
            _reset_launches(*wrappers)
            t0 = time.perf_counter()
            # phase 21 (b): the first step's FLOPs as the card ran it
            with counter if i == 0 else contextlib.nullcontext():
                params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_step.append(_by_kernel(wrappers))
    peak_bytes = torch.cuda.max_memory_allocated()
    peak_gb = peak_bytes / 2**30
    print(f"phase 20 (c) {arch} bf16 train (B, S) = {BF16_TRAIN_BATCH}, "
          f"{cfg.n_layers} layers: losses {losses}; step walls "
          f"{[round(w, 6) for w in walls]} s; launches a step "
          f"{per_step[0]} (want {want}); plain calls {plain_calls}; peak "
          f"memory {peak_gb:.3f} GiB", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} bf16 training: losses {losses} are "
                             "not finite and falling")
    if any(c != want for c in per_step) or any(plain_calls.values()):
        raise AssertionError(f"{arch} bf16 training launched {per_step}, "
                             f"plain {plain_calls}; want {want} a step")

    def one_step():
        nonlocal params, state
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()

    busy = _busy(one_step, f"{arch} bf16 train step")
    by_name = busy.get("device_ms_by_name", {})

    def device_ms(*names):
        return sum(ms for n, ms in by_name.items()
                   if any(k in n for k in names))

    bwd_ms = device_ms(*WKV_BWD_KERNELS.values(), *SSM_BWD_KERNELS.values())
    out = {"layers": cfg.n_layers, "losses": losses, "step_walls_s": walls,
           "step_wall_s": statistics.median(walls[1:]),
           "launches_per_step": per_step[0], "peak_memory_gib": peak_gb,
           "busy_ms": busy["busy_ms"], "idle_share": busy["idle_share"],
           "profiled_wall_s": busy["wall_s"],
           "scan_bwd_device_ms_per_step": bwd_ms,
           "scan_fwd_device_ms_per_step": device_ms(
               *WKV_KERNELS.values(), *SSM_KERNELS.values()),
           "flash_device_ms_per_step": device_ms(
               *FLASH_KERNELS.values(), *FLASH_BWD_KERNELS.values()),
           "scan_bwd_share_of_busy": (bwd_ms / busy["busy_ms"]
                                      if busy["busy_ms"] else None),
           **dryrun_readings(grown, counter, peak_bytes)}
    print(f"phase 20 (c) {arch}: step wall {out['step_wall_s']:.6f} s "
          f"(median of steps 2-{BF16_TRAIN_STEPS}); profiled step busy "
          f"{busy['busy_ms']} ms, idle share {busy['idle_share']}; the scan "
          f"backward {bwd_ms:.6f} ms of device a step (share of busy "
          f"{out['scan_bwd_share_of_busy']}), the scan forward "
          f"{out['scan_fwd_device_ms_per_step']:.6f} ms, #6 and its "
          f"backward {out['flash_device_ms_per_step']:.6f} ms", flush=True)
    return out


def recurrent_train_phase(wrappers: tuple, plain: dict) -> dict:
    """Phase 20: RWKV6's and Zamba2's training on the card, ``wrappers``
    the forward and backward of #7, #8 and #6 (rwkv6_scan,
    rwkv6_scan_backward, ssm_scan, ssm_scan_backward, flash_attention,
    flash_attention_backward).  (a) in phase 3
    (``recurrent_backward_phase``); (b) each of ``RECURRENT_TRAIN`` at full
    width and its fixture's depth in float32 against the fixture
    (``run_train_parity``, ``check_train_parity``): every WKV or Mamba
    layer's scan in #7's or #8's chunked forward and each of its
    backward's two kernels once a step, every application of Zamba2's
    shared block in #6's SIMT forward and backward pair, nothing else of
    them and no plain version;
    (c) ``recurrent_bf16_run`` of each; (d) ``train_local`` of each
    reduced, every kernel of its path launched.  Returns the numbers."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_local
    from repro_torch.models import hybrid_arch

    wkv, wkv_bwd, ssm, ssm_bwd, flash, flash_bwd = wrappers
    t_phase = time.perf_counter()

    def launches(arch, L, steps, flash_route):
        """The launches by kernel of ``steps`` steps of ``arch`` at ``L``
        layers: each scan's chunked forward and each of its backward's two
        kernels once a layer, #6 and its backward's ``flash_route`` once a
        shared block."""
        cfg = get_config(arch).replace(n_layers=L)
        want = _by_kernel(wrappers)
        for counts in want.values():
            counts.update(dict.fromkeys(counts, 0))
        scan, scan_bwd = (wkv, wkv_bwd) if arch == RWKV_ARCH else (ssm,
                                                                   ssm_bwd)
        want[scan.__name__]["chunked"] = steps * L
        want[scan_bwd.__name__].update(dict.fromkeys(
            want[scan_bwd.__name__], steps * L))
        if arch == RWKV_ARCH:
            return want
        n_super = hybrid_arch._split(cfg)[1]
        fwd, (dq, dkdv) = flash_route
        want[flash.__name__][fwd] = steps * n_super
        want[flash_bwd.__name__][dq] = want[flash_bwd.__name__][dkdv] = (
            steps * n_super)
        return want

    out = {"parity": {}, "bf16": {}, "local": {}}
    for arch, (path, depth) in RECURRENT_TRAIN.items():
        fx = load_fixture(path)
        if (str(fx["arch"]) != arch or bool(fx["reduced"])
                or int(fx["parity_n_layers"]) != depth):
            raise AssertionError(f"{path} is not the full-width {arch} "
                                 f"training fixture at {depth} layers")
        _reset_launches(*wrappers)
        t0 = time.perf_counter()
        with counting_calls(plain) as plain_calls:
            got = run_train_parity(fx, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _by_kernel(wrappers)
        want = launches(arch, depth, int(fx["steps"]),
                        ("simt", ("bwd_dq", "bwd_dkdv")))
        readings = check_train_parity(fx, got)
        print(f"phase 20 (b) {arch} float32 train parity at {depth} layers, "
              f"(B, S) = {tuple(int(n) for n in fx['batch_shape'])}, "
              f"{int(fx['steps'])} steps in {wall:.3f} s: {readings} (gates: "
              f"losses {TRAIN_LOSS_ATOL}, norms {TRAIN_NORM_RTOL} relative, "
              f"samples {TRAIN_SAMPLE_RTOL} of the leaf's rms); launches "
              f"{counts} (want {want}); plain calls {plain_calls}",
              flush=True)
        if counts != want or any(plain_calls.values()):
            raise AssertionError(f"{arch} float32 training launched "
                                 f"{counts}, plain {plain_calls}; want "
                                 f"{want}")
        out["parity"][arch] = {"readings": readings, "launches": counts,
                               "wall_s": wall, "layers": depth}
        del got
        torch.cuda.empty_cache()
    for arch in RECURRENT_ARCHS:
        L = get_config(arch).n_layers
        want = launches(arch, L, 1, ("prefill_wgmma", ("bwd_dq_wgmma",
                                                       "bwd_dkdv_wgmma")))
        out["bf16"][arch] = recurrent_bf16_run(arch, wrappers, plain, want)
        gc.collect()
        torch.cuda.empty_cache()
    steps, batch, seq, lr = LOCAL_TRAIN
    for arch in RECURRENT_ARCHS:
        _reset_launches(*wrappers)
        t0 = time.perf_counter()
        res = train_local(arch, steps, batch, seq, lr, log_every=0,
                          device="cuda")
        torch.cuda.synchronize()
        run = {"losses": res["losses"], "wall_s": time.perf_counter() - t0,
               "launches": _by_kernel(wrappers)}
        print(f"phase 20 (d) train_local {arch} reduced: {run}", flush=True)
        used = (wkv, wkv_bwd) if arch == RWKV_ARCH else (
            ssm, ssm_bwd, flash, flash_bwd)
        if not all(np.isfinite(res["losses"])) or not all(
                w.launches for w in used):
            raise AssertionError(f"train_local {arch}: {run}")
        out["local"][arch] = run
        del res
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 20 (recurrent training): {out['wall_s']:.3f} s",
          flush=True)
    return out


class MemoryGrowth:
    """The caching allocator's growth summed over the blocks run under it
    (phase 21 (a): the params and the optimizer's state as the card holds
    them): ``allocated``, ``memory_allocated``'s (blocks, rounded), and
    ``requested``, the bytes the tensors asked for."""

    def __init__(self):
        self.allocated = self.requested = 0

    @staticmethod
    def _now():
        import torch

        # the stats are empty until the allocator's first allocation
        return (torch.cuda.memory_allocated(), torch.cuda.memory_stats().get(
            "requested_bytes.all.current", 0))

    def __enter__(self):
        self._start = self._now()
        return self

    def __exit__(self, *exc):
        end = self._now()
        self.allocated += end[0] - self._start[0]
        self.requested += end[1] - self._start[1]
        return False


def alloc_rounding(tensors) -> int:
    """The most the caching allocator adds to these tensors' bytes in
    ``memory_allocated``: each block rounded up to ``ALLOC_ROUND``, and a
    block over ``ALLOC_SMALL`` taking the rest of its segment when that rest
    is ``ALLOC_SMALL`` or less (the allocator splits only a larger rest)."""
    return sum(ALLOC_ROUND + (ALLOC_SMALL if t.nbytes > ALLOC_SMALL else 0)
               for t in tensors)


def dryrun_readings(grown: MemoryGrowth, counter, peak_bytes: int) -> dict:
    """What phase 21 holds the dry run to, from a bf16 run: the params'
    and AdamW state's bytes on the card (allocated and requested), the
    first step's FLOPs by ``FlopCounterMode`` and the run's peak
    memory."""
    return {"param_opt_bytes": grown.allocated,
            "param_opt_requested_bytes": grown.requested,
            "step1_flops": int(counter.get_total_flops()),
            "peak_memory_bytes": int(peak_bytes)}


def dryrun_phase(bf16_runs: dict, smi: str) -> dict:
    """Phase 21: each arch of ``bf16_runs`` (phases 19 (c) and 20 (c):
    arch -> its run's numbers) traced on meta by ``dryrun.run_one`` at its
    ``BF16_TRAIN_BATCH`` step, without running the step again.  (a) the
    trace's params and optimizer state bytes equal the bytes the card's
    tensors requested from the caching allocator, and its
    ``memory_allocated`` growth up to the allocator's rounding
    (``alloc_rounding``); (b) the trace's FLOPs outside the port's
    kernels equal ``FlopCounterMode``'s count of the card's first step.
    Printed, no gate: (c) the trace's peak over the run's
    ``max_memory_allocated``; (d) ``model_flops`` over the busy device
    time at ``H100.peak_flops_bf16``, beside ``smi``."""
    import torch

    from repro_torch.configs import H100, InputShape, get_config
    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.steps import param_opt_specs

    t_phase = time.perf_counter()
    B, S = BF16_TRAIN_BATCH
    shape = InputShape(f"train_{B}x{S}", S, B, "train")
    out = {}
    for arch, run in bf16_runs.items():
        cfg = get_config(arch)
        rec = run_one(arch, shape, remat=cfg.remat)
        mem, summ = rec["memory"], rec["step_summary"]
        meta_bytes = mem["params_bytes"] + mem["opt_state_bytes"]
        params, opt_state, _ = param_opt_specs(cfg)
        tensors = [t for t in torch.utils._pytree.tree_leaves(
            (params, opt_state)) if isinstance(t, torch.Tensor)]
        rounding = alloc_rounding(tensors)
        slack = run["param_opt_bytes"] - meta_bytes
        mfu = rec["roofline"]["model_flops"] / (
            run["busy_ms"] / 1e3 * H100.peak_flops_bf16)
        got = {"param_opt_bytes_meta": meta_bytes,
               "param_opt_bytes_card": run["param_opt_bytes"],
               "param_opt_requested_bytes_card": run[
                   "param_opt_requested_bytes"],
               "rounding_bytes": slack, "rounding_bound_bytes": rounding,
               "tensors": len(tensors),
               "aten_flops_meta": summ["aten_flops"],
               "kernel_flops_meta": summ["kernel_flops"],
               "flops_card": run["step1_flops"],
               "peak_bytes_meta": mem["peak_bytes"],
               "peak_bytes_card": run["peak_memory_bytes"],
               "peak_ratio": mem["peak_bytes"] / run["peak_memory_bytes"],
               "model_flops": rec["roofline"]["model_flops"],
               "busy_ms": run["busy_ms"], "mfu": mfu,
               "roofline": rec["roofline"], "t_trace_s": rec["t_trace_s"]}
        out[arch] = got
        print(f"phase 21 {arch} {shape.name}: (a) params + AdamW "
              f"{meta_bytes} B traced, {run['param_opt_requested_bytes']} B "
              f"requested and {run['param_opt_bytes']} B allocated on the "
              f"card ({slack} B of rounding over {len(tensors)} tensors, "
              f"at most {rounding}); (b) FLOPs outside the kernels "
              f"{summ['aten_flops']:.6e} traced, {run['step1_flops']:.6e} "
              f"counted on the card (the kernels' {summ['kernel_flops']:.6e}"
              f" by their formulas); (c) peak {mem['peak_bytes']} B traced "
              f"/ {run['peak_memory_bytes']} B max_memory_allocated = "
              f"{got['peak_ratio']:.4f}; (d) model_flops "
              f"{got['model_flops']:.6e} / ({run['busy_ms']:.3f} ms busy x "
              f"{H100.peak_flops_bf16:.3e}) = {mfu:.4f} on {smi}; traced in "
              f"{rec['t_trace_s']:.3f} s", flush=True)
        if (run["param_opt_requested_bytes"] != meta_bytes
                or not 0 <= slack < rounding):
            raise AssertionError(f"{arch}: the dry run's params and AdamW "
                                 f"state ({meta_bytes} B) miss the card's "
                                 f"{run['param_opt_requested_bytes']} B "
                                 f"requested, {run['param_opt_bytes']} B "
                                 f"allocated")
        if summ["aten_flops"] != run["step1_flops"]:
            raise AssertionError(f"{arch}: the dry run counts "
                                 f"{summ['aten_flops']} FLOPs outside the "
                                 f"kernels, the card's step "
                                 f"{run['step1_flops']}")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 21 (dry run): {out['wall_s']:.3f} s", flush=True)
    return out


def recurrent_plain() -> dict:
    """Every plain version on phase 20's paths, for ``counting_calls``:
    the attention's (as phase 8's) and #6's backward's, and each scan's
    forward and backward, in the kernels' ``ref`` and in the models."""
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
    from repro_torch.kernels.ssm_scan import ref as ssm_ref
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import rwkv as rwkv_mod
    from repro_torch.models import ssm as ssm_mod

    return {"scan": (attention_mod, "_attend_chunked"),
            "oracle": (flash_ref, "attend_full_ref"),
            "bwd_oracle": (flash_ref, "flash_attend_bwd_ref"),
            "wkv_oracle": (wkv_ref, "wkv_ref"),
            "wkv_oracle_flat": (wkv_ref, "rwkv6_scan_ref"),
            "wkv_stepwise": (rwkv_mod, "wkv_stepwise"),
            "wkv_chunked": (rwkv_mod, "wkv_chunked"),
            "wkv_bwd_oracle": (wkv_ref, "wkv_bwd_ref"),
            "ssd_stepwise": (ssm_mod, "ssd_stepwise"),
            "ssm_oracle": (ssm_ref, "selective_scan_ref"),
            "ssm_oracle_flat": (ssm_ref, "ssm_scan_ref"),
            "ssm_bwd_oracle": (ssm_ref, "selective_scan_bwd_ref")}


def recurrent_alone() -> dict:
    """Phase 20 on its own, for a run on the card that needs nothing else:
    builds the libraries of #6, #7 and #8 and their backwards, then
    ``recurrent_backward_phase`` and ``recurrent_train_phase``.  Returns
    both's numbers."""
    import torch

    _import_port()
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(_build.build_all({**flash_kernel.LIBRARIES,
                            **wkv_kernel.LIBRARIES,
                            **ssm_kernel.LIBRARIES}), flush=True)
    rows = recurrent_backward_phase()
    wrappers = (wkv_kernel.rwkv6_scan, wkv_kernel.rwkv6_scan_backward,
                ssm_kernel.ssm_scan, ssm_kernel.ssm_scan_backward,
                flash_kernel.flash_attention,
                flash_kernel.flash_attention_backward)
    return {"rows": rows,
            "train": recurrent_train_phase(wrappers, recurrent_plain())}


def calibrated_phase(wrappers: tuple, others: tuple, smi: str) -> dict:
    """Phase 22: (a) the launcher's calibrated mode (``CALIBRATED_RUNS``)
    and one ``launch.calibrate`` of its own, (b) the legacy fit from the
    reference's draws, then its wall, busy device time and idle share
    beside a compiled fit of the same window.  ``wrappers`` are the LSTM
    kernels #1-#4, whose launches each run is held to; ``others`` may not
    launch at all.  Returns the launches by run and the readings."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import lstm_forecaster
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.launch import calibrate as calibrate_mod
    from repro_torch.launch import edge_cloud
    from repro_torch.runtime import (
        ALL_DEPLOYMENTS,
        EdgeCloudSimulation,
        paper_topology,
    )

    def counted(label: str, want: dict) -> dict:
        launches = {w.__name__: w.launches for w in wrappers}
        stray = {w.__name__: w.launches for w in others if w.launches}
        print(f"calibrated phase, {label}: launches {launches}, expected "
              f"{want}", flush=True)
        if launches != want or stray:
            raise AssertionError(f"{label}: launches {launches} and {stray}"
                                 f", expected {want} and no other kernel")
        return launches

    t_phase = time.perf_counter()
    out: dict = {"launches": {}, "runs": {}}
    # (a) the launcher's default mode, each run calibrating on the card
    for label, flags in CALIBRATED_RUNS.items():
        args = edge_cloud.parse_args(flags)
        _reset_launches(*wrappers, *others)
        t0 = time.perf_counter()
        runs = edge_cloud.run_calibrated(args, device="cuda")
        wall = time.perf_counter() - t0
        out["launches"][f"calibrated_{label}"] = counted(
            f"run_calibrated {' '.join(flags)}",
            expected_calibration_launches(10 if args.fast else 100))
        check_calibrated_runs(runs, args.quantized, args.windows)
        out["runs"][label] = {
            "wall_s": wall, "failures": {d: len(r.failures)
                                         for d, r in runs.items()},
            "table3": {d: r.table3() for d, r in runs.items()}}
        print(f"calibrated phase, {label}: 3 deployments in {wall:.3f} s, "
              f"edge-centric {len(runs['edge-centric'].failures)} OOM "
              f"failures, every message of the reference's bytes, the "
              f"Table-3 orderings hold", flush=True)

    # one CostModel: the reference's constants, two simulations of it equal
    _reset_launches(*wrappers, *others)
    cal = calibrate_mod.calibrate(fast=True, device="cuda")
    out["launches"]["calibrate_fast"] = counted(
        "calibrate(fast=True)", expected_calibration_launches(10))
    cost = cal.cost
    got = {k: getattr(cost, k) for k in CALIBRATED_CONSTANTS}
    if got != CALIBRATED_CONSTANTS:
        raise AssertionError(f"calibrated constants {got}, the reference's "
                             f"{CALIBRATED_CONSTANTS}")
    times = {k: cal.details[k] for k in ("t_train_s", "t_infer_s", "t_dwa_s")}
    measured = {k: getattr(cost, k) for k in (
        "batch_infer_s", "speed_infer_s", "hybrid_combine_s",
        "weight_solve_s", "speed_train_s")}
    print(f"calibrated phase: calibrate(fast=True) on {smi}: {times}; "
          f"cost {measured}", flush=True)
    if min(*times.values(), *measured.values()) <= 0:
        raise AssertionError(f"a calibrated time is not above 0: {times}, "
                             f"{measured}")

    def simulate(name: str, dynamic: bool = True):
        return EdgeCloudSimulation(
            ALL_DEPLOYMENTS[name](), paper_topology(), cost,
            dynamic_weighting=dynamic).run(CALIBRATED_WINDOWS)

    for name in ALL_DEPLOYMENTS:
        a, b = simulate(name), simulate(name)
        logs = bus_columns(a.message_log), bus_columns(b.message_log)
        if a.table3() != b.table3() or a.failures != b.failures or not all(
                np.array_equal(logs[0][k], logs[1][k]) for k in logs[0]):
            raise AssertionError(f"{name}: two simulations of one CostModel "
                                 "differ")
    dyn, stat = (simulate("edge-cloud-integrated", d).table3()[
        "hybrid_inference"]["computation"] for d in (True, False))
    print(f"calibrated phase: two simulations of one CostModel equal in "
          f"every deployment; integrated hybrid_inference computation "
          f"dynamic {dyn:.6g} s > static {stat:.6g} s", flush=True)
    if not dyn > stat:
        raise AssertionError("dynamic weighting is not dearer than static")
    out["calibration"] = {"details": cal.details, "cost": measured,
                          "hybrid_inference_dynamic_s": dyn,
                          "hybrid_inference_static_s": stat}

    # (b) the legacy fit from the reference's draws
    fx = load_fixture(LEGACY_FIXTURE)
    setup = unflatten(fx, "setup")
    batch_size, epochs = int(setup["batch_size"]), int(setup["epochs"])
    want_rows = legacy_batch_rows(len(fx["x"]), batch_size, epochs)
    _reset_launches(*wrappers, *others)
    names = ("lstm_sequence_fwd_train", "lstm_sequence_bwd")
    with recording_rows(lstm_kernel, names) as rows:
        res = run_legacy_fit(fx, "cuda")
    out["launches"]["legacy_fit"] = counted("legacy fit", {
        "lstm_sequence_fused": 0, "lstm_sequence_fwd_train": len(want_rows),
        "lstm_sequence_bwd": len(want_rows), "int8_matmul": 0})
    if any(rows[n] != want_rows for n in names):
        raise AssertionError(f"legacy fit: rows a launch "
                             f"{ {n: sorted(set(r)) for n, r in rows.items()} }"
                             f", expected {sorted(set(want_rows))} in order")
    worst = check_legacy_fit(fx, res, LEGACY_ATOL)
    print(f"calibrated phase: legacy fit from the reference's draws, "
          f"{res.steps} steps (rows {sorted(set(want_rows))}, "
          f"{want_rows.count(min(want_rows))} at {min(want_rows)}), params "
          f"within {worst:.3g} of the reference's (<= {LEGACY_ATOL}), last "
          f"loss {res.history[-1]['loss']:.6g} (reference "
          f"{float(fx['loss']):.6g}); its own wall {res.wall_time_s:.6f} s",
          flush=True)
    # the full fits' walls unprofiled; the profiles cover the first
    # PROFILED_EPOCHS epochs of each (~8,000 device events, the host's
    # operators not traced): 100 epochs took ~56 s of profiling
    eng = lstm_forecaster(get_config("lstm-paper"), epochs=epochs,
                          batch_size=batch_size, device="cuda").engine
    data = {"x": fx["x"], "y": fx["y"]}
    eng.train(data, None, 0)  # warm: the bucket's mask check
    _, compiled_wall = eng.train(data, None, 0)
    t0 = time.perf_counter()
    legacy = _busy(lambda: run_legacy_fit(fx, "cuda", PROFILED_EPOCHS),
                   f"legacy fit, its first {PROFILED_EPOCHS} epochs",
                   cpu=False)
    eng = lstm_forecaster(get_config("lstm-paper"), epochs=PROFILED_EPOCHS,
                          batch_size=batch_size, device="cuda").engine
    eng.train(data, None, 0)
    compiled = _busy(lambda: eng.train(data, None, 0),
                     f"compiled fit of the same window, {PROFILED_EPOCHS} "
                     "epochs (context only)", cpu=False)
    torch.cuda.synchronize()
    print(f"calibrated phase: {epochs} epochs' wall, legacy "
          f"{res.wall_time_s:.6f} s, compiled {compiled_wall:.6f} s; "
          f"{PROFILED_EPOCHS} epochs profiled in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    out["legacy_fit"] = {
        "max_abs_err": worst, "steps": res.steps,
        "rows": sorted(set(want_rows)), "wall_s": res.wall_time_s,
        "compiled_wall_s": compiled_wall, "profiled_epochs": PROFILED_EPOCHS,
        "profiled": {k: v for k, v in legacy.items()
                     if k != "device_ms_by_name"},
        "compiled_profiled": {k: v for k, v in compiled.items()
                              if k != "device_ms_by_name"}}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"calibrated phase: {out['seconds']:.3f} s", flush=True)
    return out


def calibrated_alone() -> dict:
    """Phase 22 on its own, for a run on the card that needs nothing else:
    builds the LSTM and int8 libraries, then ``calibrated_phase``."""
    import torch

    _import_port()
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.int8_matmul import kernel as int8_kernel
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(_build.build_all({**lstm_kernel.LIBRARIES,
                            **int8_kernel.LIBRARIES}), flush=True)
    wrappers = (lstm_kernel.lstm_sequence_fused,
                lstm_kernel.lstm_sequence_fwd_train,
                lstm_kernel.lstm_sequence_bwd, int8_kernel.int8_matmul)
    others = (lstm_kernel.lstm_cell, flash_kernel.flash_attention,
              flash_kernel.flash_attention_backward, wkv_kernel.rwkv6_scan,
              wkv_kernel.rwkv6_scan_backward, ssm_kernel.ssm_scan,
              ssm_kernel.ssm_scan_backward)
    return calibrated_phase(wrappers, others, smi)


def _by_kernel(wrappers) -> dict:
    """Launches by kernel of each wrapper that counts them (flash
    attention's three, the selective scan's two)."""
    return {w.__name__: dict(w.launches_by_kernel) for w in wrappers
            if hasattr(w, "launches_by_kernel")}


def _reset_launches(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0
        if hasattr(w, "launches_by_kernel"):  # flash attention, the scan
            w.launches_by_kernel = dict.fromkeys(w.launches_by_kernel, 0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    # phase 15 runs under torch.use_deterministic_algorithms, which needs
    # cuBLAS's deterministic workspace set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    _import_port()
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import lstm_forecaster
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.int8_matmul import kernel as int8_kernel
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan import ref as ssm_ref
    from repro_torch.launch import edge_cloud
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import hybrid_arch
    from repro_torch.models import rwkv as rwkv_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.runtime.modules import T_MODEL
    from repro_torch.training.optimizer import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {device_name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    print(smi, flush=True)

    # phase 2: every library, one nvcc each, all at once
    t0 = time.perf_counter()
    seconds = _build.build_all({**lstm_kernel.LIBRARIES,
                                **int8_kernel.LIBRARIES,
                                **flash_kernel.LIBRARIES,
                                **wkv_kernel.LIBRARIES,
                                **ssm_kernel.LIBRARIES})
    lstm_kernel.library()
    lstm_kernel.bwd_library()
    lstm_kernel.cell_library()
    int8_kernel.library()
    flash_kernel.library()
    flash_kernel.bwd_library()
    wkv_kernel.library()
    wkv_kernel.bwd_library()
    ssm_kernel.library()
    ssm_kernel.bwd_library()
    print("build: " + ", ".join(f"{lib} {sec:.2f} s"
                                for lib, sec in seconds.items())
          + f" (in parallel, {time.perf_counter() - t0:.2f} s wall)",
          flush=True)
    ptxas = {n: info for n, info in _ptxas_lines(
        _build.LOGS.get("flash_attention", "")).items() if "flash_" in n}
    bwd_ptxas = _ptxas_lines(_build.LOGS.get("flash_backward", ""))
    train_ptxas = {n: info for lib in ("lstm_sequence", "lstm_sequence_bwd")
                   for n, info in _ptxas_lines(_build.LOGS.get(lib, "")).items()
                   if any(k in n for k in (SERVE_FWD_KERNEL, TRAIN_FWD_KERNEL,
                                           *BWD_KERNELS))}
    ssm_ptxas = {n: info for n, info in _ptxas_lines(
        _build.LOGS.get("ssm_scan", "")).items()
        if any(k in n for k in SSM_KERNELS.values())}
    wkv_ptxas = {n: info for n, info in _ptxas_lines(
        _build.LOGS.get("rwkv6_scan", "")).items()
        if any(k in n for k in WKV_KERNELS.values())}
    int8_ptxas = {n: info for n, info in _ptxas_lines(
        _build.LOGS.get("int8_matmul", "")).items()
        if "int8_matmul_kernel" in n}
    cell_ptxas = {n: info for n, info in _ptxas_lines(
        _build.LOGS.get("lstm_cell", "")).items() if CELL_KERNEL in n}
    scan_bwd_ptxas = {lib: {n: info for n, info in _ptxas_lines(
        _build.LOGS.get(lib, "")).items()
        if any(k in n for k in knames.values())}
        for lib, knames in (("rwkv6_backward", WKV_BWD_KERNELS),
                            ("ssm_backward", SSM_BWD_KERNELS))}
    for n, info in {**ptxas, **bwd_ptxas, **train_ptxas, **ssm_ptxas,
                    **wkv_ptxas, **int8_ptxas, **cell_ptxas,
                    **scan_bwd_ptxas["rwkv6_backward"],
                    **scan_bwd_ptxas["ssm_backward"]}.items():
        print(f"build: ptxas {n}: {info}", flush=True)

    # phase 3: the kernels against their plain versions, and timed
    fused = lstm_kernel.lstm_sequence_fused
    fwd_train = lstm_kernel.lstm_sequence_fwd_train
    bwd = lstm_kernel.lstm_sequence_bwd
    int8 = int8_kernel.int8_matmul
    flash = flash_kernel.flash_attention
    wkv = wkv_kernel.rwkv6_scan
    ssm = ssm_kernel.ssm_scan
    cell = lstm_kernel.lstm_cell
    flash_bwd = flash_kernel.flash_attention_backward
    wkv_bwd = wkv_kernel.rwkv6_scan_backward
    ssm_bwd = ssm_kernel.ssm_scan_backward
    wrappers = (fused, fwd_train, bwd, int8)
    rows = {"lstm_sequence_fused": kernel_phase(), **train_kernel_phase(),
            "lstm_cell": cell_kernel_phase(),
            "int8_matmul": int8_kernel_phase(),
            "flash_attention": flash_kernel_phase(),
            # phase 19 (a): #6's backward, beside its forward
            "flash_attention_backward": flash_backward_phase(),
            "rwkv6_scan": wkv_kernel_phase(),
            "ssm_scan": ssm_kernel_phase(),
            # phase 20 (a): #7's and #8's backward
            **recurrent_backward_phase()}
    for kname, names in (("lstm_sequence_fused", [SERVE_FWD_KERNEL]),
                         ("lstm_sequence_fwd_train", [TRAIN_FWD_KERNEL]),
                         ("lstm_sequence_bwd", BWD_KERNELS)):
        rows[kname]["ptxas"] = {n: info for n, info in train_ptxas.items()
                                if any(k in n for k in names)}
    rows["ssm_scan"]["ptxas"] = ssm_ptxas
    rows["rwkv6_scan"]["ptxas"] = wkv_ptxas
    rows["rwkv6_scan_backward"]["ptxas"] = scan_bwd_ptxas["rwkv6_backward"]
    rows["ssm_scan_backward"]["ptxas"] = scan_bwd_ptxas["ssm_backward"]
    rows["int8_matmul"]["ptxas"] = int8_ptxas
    rows["lstm_cell"]["ptxas"] = cell_ptxas

    # phase 4: the serving path
    fx = load_fixture()
    # phase 3 launched the backward kernels: from here they count the paths
    # only, and no serving path may launch one (read after phases 10 and 18)
    _reset_launches(*wrappers, flash, flash_bwd, wkv, ssm, cell, wkv_bwd,
                    ssm_bwd)
    t0 = time.perf_counter()
    results = run_main_path(fx, "cuda")
    wall = time.perf_counter() - t0
    serving_launches = fused.launches
    n_windows = int(fx["setup/n_windows"])
    # window 0 only trains: its 2 eval predicts; every later window adds
    # batch and speed inference
    expected = sum(2 * n_windows + 2 * len(fx[f"records/{m}"]) for m in MODES)
    worst = check_records(fx, results, rtol=1e-4, atol=1e-4)
    for mode, res in results.items():
        for r in res.records:
            print(f"serving path {mode} window {r.window}: batch_infer "
                  f"{1e3 * r.t_batch_infer:.3f} ms, speed_infer "
                  f"{1e3 * r.t_speed_infer:.3f} ms, hybrid_infer "
                  f"{1e3 * r.t_hybrid_infer:.3f} ms")
    print(f"serving path: {len(MODES)} modes in {wall:.3f} s, records match "
          f"the reference (worst relative RMSE error {worst:.3g}); "
          f"lstm_sequence_fused launches {serving_launches}, expected "
          f"{expected}", flush=True)
    if serving_launches != expected or serving_launches == 0:
        raise AssertionError(f"lstm_sequence_fused launched {serving_launches} "
                             f"times on the serving path, expected {expected}")
    if fwd_train.launches or bwd.launches or int8.launches:
        raise AssertionError("the serving path launched a training or an "
                             "int8 kernel")

    # phase 5: the training path
    expected = expected_training_launches(fx)
    _reset_launches(*wrappers)
    t0 = time.perf_counter()
    run = run_training_path(fx, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    training_launches = {w.__name__: w.launches
                         for w in (fused, fwd_train, bwd)}
    worst_param, worst_rmse = check_training_path(
        fx, run, rtol=TRAIN_ATOL, atol=TRAIN_ATOL)
    for mode, res in run["results"].items():
        print(f"training path {mode}: t_speed_train " + ", ".join(
            f"w{r.window} {1e3 * r.t_speed_train:.3f} ms"
            for r in res.records))
    speed_walls = [r.t_speed_train for res in run["results"].values()
                   for r in res.records]
    print(f"training path: pretrain {1e3 * run['batch_wall_s']:.3f} ms; "
          f"speed fit median {1e3 * statistics.median(speed_walls):.3f} ms "
          f"over {len(speed_walls)} fits; {len(MODES)} modes and the "
          f"pretrain in {wall:.3f} s", flush=True)
    print(f"training path: the batch model and every published speed model "
          f"match the reference (largest |dparam| {worst_param:.3g} <= "
          f"{TRAIN_ATOL}), every record matches (worst relative RMSE error "
          f"{worst_rmse:.3g}); launches {training_launches}, expected "
          f"{expected}", flush=True)
    if training_launches != expected or 0 in training_launches.values():
        raise AssertionError(f"training path launches {training_launches}, "
                             f"expected {expected}")
    if int8.launches:
        raise AssertionError("the training path launched the int8 kernel")

    setup = unflatten(fx, "setup")
    eng = lstm_forecaster(get_config("lstm-paper"),
                          epochs=int(setup["speed_epochs"]),
                          batch_size=int(setup["speed_batch_size"]),
                          device="cuda").engine
    data, (init, idx) = port_stream(setup).supervised(0), speed_draws(fx)[0]
    refits = [eng.fit_window(data, params_from_numpy(init, "cuda"),
                             torch.as_tensor(idx.astype(np.int64)))
              for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(
        *(tree_leaves(p) for p in refits)))
    print(f"training path: refit of window 0 from the same draws "
          f"{'bit-identical' if same else 'DIFFERS'}", flush=True)
    if not same:
        raise AssertionError("two fits from the same draws differ")

    # phase 6: the bus path.  (a) float sync, the reference's models
    # replayed in each deployment
    lag = int(setup["lag"])
    _reset_launches(*wrappers)
    t0 = time.perf_counter()
    bus_float = {d: run_bus_replay(fx, "cuda", d) for d in BUS_DEPLOYMENTS}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bus_launches = {"float": {w.__name__: w.launches for w in wrappers}}
    worst = check_bus_float(fx, bus_float, rtol=TRAIN_ATOL, atol=TRAIN_ATOL)
    expected = {"lstm_sequence_fused": 0, "lstm_sequence_fwd_train": 0,
                "lstm_sequence_bwd": 0, "int8_matmul": 0}
    for res in bus_float.values():
        expected["lstm_sequence_fused"] += expected_bus_launches(
            res, False, lag)["lstm_sequence_fused"]
    for dep, res in bus_float.items():
        sizes = sorted({int(m.nbytes) for m in messages(res, T_MODEL)})
        print(f"bus path, float sync, {dep}: e2e {res.mean_e2e_s():.6f} s, "
              f"{len(res.failures)} capacity failures, model-topic bytes "
              f"{sizes}")
    print(f"bus path, float sync: 3 deployments in {wall:.3f} s; integrated "
          f"and cloud-centric reproduce the reference's in-process records "
          f"(worst relative RMSE error {worst:.3g}), edge-centric OOMs every "
          f"window and serves the batch model; launches "
          f"{bus_launches['float']}, expected {expected}", flush=True)
    if bus_launches["float"] != expected:
        raise AssertionError(f"float bus launches {bus_launches['float']}, "
                             f"expected {expected}")

    # (b) int8 sync in the integrated deployment
    _reset_launches(*wrappers)
    t0 = time.perf_counter()
    bus_int8 = run_bus_replay(fx, "cuda", "edge-cloud-integrated",
                              quantized=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bus_launches["int8"] = {w.__name__: w.launches for w in wrappers}
    worst_pred, worst = check_bus_int8(fx, bus_int8, rtol=TRAIN_ATOL)
    expected = {"lstm_sequence_fwd_train": 0, "lstm_sequence_bwd": 0,
                **expected_bus_launches(bus_int8, True, lag)}
    speed_ms = {sync: 1e3 * statistics.median(r.t_speed_infer
                                             for r in res.records)
                for sync, res in (("float", bus_float[
                    "edge-cloud-integrated"]), ("int8", bus_int8))}
    print(f"bus path, integrated: median t_speed_infer float "
          f"{speed_ms['float']:.6f} ms, int8 {speed_ms['int8']:.6f} ms")
    print(f"bus path, int8 sync, integrated: {wall:.3f} s, e2e "
          f"{bus_int8.mean_e2e_s():.6f} s; every publish {INT8_MODEL_NBYTES} "
          f"B (float {FLOAT_MODEL_NBYTES} B) with q and scale bit for bit the "
          f"reference's; int8 predictions within {worst_pred:.3g} of the "
          f"reference's (<= {INT8_PRED_ATOL}); records within {worst:.3g} "
          f"relative; launches {bus_launches['int8']}, expected {expected}",
          flush=True)
    if bus_launches["int8"] != expected or int8.launches == 0:
        raise AssertionError(f"int8 bus launches {bus_launches['int8']}, "
                             f"expected {expected}")

    # (c) the launcher, trained on the card, float and int8 sync
    for path, flag in (("launcher_float", []),
                       ("launcher_int8", ["--quantized"])):
        _reset_launches(*wrappers)
        t0 = time.perf_counter()
        runs = edge_cloud.run_real(edge_cloud.parse_args(
            ["--real", "--deployment", "all", "--fast", "--windows", "6",
             *flag]), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bus_launches[path] = {w.__name__: w.launches for w in wrappers}
        checks = edge_cloud.table3_claim_checks(runs)
        int8_want = sum(expected_bus_launches(r, bool(flag), lag)[
            "int8_matmul"] for r in runs.values())
        print(json.dumps({path: {dep: {
            "table3": r.table3(), "e2e_s": r.mean_e2e_s(),
            "model_topic_nbytes": [m.nbytes for m in messages(r, T_MODEL)],
            "failures": len(r.failures)} for dep, r in runs.items()}}))
        print(f"bus path, {path}: 3 deployments in {wall:.3f} s; claims "
              f"{checks}; launches {bus_launches[path]}, int8_matmul "
              f"expected {int8_want}", flush=True)
        if not all(checks.values()):
            raise AssertionError(f"{path}: a Table-3 claim failed: {checks}")
        trained = bus_launches[path]
        if (trained["int8_matmul"] != int8_want or 0 in (
                trained["lstm_sequence_fused"],
                trained["lstm_sequence_fwd_train"],
                trained["lstm_sequence_bwd"])):
            raise AssertionError(f"{path}: launches {trained}, int8_matmul "
                                 f"expected {int8_want}")

    if flash.launches or wkv.launches or ssm.launches or cell.launches:
        raise AssertionError("an LSTM path launched a zoo kernel or the "
                             "one-step lstm_cell")

    # phase 7: where the time goes
    prof = profile_phase(fx)

    # phase 8: the zoo's serving path, tinyllama-1.1b through the Engine
    attention_plain = {"scan": (attention_mod, "_attend_chunked"),
                       "oracle": (flash_ref, "attend_full_ref")}
    zoo = zoo_phase(ZOO_ARCH, ZOO_FIXTURE, {
        flash: get_config(ZOO_ARCH).n_layers, wkv: 0, ssm: 0, cell: 0},
        attention_plain)

    # phase 9: the zoo's RWKV6 path, rwkv6-3b through the Engine
    rwkv = zoo_phase(RWKV_ARCH, RWKV_FIXTURE, {
        wkv: get_config(RWKV_ARCH).n_layers, flash: 0, ssm: 0, cell: 0}, {
        "stepwise": (rwkv_mod, "wkv_stepwise"),
        "chunked": (rwkv_mod, "wkv_chunked"),
        "oracle": (wkv_ref, "wkv_ref"),
        "oracle_flat": (wkv_ref, "rwkv6_scan_ref")})

    # phase 10: the zoo's hybrid path, zamba2-1.2b through the Engine: #8 in
    # every Mamba2 layer, #6 in every application of the shared block
    zcfg = get_config(ZAMBA_ARCH)
    zamba = zoo_phase(ZAMBA_ARCH, ZAMBA_FIXTURE, {
        ssm: zcfg.n_layers, flash: hybrid_arch._split(zcfg)[1], wkv: 0,
        cell: 0}, {
        **attention_plain,
        "ssd_stepwise": (ssm_mod, "ssd_stepwise"),
        "ssm_oracle": (ssm_ref, "selective_scan_ref"),
        "ssm_oracle_flat": (ssm_ref, "ssm_scan_ref")})
    if wkv_bwd.launches or ssm_bwd.launches or flash_bwd.launches:
        raise AssertionError("a serving path launched a backward kernel: "
                             f"{_by_kernel((wkv_bwd, ssm_bwd, flash_bwd))}")

    # phase 11: the scan path, kernel #5 under ops.lstm_sequence_scan
    scan = scan_phase(fx)

    # phase 12: the fleet, the stream axis of #1-#4: the kernels, then the
    # fleet's paths (each launch count read over its own run)
    t0 = time.perf_counter()
    _reset_launches(flash, wkv, ssm, cell)
    fleet_rows = fleet_kernel_phase()
    fleet = fleet_phase()
    print(f"fleet phase: {time.perf_counter() - t0:.3f} s with its kernel "
          "checks", flush=True)
    if flash.launches or wkv.launches or ssm.launches or cell.launches:
        raise AssertionError("the fleet launched a zoo kernel or the "
                             "one-step lstm_cell")

    # phases 13 and 14: the request plane and the placement plane (each
    # launch count read over its own run), then #1-#4 timed at their shapes
    t0 = time.perf_counter()
    request = request_phase()
    placement = placement_phase()
    plane_rows = plane_kernel_timings()
    print(f"planes: {time.perf_counter() - t0:.3f} s with their kernel "
          "timings", flush=True)
    if flash.launches or wkv.launches or ssm.launches or cell.launches:
        raise AssertionError("the planes launched a zoo kernel or the "
                             "one-step lstm_cell")

    # phase 15: the chaos and health planes (each launch count read over
    # its own run)
    chaos = chaos_phase()
    if flash.launches or wkv.launches or ssm.launches or cell.launches:
        raise AssertionError("the chaos plane launched a zoo kernel or the "
                             "one-step lstm_cell")

    # phases 16 and 17: the rest of the zoo's transformers through the
    # Engine, every attention in #6: the dense trio, then the MoE pair
    zoo_runs = zoo_rest_phase(flash, (wkv, ssm, cell), attention_plain)
    # phase 18: the encoder-decoder and the VLM, every attention in #6
    zoo_runs.update(zoo_encdec_vlm_phase(flash, (wkv, ssm, cell),
                                         attention_plain))
    if flash_bwd.launches or wkv_bwd.launches or ssm_bwd.launches:
        raise AssertionError("a serving path launched a backward kernel: "
                             f"{_by_kernel((wkv_bwd, ssm_bwd, flash_bwd))}")

    # phase 19: the transformer zoo's training, every attention's forward
    # in #6 and its gradient in #6's backward
    train_plain = {**attention_plain,
                   "bwd_oracle": (flash_ref, "flash_attend_bwd_ref")}
    zoo_train = zoo_train_phase(flash, flash_bwd, train_plain)

    # phase 20: RWKV6's and Zamba2's training, every scan's forward in #7
    # or #8 and its gradient in their backward kernels, the shared block's
    # attention in #6 and its backward
    recurrent = recurrent_train_phase(
        (wkv, wkv_bwd, ssm, ssm_bwd, flash, flash_bwd), recurrent_plain())

    # phase 21: the dry run on meta held to the bf16 steps of phases 19 (c)
    # and 20 (c), which it does not run again
    dryrun = dryrun_phase({ZOO_ARCH: zoo_train["bf16"],
                           **recurrent["bf16"]}, smi)

    # phase 22: the launcher's calibrated mode and the legacy fit, #1-#3
    # on their paths (each launch count read over its own run)
    calibrated = calibrated_phase(wrappers, (cell, flash, flash_bwd, wkv,
                                             wkv_bwd, ssm, ssm_bwd), smi)

    sources = "src/repro_torch/kernels/lstm_cell/csrc/"
    replaces = "src/repro/kernels/lstm_cell/kernel.py:"
    meta = {
        "lstm_sequence_fused": (sources + "lstm_sequence.cu", replaces + "131"),
        "lstm_sequence_fwd_train": (sources + "lstm_sequence.cu",
                                    replaces + "216"),
        "lstm_sequence_bwd": (sources + "lstm_sequence_bwd.cu",
                              replaces + "330"),
        "lstm_cell": (sources + "lstm_cell.cu", replaces + "72"),
        "int8_matmul": ("src/repro_torch/kernels/int8_matmul/csrc/"
                        "int8_matmul.cu",
                        "src/repro/kernels/int8_matmul/kernel.py:47"),
        "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:83"),
        "rwkv6_scan": ("src/repro_torch/kernels/rwkv6_scan/csrc/"
                       "rwkv6_scan.cu",
                       "src/repro/kernels/rwkv6_scan/kernel.py:60"),
        "ssm_scan": ("src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/kernel.py:59"),
    }
    served = {ZOO_ARCH: zoo, RWKV_ARCH: rwkv, ZAMBA_ARCH: zamba, **zoo_runs}
    # each zoo kernel's main path: the served generate of the arch whose
    # slice brought it
    zoo_main = {flash.__name__: ZOO_ARCH, wkv.__name__: RWKV_ARCH,
                ssm.__name__: ZAMBA_ARCH}
    kernels = []
    for kname, (source, repl) in meta.items():
        row = rows[kname]
        device = prof.get(kname, {"device_ms": row.get("device_ms")})
        if kname in ("lstm_sequence_fwd_train", "lstm_sequence_bwd"):
            for B, numbers in row["by_batch"].items():
                numbers.update(device[B])
            device = device[TRAIN_SHAPES[0][0]]
        if kname == flash.__name__:
            device = row  # phase 3 profiled the flash kernels
        if kname in zoo_main:
            by_path = {f"{arch}_{what}": run[f"{what}_launches"][kname]
                       for arch, run in served.items()
                       for what in ("generate", "serve")
                       if run[f"{what}_launches"][kname]}
        else:
            by_path = {"serving": serving_launches
                       if kname == fused.__name__ else 0,
                       "training": training_launches.get(kname, 0),
                       **{path: counts.get(kname, 0)
                          for path, counts in bus_launches.items()},
                       "scan": scan["launches"].get(kname, 0),
                       **{path: counts.get(kname, 0)
                          for path, counts in fleet["launches"].items()},
                       **{path: counts.get(kname, 0)
                          for plane in (request, placement, chaos)
                          for path, counts in plane["launches"].items()},
                       **{path: counts.get(kname, 0) for path, counts
                          in calibrated["launches"].items()}}
            row["fleet"] = fleet_rows[kname] if kname in fleet_rows \
                else None
            row["planes"] = plane_rows.get(kname)
        if kname in (flash.__name__, ssm.__name__, wkv.__name__):
            row["launches_by_kernel_by_path"] = {
                f"{arch}_{what}": run[f"{what}_launches_by_kernel"][kname]
                for arch, run in served.items()
                for what in ("generate", "serve")
                if run[f"{what}_launches"][kname]}
        if kname == flash.__name__:
            row["ptxas"] = ptxas
        # each kernel's main path: training for the LSTM sequence kernels,
        # the scan for the one-step cell, the int8 bus replay for the int8
        # kernel, a served generate for the zoo's
        main_path = ({int8.__name__: "int8", cell.__name__: "scan"}.get(
            kname, "training") if kname not in zoo_main
                     else f"{zoo_main[kname]}_generate")
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": repl, "launches": by_path[main_path],
            "launches_by_path": by_path,
            **row, "kernel_ms": row["ms"], "device_ms": device["device_ms"]})
    # #6's backward: its four kernels, two routes.  The tensor-core pair
    # runs on the zoo's bf16 training path (phase 19 (c), a bf16 step of
    # tinyllama-1.1b), the SIMT pair on its float32 one (phase 19 (b), the
    # parity run); each kernel's numbers at tinyllama's training shape in
    # its route's dtype
    bwd_row = rows["flash_attention_backward"]
    bwd_sources = {
        "simt": "src/repro_torch/kernels/flash_attention/csrc/"
                "flash_backward.cu",
        "wgmma": "src/repro_torch/kernels/flash_attention/csrc/"
                 "flash_backward_wgmma.cu"}
    for route, names in flash_kernel.BWD_ROUTES.items():
        dtype = "bfloat16" if route == "wgmma" else "float32"
        case = bwd_row["cases"][f"tinyllama train {dtype}"]
        path = "bf16_step" if route == "wgmma" else "float32_parity"
        for kname in names:
            prof_name = FLASH_BWD_KERNELS[kname]
            bound_ms, bound_by = case["bound_by_kernel"][kname]
            by_path = {
                "float32_parity": zoo_train["parity_launches"][kname],
                "bf16_step": zoo_train["bf16"]["launches_per_step"][kname]}
            kernels.append({
                "name": kname, "route": "cuda", "source": bwd_sources[route],
                "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
                "launches": by_path[path], "launches_by_path": by_path,
                "dtype": dtype,
                "max_abs_err": bwd_row["max_abs_err"] if route == "simt"
                else bwd_row["max_abs_err_bf16"],
                # one call launches both kernels of a route: a kernel's time
                # is its device time by the profiler, and its bound its own
                # function's; the call's event time, the plain version and
                # SDPA's backward compute all three gradients
                "ms": case["device_ms"][prof_name],
                "device_ms": case["device_ms"][prof_name],
                "call_ms": case["ms"], "call_bound_ms": case["bound_ms"],
                "plain_ms": case["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": case["library_ms"],
                "library_device_ms": case["library_device_ms"],
                "ptxas": {n: info for n, info in bwd_ptxas.items()
                          if prof_name in n},
                "cases": {label: {k: v for k, v in c.items()
                                  if k != "bound_by_kernel"}
                          for label, c in bwd_row["cases"].items()
                          if c["route"] == route}})
    # #7's and #8's backward: two kernels each, both launched once a call,
    # on each arch's training path; the main path is phase 20 (c)'s bf16
    # step at full depth.  A kernel's time is its device time by the
    # profiler, its bound its share of the call's (the two add up to
    # ``call_bound_ms``), ``design_bound_ms`` its floor with the boundary
    # states; the plain version covers both, and the call's event time
    # and cases stand on the "chunk" entry only
    scan_bwd_meta = {
        wkv_bwd.__name__: (RWKV_ARCH, WKV_BWD_KERNELS,
                           "src/repro_torch/kernels/rwkv6_scan/csrc/"
                           "rwkv6_backward.cu",
                           "src/repro/kernels/rwkv6_scan/kernel.py:60"),
        ssm_bwd.__name__: (ZAMBA_ARCH, SSM_BWD_KERNELS,
                           "src/repro_torch/kernels/ssm_scan/csrc/"
                           "ssm_backward.cu",
                           "src/repro/kernels/ssm_scan/kernel.py:59")}
    for call, (arch, names, source, repl) in scan_bwd_meta.items():
        row = rows[call]
        for kname, prof_name in names.items():
            by_path = {
                "float32_parity": recurrent["parity"][arch]["launches"][call][
                    kname],
                "bf16_step": recurrent["bf16"][arch]["launches_per_step"][
                    call][kname],
                "train_local": recurrent["local"][arch]["launches"][call][
                    kname]}
            bound_ms, bound_by = row["bound_by_kernel"][kname]
            entry = {
                "name": prof_name, "route": "cuda", "source": source,
                "replaces": repl, "wrapper": call,
                "launches": by_path["bf16_step"],
                "launches_by_path": by_path,
                "max_abs_err": row["max_abs_err"],
                "ms": row["device_ms_by_kernel"][kname],
                "device_ms": row["device_ms_by_kernel"][kname],
                "plain_ms": row["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "call_bound_ms": row["bound_ms"],
                "design_bound_ms": row["design_bound_by_kernel"][kname][0],
                "shape": row["shape"],
                "ptxas": {n: info for n, info in row["ptxas"].items()
                          if prof_name in n}}
            if kname == "chunk":
                entry.update(worst_gate=row["worst_gate"], call_ms=row["ms"],
                             call_device_ms=row["device_ms"],
                             cases=row["cases"])
            kernels.append(entry)
    print(json.dumps({"zoo_train": zoo_train}, default=str))
    print(json.dumps({"recurrent_train": recurrent}, default=str))
    print(json.dumps({"dryrun": dryrun}, default=str))
    print(json.dumps({"calibrated": {k: v for k, v in calibrated.items()
                                     if k != "launches"}}, default=str))
    print(json.dumps({"scan": scan}))
    print(json.dumps({"fleet": {k: v for k, v in fleet.items()
                                if k != "launcher"}}, default=str))
    print(json.dumps({"request": {k: v for k, v in request.items()
                                  if k not in ("launches", "scale")},
                      "request_scale": {
                          name: {k: v for k, v in numbers.items()
                                 if k != "stage_walls"}
                          for name, numbers in request["scale"].items()},
                      "placement": {k: v for k, v in placement.items()
                                    if k != "launches"}}, default=str))
    print(json.dumps({"chaos": {k: v for k, v in chaos.items()
                                if k != "launches"}}, default=str))
    for arch, run in served.items():
        print(json.dumps({arch: {k: v for k, v in run.items()
                                 if k not in ("busy", "near_ties")} | {
            "idle_share": run["busy"]["idle_share"],
            "busy_ms": run["busy"]["busy_ms"],
            "generate_wall_s": run["busy"]["wall_s"]}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
