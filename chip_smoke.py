#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the device: CUDA must be present; prints the card's name and
   ``nvidia-smi``'s name and power limit;
2. the build: compiles every CUDA library of the port with ``nvcc`` from the
   sources in this checkout, one ``nvcc`` per library, all at once, and
   prints ``-Xptxas -v``'s registers and spills of #6's kernels and of the
   training pair's (#2, #3);
3. the kernels: each kernel against its plain PyTorch version on the card
   at the main paths' shapes and a few edge shapes (the training pair also
   against the plain versions of its own algorithms, ``ref.*_tiled_ref``,
   with ragged tiles, one row and a long T; both kernels run twice, bit for
   bit), then timed beside the plain version and the library call that
   computes the same function (cuDNN's ``torch.nn.LSTM`` for #1-#3, by CUDA
   events and by the profiler's device time; for the int8 matmul, which no
   one PyTorch call computes, ``(x @ q.float()) * scale``; for the one-step
   LSTM cell #5, ``torch.lstm_cell``);
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
   greedy tokens and logits (``tests/data/torch_parity_tinyllama.npz``) and
   step-by-step decode must equal one full forward; in the config's bf16,
   ``Engine.generate`` (4 x 512 prompt + 32 tokens) must launch the flash
   kernel exactly 22 x 32 times (22 of its wgmma prefill, 22 x 31 of its
   split decode, none of its SIMT kernel) and no plain attention, and
   ``Engine.serve`` must finish every request; prefill and decode times,
   tokens/s and the device's idle share over a warm generate are printed;
9. the zoo's RWKV6 path: ``rwkv6-3b`` at full width and depth through the
   same ``Engine`` and the same checks, every WKV recurrence through the
   WKV kernel: float32 parity with ``tests/data/torch_parity_rwkv6_3b.npz``
   and decode equivalence, then in bf16 ``Engine.generate`` (4 x 512 + 32)
   with exactly 32 x 32 launches of the WKV kernel and no plain WKV call,
   and ``Engine.serve``;
10. the zoo's hybrid path: ``zamba2-1.2b`` at full width and depth through
   the same ``Engine`` and the same checks, every Mamba2 scan through the
   selective-scan kernel and every application of the shared attention
   block through the flash kernel: float32 parity with
   ``tests/data/torch_parity_zamba2_1_2b.npz`` and decode equivalence,
   then in bf16 ``Engine.generate`` (4 x 512 + 32) with exactly 38 x 32
   launches of the selective-scan kernel, 6 x 32 of the flash kernel (6 of
   its wgmma prefill, 6 x 31 of its split decode) and no plain scan or
   attention, and ``Engine.serve``;
11. the scan path, the path of the one-step LSTM cell #5: the per-step
   baseline ``ops.lstm_sequence_scan`` on the reference's batch model and
   a serving window (250 x 5 x 5, H = 40), in float32 and with bf16 x; each
   call must launch #5 exactly T = 5 times and no sequence kernel, match
   the plain scan (whose carry is in x's type, as the reference's) and, in
   float32, the fused #1; then timed beside #1 and ``torch.nn.LSTM``.

Every kernel is built in phase 2 and held to its plain version in phase 3.
The one-step cell (#5) is held there at the reference's sweep, the serving
rows and H up to 1024 (beyond the sequence kernels' shared memory), every
case twice, bit for bit.  Flash attention (#6) is three kernels, one
launch a call, picked by ``kernel.kernel_for``: the split decode, the
wgmma prefill and the SIMT kernel; phase 3 runs each case through the one
the rule picks and names it, holds the wgmma prefill's bf16 output also
within ``FLASH_TC_TOL``, reruns the two new kernels bit for bit, and times
each new kernel against the SIMT kernel in turns beside SDPA (at
tinyllama's GQA shapes and at zamba2's MHA ones), by CUDA events and by
the profiler.  The WKV kernel (#7) and the
selective-scan kernel (#8) are built in phase 2, held to their plain
versions (reruns bit for bit) and timed in phase 3, with their device
times from the profiler; no single PyTorch call computes either.

It prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  The helpers above ``main`` need no
GPU; the port's CPU tests drive the same paths through them.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

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
# 0's mask check, padded and not), 2048 and 1595 (the pretrain's mask check)
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
# block
TRAIN_SHAPES = ((64, 5, 5, 40), (256, 5, 5, 40))
TRAIN_CASES = [
    (*TRAIN_SHAPES[0], "float32"),
    (*TRAIN_SHAPES[1], "float32"),
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
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor
# cores, at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# and the bf16 tensor-core rate (dense)
PEAK_BF16_FLOP_PER_S = 989e12
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
# kernel #6's timed shapes: label -> (shape, the positions' kind)
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
# kernel #6's three kernels, by a substring of the profiler's name
# the training pair's kernels, by a substring of the profiler's name: #2,
# and #3's two launches a call
TRAIN_FWD_KERNEL = "lstm_train_fwd_kernel"
BWD_KERNELS = ["lstm_bwd_time_kernel", "lstm_bwd_combine_kernel"]
FLASH_KERNELS = {"simt": "flash_attention_kernel",
                 "prefill_wgmma": "flash_prefill_wgmma_kernel",
                 "decode_split": "flash_decode_split_kernel"}
FLASH_TIMED = (("prefill", FLASH_PREFILL, "arange"),
               ("decode", FLASH_DECODE, "last"),
               ("mha_prefill", FLASH_MHA_PREFILL, "arange"),
               ("mha_decode", FLASH_MHA_DECODE, "last"))
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
# The zoo's serving path (tinyllama-1.1b, rwkv6-3b), on any device
# ---------------------------------------------------------------------------


def zoo_parity_config(cfg):
    """The parity run's config: the arch at full width and depth, float32."""
    return cfg.replace(dtype="float32", param_dtype="float32")


def _param_shapes(cfg) -> dict:
    """{path: (shape, kind)} of the model's params in the reference's tree
    layout: the embedding, the head, the final norm, and the layer stack
    with a leading L axis, of the dense transformer
    (``models/transformer.py: init_params``) or of RWKV6, the ``ssm``
    family (``models/rwkv.py: init_params``); or, for the Zamba2 hybrid
    (``models/hybrid_arch.py: init_params``), the Mamba2 stack ``mamba/*``
    with a leading L axis and the one shared block ``shared/*``."""
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    qd, kvd, f = cfg.q_dim, cfg.kv_dim, cfg.d_ff
    shapes = {"tok_embed": ((V, d), "embed"), "final_norm": ((d,), "norm")}
    if not cfg.tie_embeddings:
        shapes["out_head"] = ((d, V), "dense")
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
    layer = {"attn_norm": ((L, d), "norm"), "mlp_norm": ((L, d), "norm"),
             "wq": ((L, d, qd), "dense"), "wk": ((L, d, kvd), "dense"),
             "wv": ((L, d, kvd), "dense"), "wo": ((L, qd, d), "dense"),
             "w_in": ((L, d, f), "dense"), "w_out": ((L, f, d), "dense")}
    if cfg.qkv_bias:
        layer.update(bq=((L, qd), "bias"), bk=((L, kvd), "bias"),
                     bv=((L, kvd), "bias"))
    if cfg.mlp_variant in ("swiglu", "geglu"):
        layer["w_gate"] = ((L, d, f), "dense")
    shapes.update({f"layers/{k}": v for k, v in layer.items()})
    return shapes


# RWKV6's uniform draws and Zamba2's A_log: kind -> (low, high)
UNIFORM_KINDS = {"mix": (0.2, 0.8), "mix_lora": (-0.005, 0.005),
                 "decay": (-1.5, -0.5), "a_log": (0.0, float(np.log(16.0)))}
# Zamba2's dt_bias: the inverse softplus of a dt log-uniform on this range
DT_RANGE = (1e-3, 1e-1)


def numpy_params(cfg, seed: int) -> dict:
    """Random float32 params of the dense transformer, RWKV6 or the Zamba2
    hybrid, a nested dict of numpy arrays in the reference's tree layout.
    Each leaf draws from its own generator, seeded by (seed, crc32 of its
    path): dense weights normal at fan-in scale, the embedding normal at
    d**-0.5, norm gains 1 + 0.1 normal, biases 0.02 normal.  RWKV6's other
    leaves:

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
    tree: dict = {}
    for path, (shape, kind) in sorted(_param_shapes(cfg).items()):
        rng = np.random.default_rng([seed, zlib.crc32(path.encode())])
        if kind in UNIFORM_KINDS or kind == "decay_lora":
            lo, hi = UNIFORM_KINDS.get(kind, (-0.5 / shape[-2],
                                              0.5 / shape[-2]))
            w = rng.uniform(lo, hi, shape).astype(np.float32)
        elif kind == "dt_bias":
            dt = np.exp(rng.uniform(*np.log(DT_RANGE), shape))
            w = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
        else:
            w = rng.standard_normal(shape, dtype=np.float32)
        if kind in ("dense", "embed", "conv"):
            w *= np.float32(shape[-1 if kind == "embed" else -2] ** -0.5)
        elif kind == "norm":
            w *= np.float32(0.1)
            w += np.float32(1.0)
        elif kind == "bias":
            w *= np.float32(0.02)
        elif kind == "bonus":
            w *= np.float32(0.5)
        *parents, leaf = path.split("/")
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = w
    return tree


def zoo_prompts(cfg, seed: int, shape=ZOO_PROMPTS) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, shape,
                                                dtype=np.int32)


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
                       max_len: int) -> dict:
    """The parity fixture's arrays: the run's metadata, its prompts and
    greedy tokens, and ``logit_summary`` of its steps.  No weights: the
    params are ``numpy_params(config, seed)``."""
    return {"arch": np.array(arch), "reduced": np.array(reduced),
            "seed": np.array(seed), "max_len": np.array(max_len),
            "prompts": np.asarray(prompts, np.int32),
            "tokens": np.asarray(tokens, np.int32), **logit_summary(steps)}


def zoo_config(fx: dict):
    """The config of a parity fixture: its arch at full width in float32,
    or ``.reduced()``."""
    _import_port()
    from repro_torch.configs import get_config

    cfg = get_config(str(fx["arch"]))
    return cfg.reduced() if bool(fx["reduced"]) else zoo_parity_config(cfg)


def run_zoo_parity(fx: dict, device):
    """The fixture's run on the port: params from ``numpy_params`` on
    ``device``, the prompts through ``Engine.generate``.  Returns (cfg,
    params, tokens, steps)."""
    _import_port()
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving.engine import Engine

    cfg = zoo_config(fx)
    params = params_from_numpy(numpy_params(cfg, int(fx["seed"])), device)
    engine = Engine(cfg, params, max_len=int(fx["max_len"]), device=device)
    steps = record_logits(engine)
    tokens, _ = engine.generate(fx["prompts"], fx["tokens"].shape[1])
    return cfg, params, tokens, steps


def check_zoo_parity(fx: dict, tokens: np.ndarray, steps: list,
                     atol: float) -> dict:
    """Hold the port's greedy tokens and logits to the fixture: tokens
    equal; at every step, the logits at the reference's top-k ids and the
    logsumexp within ``atol``.  A token may differ only where the
    reference's top-1/top-2 gap is below ``atol``; that row is then
    compared up to the step where it differs.  Returns the measured
    {"logit_err", "lse_err", "near_ties"}."""
    got = np.stack(steps, axis=1)  # (B, T, V)
    lse = logit_summary(steps)["lse"]
    logit_err = lse_err = 0.0
    near_ties = []
    for b in range(fx["tokens"].shape[0]):
        diff = np.flatnonzero(tokens[b] != fx["tokens"][b])
        last = int(diff[0]) if diff.size else tokens.shape[1] - 1
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


def full_logits(cfg, params, tokens):
    """Every position's logits of one full forward over ``tokens``."""
    from repro_torch.models import blocks
    from repro_torch.models.model import get_model

    h = get_model(cfg).forward(params, {"tokens": tokens})
    return blocks.logits_fn(cfg, params, h)


def decode_equivalence(cfg, params, tokens: np.ndarray, n_prefill: int,
                       device) -> float:
    """Step-by-step decode against one full forward over the same tokens:
    prefill ``n_prefill`` tokens, decode the rest teacher-forced, and
    return the largest |logit difference| from ``forward``'s logits at
    every decoded position (the reference's strongest serving invariant,
    tests/test_decode_equivalence.py)."""
    import torch

    from repro_torch.models.model import get_model

    model = get_model(cfg)
    with torch.no_grad():
        t = torch.tensor(np.asarray(tokens, np.int32), device=device)
        B, S = t.shape
        full = full_logits(cfg, params, t)
        logits, cache = model.prefill(params, {"tokens": t[:, :n_prefill]}, S)
        err = float((logits - full[:, n_prefill - 1]).abs().max())
        for i in range(n_prefill, S):
            pos = torch.full((B,), i, dtype=torch.int32, device=device)
            logits, cache = model.decode_step(
                params, {"token": t[:, i:i + 1], "pos": pos}, cache)
            err = max(err, float((logits - full[:, i]).abs().max()))
    return err


def zoo_requests(cfg, seed: int = ZOO_SEED) -> list:
    """Engine.serve's request mix: prompt lengths ``SERVE_PROMPT_LENS``,
    ``SERVE_NEW_TOKENS`` new tokens each, prompts from numpy ``seed``."""
    _import_port()
    from repro_torch.serving.batching import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(1, cfg.vocab_size, (n,),
                                               dtype=np.int32),
                    max_new_tokens=new)
            for i, (n, new) in enumerate(zip(SERVE_PROMPT_LENS,
                                             SERVE_NEW_TOKENS))]


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
    """The serving kernel against its plain version at every case, then
    timed at the serving path's shape.  Returns the numbers of its row."""
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
            h, c = lstm_kernel.lstm_sequence_fused(x, wx, wh, b)
            h_ref, c_ref = lstm_sequence_ref(x, wx, wh, b, return_state=True)
        torch.cuda.synchronize()
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
        print(f"kernel lstm_sequence_fused B={B} T={T} F={F} H={H} {dtype}, "
              f"{w_dtype} weights: max|dh|={errs[0]:.3g} max|dc|="
              f"{errs[1]:.3g} ({limit}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(
                f"lstm_sequence_fused disagrees with its plain version at "
                f"B={B} T={T} F={F} H={H} {dtype}, {w_dtype} weights: {errs}")

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
        kernel_ms = _median_ms(lambda: lstm_kernel.lstm_sequence_fused(
            x, wx, wh, b))
        plain_ms = _median_ms(lambda: lstm_sequence_ref(x, wx, wh, b))
        library_ms = _median_ms(lambda: lstm(x))
        library_device_ms = _device_ms_per_call(lambda: lstm(x))
    bound_ms, bound_by = _lstm_bound(B, T, F, H)
    print(f"timing at {MAIN_SHAPE} float32 (median of 200, CUDA events): "
          f"kernel {kernel_ms:.6f} ms, plain {plain_ms:.6f} ms, "
          f"torch.nn.LSTM {library_ms:.6f} ms (device {library_device_ms} ms "
          f"a call, all its kernels, profiler mean of 100), bound "
          f"{bound_ms:.6f} ms ({bound_by})", flush=True)
    return {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_device_ms": library_device_ms}


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
    the speed fit's and the pretrain's step shapes beside their plain
    versions and cuDNN (CUDA events, and the profiler's device time of
    cuDNN's calls).  Returns the numbers of their rows."""
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


def cell_kernel_phase() -> dict:
    """Kernel #5 against its plain version at every case of CELL_CASES, each
    run twice, bit for bit, and at B = 0 (no launch).  Then timed at the
    serving step (250, 5, 40) float32: CUDA events, the profiler's device
    time, the plain version, and ``torch.lstm_cell``, the one PyTorch call
    that computes the same function (held to the kernel first).  Returns
    the numbers of its row."""
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
              f"{'/'.join(dtypes)}: max|dh'|="
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
    bound_ms, bound_by = _cell_bound(B, F, H)
    numbers = {
        "max_abs_err": max_err, "ms": _median_ms(lambda: cell(*args)),
        "device_ms": _kernel_device_ms(lambda: cell(*args),
                                       ["lstm_cell_kernel"])[
                                           "lstm_cell_kernel"],
        "plain_ms": _median_ms(lambda: ref.lstm_cell_ref(*args)),
        "library_ms": _median_ms(library),
        "library_device_ms": _device_ms_per_call(library),
        "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"timing lstm_cell at (B, F, H) = {CELL_MAIN} float32 (median of "
          f"200, CUDA events): kernel {numbers['ms']:.6f} ms (device "
          f"{numbers['device_ms']} ms, profiler median of 100), plain "
          f"{numbers['plain_ms']:.6f} ms, torch.lstm_cell "
          f"{numbers['library_ms']:.6f} ms (device "
          f"{numbers['library_device_ms']} ms a call, all its kernels, "
          f"profiler mean of 100), bound {bound_ms:.6f} ms ({bound_by})",
          flush=True)
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
    """Kernel #4 against its plain version at every case, then timed at the
    bus path's three shapes beside the plain version and the library
    yardstick ``(x @ q.float()) * scale`` (cuBLAS and two elementwise
    launches: no single PyTorch call computes the function).  Returns the
    numbers of its row, at the recurrent step's shape ``INT8_MAIN``."""
    import torch

    from repro_torch.kernels.int8_matmul import kernel as int8_kernel
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

    max_err = 0.0
    for i, (M, K, N, dtype) in enumerate(INT8_CASES):
        x, q, scale = _int8_inputs(M, K, N, dtype, seed=400 + i)
        y = int8_kernel.int8_matmul(x, q, scale)
        y_ref = int8_matmul_ref(x, q, scale)
        torch.cuda.synchronize()
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
              f"{err:.3g} ({limit}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"int8_matmul disagrees with its plain "
                                 f"version at M={M} K={K} N={N} {dtype}: "
                                 f"{err}")

    by_shape = {}
    for M, K, N in INT8_SHAPES:
        x, q, scale = _int8_inputs(M, K, N, "float32", seed=500)
        bound_ms, bound_by = _int8_bound(M, K, N)
        numbers = {
            "ms": _median_ms(lambda: int8_kernel.int8_matmul(x, q, scale)),
            "plain_ms": _median_ms(lambda: int8_matmul_ref(x, q, scale)),
            "library_ms": _median_ms(lambda: (x @ q.float()) * scale),
            "bound_ms": bound_ms, "bound_by": bound_by}
        by_shape[f"{M}x{K}x{N}"] = numbers
        print(f"timing int8_matmul at (M, K, N) = {(M, K, N)} float32 "
              f"(median of 200, CUDA events): kernel {numbers['ms']:.6f} ms, "
              f"plain {numbers['plain_ms']:.6f} ms, (x @ q.float()) * scale "
              f"{numbers['library_ms']:.6f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by})", flush=True)
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
    queries at the last Sq positions)."""
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


def _sdpa_call(q, k, v, q_pos, kv_pos, causal_arange: bool):
    """``scaled_dot_product_attention(..., enable_gqa=True)`` on (B,H,S,D)
    copies of the inputs, causal for the prefill and a boolean mask from
    the positions for a decode step: the library yardstick timed beside
    the kernel, never used by the port."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import position_mask

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
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
        if which != "simt":
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
        sdpa = _sdpa_call(q, k, v, q_pos, kv_pos, kind == "arange")

        def launch(name):
            return lambda: flash_kernel._launch(q, k, v, q_pos, kv_pos,
                                                kernel=name)
        kern, simt = launch(new)(), launch("simt")()
        lib_err = float((sdpa().float() - kern.float()).abs().max())
        simt_diff = float((simt.float() - kern.float()).abs().max())
        bound_ms, bound_by = _flash_bound(q, k, q_pos, kv_pos)
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
                q, k, v, q_pos, kv_pos), n=50),
            "library_ms": _median_ms(sdpa), "library_device_ms": sdpa_dev,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "sdpa_max_abs_diff": lib_err, "simt_max_abs_diff": simt_diff}
        by_shape[label] = numbers
        print(f"timing flash_attention {label} at (B, Sq, Sk, Hq, Hkv, D) = "
              f"{shape} bfloat16 (median, CUDA events; in turns simt, {new}, "
              f"{new}, simt: {', '.join(f'{t:.6f}' for t in turns)} ms): "
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


def _wkv_case(B, T, H, N, seed, state=False, decay=None):
    """Inputs of kernel #7 on the card, float32, drawn as the reference's
    test draws them: r, k, v 0.5 normal, w = sigmoid(normal) * 0.5 + 0.45
    (or uniform on ``decay`` = (low, high)), u (H,N) 0.1 normal; state0
    normal when ``state``, else None."""
    import torch

    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)) * 0.5 for _ in range(3))
    if decay is None:
        w = 0.5 / (1 + np.exp(-rng.standard_normal((B, T, H, N)))) + 0.45
    else:
        w = rng.uniform(*decay, (B, T, H, N))
    u = rng.standard_normal((H, N)) * 0.1
    s0 = rng.standard_normal((B, H, N, N)) if state else None
    return [None if a is None else torch.tensor(a, dtype=torch.float32,
                                                device="cuda")
            for a in (r, k, v, w, u, s0)]


def _wkv_bound(B, T, H, N, state_in):
    """Bound of one WKV scan at (B,T,H,N), float32: r, k, v, w read and y
    written once, u read once, the final state written once and the
    initial one read only when ``state_in`` (the model's prefill passes
    none).  Operations: 5 a state element and step (r_i S_ij summed, one
    FMA; w_i S_ij + k_i v_j, a multiply and an FMA) and 5 a (b, t, h, j)
    for the bonus, factored as y_j += v_j (sum_i r_i u_i k_i): 3 an i for
    the sum, 2 a j for its product and add."""
    nbytes = 4 * (5 * B * T * H * N + H * N
                  + (2 if state_in else 1) * B * H * N * N)
    return _bound(nbytes, 5 * B * T * H * N * (N + 1))


def wkv_kernel_phase() -> dict:
    """Kernel #7 against its plain version: the reference's sweep in the
    flat (BH,T,N) layout from a zero state (against ``rwkv6_scan_ref``),
    the model layout, a nonzero state, decays near 0 and near 1, a head
    size that is no power of two, T = 1, the served prefill and decode
    step, the state updated in place, and T = 0 (no launch), at the
    reference's tolerance; every case run twice, bit for bit.  Then timed
    at the served prefill and decode (CUDA events and the profiler's
    device time) beside the plain version and the bound; no single
    PyTorch call computes the recurrence.  Returns the numbers of its
    row, at the prefill shape."""
    import torch

    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref

    checks = [("sweep", (1, T, BH, N), {}) for BH, T, N in WKV_SWEEP]
    checks += [("model", (2, 40, 3, 16), {}),
               ("state", (3, 77, 5, 32), {"state": True}),
               ("decay~0", (2, 50, 4, 16), {"state": True,
                                            "decay": (1e-6, 1e-3)}),
               ("decay~1", (2, 300, 4, 64), {"state": True,
                                             "decay": (0.999, 1 - 1e-7)}),
               ("N=24", (2, 30, 3, 24), {"state": True}),
               ("T=1", (3, 1, 5, 32), {"state": True}),
               ("prefill", WKV_PREFILL, {}),
               ("decode", WKV_DECODE, {"state": True})]
    max_err = 0.0
    for i, (label, shape, kw) in enumerate(checks):
        r, k, v, w, u, s0 = _wkv_case(*shape, seed=800 + i, **kw)
        if label == "prefill":  # the model's prefill passes a zero state
            s0 = torch.zeros(shape[0], shape[2], shape[3], shape[3],
                             device="cuda")
        runs = [wkv_ops.wkv(r, k, v, w, u, s0) for _ in range(2)]
        want = wkv_ref.wkv_ref(r, k, v, w, u, s0)
        if label == "sweep":  # the reference's test: the flat (BH,T,N)
            flat = [a[0].transpose(0, 1) for a in (r, k, v, w)]
            y, s = wkv_ref.rwkv6_scan_ref(*flat, u)
            want = (wkv_ref.to_model_layout(y), s[None])
        if label == "decode":  # in place: the state written over state0
            inplace = s0.clone()
            runs.append(wkv_ops.wkv(r, k, v, w, u, inplace, out=inplace))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for run in runs[1:]
                   for a, b in zip(runs[0], run))
        d = max(float((g - e).abs().max()) for g, e in zip(runs[0], want))
        ok = same and all(bool(((g - e).abs() <= WKV_TOL + WKV_TOL * e.abs())
                               .all()) for g, e in zip(runs[0], want))
        max_err = max(max_err, d)
        print(f"kernel rwkv6_scan {label} (B, T, H, N) = {shape}"
              f"{' from a state' if s0 is not None else ''}: max|d|={d:.3g} "
              f"(atol = rtol = {WKV_TOL}); {len(runs)} runs "
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

        def kern():
            return wkv_kernel.rwkv6_scan(r, k, v, w, u, s0)

        bound_ms, bound_by = _wkv_bound(*shape, state_in=state)
        numbers = {
            "ms": _median_ms(kern),
            "plain_ms": _median_ms(lambda: wkv_ref.wkv_ref(r, k, v, w, u, s0),
                                   n=10 if label == "prefill" else 50,
                                   warmup=2),
            "device_ms": _kernel_device_ms(kern, ["rwkv6_scan_kernel"])[
                "rwkv6_scan_kernel"],
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
        by_shape[label] = numbers
        print(f"timing rwkv6_scan {label} at (B, T, H, N) = {shape} float32 "
              f"(median, CUDA events): kernel {numbers['ms']:.6f} ms "
              f"(device {numbers['device_ms']} ms, profiler median of 100), "
              f"plain {numbers['plain_ms']:.6f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}); no single PyTorch call computes it",
              flush=True)
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


def _ssm_bound(B, T, H, P, N, state_in):
    """Bound of one selective scan at (B,T,H,P,N), float32: x read and y
    written once, b, c, dt, a and d read once, the final state written
    once and the initial one read only when ``state_in`` (the model's
    prefill starts from zero).  Operations: 5 a state element and step
    (decay h + u b, a multiply and an FMA; h c summed, an FMA), 3 a (b, t,
    h, p) (u = dt x; d x added, an FMA) and 2 a (b, t, h) (dt a and its
    exp)."""
    nbytes = 4 * (2 * B * T * H * P + 2 * B * T * N + B * T * H + 2 * H
                  + (2 if state_in else 1) * B * H * P * N)
    flops = 5 * B * T * H * P * N + 3 * B * T * H * P + 2 * B * T * H
    return _bound(nbytes, flops)


def ssm_kernel_phase() -> dict:
    """Kernel #8 against its plain version: the reference's sweep in the
    flat (BH,T,P) layout from a zero state (each row its own launch, b and
    c its own, against ``ssm_scan_ref``), the model layout, a nonzero
    state, steps near 0 and large (decays near 1 and near 0), dims that
    are no power of two, T = 1, the served prefill and decode step, the
    state updated in place (``out`` is ``state0``), and T = 0 (no launch),
    at the reference's tolerance; every case run twice, bit for bit.  Then
    timed at the served prefill and decode (CUDA events and the profiler's
    device time) beside the plain version and the bound; no single
    PyTorch call computes the recurrence.  Returns the numbers of its row,
    at the prefill shape."""
    import torch

    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan import ref as ssm_ref

    def close(got, want):
        return bool(((got - want).abs() <= SSM_TOL + SSM_TOL * want.abs())
                    .all())

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
        print(f"kernel ssm_scan sweep (BH, T, P, N) = {(BH, T, P, N)} from a "
              f"zero state: max|d|={err:.3g} (atol = rtol = {SSM_TOL}); 2 "
              f"runs {'bit-identical' if same else 'DIFFER'} "
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
              ("T=1", (3, 1, 5, 32, 16), {"state": True}),
              ("prefill", SSM_PREFILL, {}),
              ("decode", SSM_DECODE, {"state": True})]
    for i, (label, shape, kw) in enumerate(checks):
        x, b, c, dt, a, d, s0 = _ssm_case(*shape, seed=1100 + i, **kw)
        runs = [ssm_ops.selective_scan(x, b, c, dt, a, d, s0)
                for _ in range(2)]
        want = ssm_ref.selective_scan_ref(x, b, c, dt, a, d, s0)
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
        ok = same and all(close(g, e) for g, e in zip(runs[0], want))
        max_err = max(max_err, err)
        print(f"kernel ssm_scan {label} (B, T, H, P, N) = {shape}"
              f"{' from a state' if s0 is not None else ''}: max|d|={err:.3g} "
              f"(atol = rtol = {SSM_TOL}); {len(runs)} runs "
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

        def kern():
            return ssm_kernel.ssm_scan(x, b, c, dt, a, d, s0)

        bound_ms, bound_by = _ssm_bound(*shape, state_in=state)
        numbers = {
            "ms": _median_ms(kern),
            "plain_ms": _median_ms(
                lambda: ssm_ref.selective_scan_ref(x, b, c, dt, a, d, s0),
                n=10 if label == "prefill" else 50, warmup=2),
            "device_ms": _kernel_device_ms(kern, ["ssm_scan_kernel"])[
                "ssm_scan_kernel"],
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
        by_shape[label] = numbers
        print(f"timing ssm_scan {label} at (B, T, H, P, N) = {shape} float32 "
              f"(median, CUDA events): kernel {numbers['ms']:.6f} ms "
              f"(device {numbers['device_ms']} ms, profiler median of 100), "
              f"plain {numbers['plain_ms']:.6f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}); no single PyTorch call computes it",
              flush=True)
    return {"max_abs_err": max_err, "by_shape": by_shape,
            **by_shape["prefill"]}


def _device_intervals(prof):
    """(name, start_us, end_us) of every device-side event of a profile:
    kernels, copies and memsets."""
    import torch

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _profile(fn):
    """Device intervals of one profiled call of ``fn``, which ends synced."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def _busy(fn, label: str) -> dict:
    """Wall of one unprofiled warm call of ``fn`` (which ends synced), and
    the device's busy time, idle share and top kernels by name over a
    profiled call."""
    t0 = time.perf_counter()
    fn()
    wall_s = time.perf_counter() - t0
    spans = _profile(fn)
    if not spans:
        print(f"profile {label}: the profiler saw no device events; device "
              "time not measured")
        return {"wall_s": wall_s, "busy_ms": None, "idle_share": None}
    busy_us, covered = 0.0, float("-inf")
    for s, e in sorted((s, e) for _, s, e in spans):  # union of intervals
        busy_us += max(0.0, e - max(s, covered))
        covered = max(covered, e)
    by_name: dict = {}
    for name, s, e in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    idle = 1 - busy_us / 1e6 / wall_s
    print(f"profile {label}: device busy {busy_us / 1e3:.3f} ms in "
          f"{len(spans)} device events against {1e3 * wall_s:.3f} ms of "
          f"unprofiled wall: idle share {idle:.4f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile {label}: device time {us / 1e3:.3f} ms  {name[:90]}")
    return {"wall_s": wall_s, "busy_ms": busy_us / 1e3, "idle_share": idle,
            "device_ms_by_name": {n: us / 1e3 for n, us in by_name.items()}}


def profile_phase(fx: dict) -> dict:
    """Where the time goes, from ``torch.profiler``: each kernel's own
    device time per call (the serving kernel at the serving shape, the
    training pair at both step shapes), the device's busy time over a warm
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
            ["lstm_sequence_kernel"])
    out["lstm_sequence_fused"] = {"device_ms": dev["lstm_sequence_kernel"]}
    print(f"profile: lstm_sequence_fused device time at {MAIN_SHAPE} "
          f"{dev['lstm_sequence_kernel']} ms (median of 100)")
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


def zoo_phase(arch: str, fixture: Path, kernels: dict, plain: dict) -> dict:
    """A zoo model's serving path on the card, ``arch`` at full width and
    depth through the port's ``Engine``.  (b) Parity in float32: the
    reference's ``fixture`` reproduced (greedy tokens equal, logits within
    ``ZOO_LOGIT_ATOL``), and step-by-step decode against one full forward.
    (c) The served run in the config's bf16, params from a
    ``torch.Generator`` on the card: ``Engine.generate`` with every call of
    the path's kernels through their wrappers, ``kernels`` ({wrapper:
    launches per forward}, 0 for a kernel the path must not launch), and
    none of the plain versions ``plain`` names ({label: (module,
    attribute)}), the device's idle share over a warm generate, and
    ``Engine.serve`` finishing every request.  Returns the measured
    numbers."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import get_model
    from repro_torch.serving.engine import Engine

    out = {}
    fx = load_fixture(fixture)
    if str(fx["arch"]) != arch or bool(fx["reduced"]):
        raise AssertionError(f"{fixture} is not the full-width {arch} "
                             "fixture")
    t0 = time.perf_counter()
    cfg, params, tokens, steps = run_zoo_parity(fx, "cuda")
    torch.cuda.synchronize()
    parity = check_zoo_parity(fx, tokens, steps, ZOO_LOGIT_ATOL)
    print(f"zoo parity {arch} float32 full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}): params from numpy seed {int(fx['seed'])} "
          f"and {fx['tokens'].shape[0]} x {fx['tokens'].shape[1]} greedy "
          f"tokens in {time.perf_counter() - t0:.3f} s; tokens "
          f"{'equal' if not parity['near_ties'] else 'equal up to near ties '}"
          f"{parity['near_ties'] or ''} the reference's; top-{ZOO_TOPK} "
          f"logits max|d|={parity['logit_err']:.3g}, logsumexp "
          f"max|d|={parity['lse_err']:.3g} (atol {ZOO_LOGIT_ATOL})",
          flush=True)
    toks = np.concatenate([fx["prompts"], fx["tokens"]], axis=1)
    eq = decode_equivalence(cfg, params, toks, fx["prompts"].shape[1], "cuda")
    print(f"zoo decode equivalence {arch} float32 full width: prefill "
          f"{fx['prompts'].shape[1]} then {fx['tokens'].shape[1]} decode "
          f"steps against one forward over {toks.shape[1]} tokens, logits "
          f"max|d|={eq:.3g} (atol {DECODE_EQ_ATOL})", flush=True)
    if eq > DECODE_EQ_ATOL:
        raise AssertionError(f"decode differs from the full forward: {eq}")
    out.update(parity_logit_err=parity["logit_err"],
               parity_lse_err=parity["lse_err"],
               near_ties=parity["near_ties"], decode_equivalence_err=eq)
    del params
    torch.cuda.empty_cache()

    # (c) the served run, in the config's bf16
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(ZOO_SEED), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S, new = SERVE_GENERATE
    prompts = zoo_prompts(cfg, ZOO_SEED + 1, (B, S))
    engine = Engine(cfg, params, max_len=SERVE_MAX_LEN, device="cuda")
    engine.generate(prompts, new)  # warm: cuBLAS handles, the allocator

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
        _reset_launches(*kernels)
        tokens, stats = engine.generate(prompts, new)
        launches = {w.__name__: w.launches for w in kernels}
        by_kernel = _by_kernel(kernels)
    finally:
        for label, (mod, attr) in plain.items():
            setattr(mod, attr, saved[label])
    # the prefill and new - 1 decode steps; in bf16 with D % 8 == 0 every
    # prefill attention (S x G > 64 rows a KV head) takes flash attention's
    # wgmma prefill, every decode step (G <= 64 rows) its split decode
    expected = {w.__name__: n * new for w, n in kernels.items()}
    expected_by_kernel = {
        w.__name__: {"simt": 0, "prefill_wgmma": n,
                     "decode_split": n * (new - 1)}
        for w, n in kernels.items() if hasattr(w, "launches_by_kernel")}
    decode_ms = 1e3 * stats.decode_s / (new - 1)
    print(f"zoo generate {arch} bf16 full width, batch {B}, prompt {S}, "
          f"{new} new tokens (max_len {SERVE_MAX_LEN}; params initialised on "
          f"the card in {init_s:.3f} s): prefill {1e3 * stats.prefill_s:.3f} "
          f"ms, decode {decode_ms:.3f} ms per step, {stats.tokens_per_s:.1f} "
          f"tokens/s; launches {launches}, expected {expected}; by kernel "
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
    out["busy"] = _busy(lambda: engine.generate(prompts, new),
                        f"zoo generate {arch} {B} x {S} + {new}, bf16")

    reqs = zoo_requests(cfg, ZOO_SEED + 2)
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
    whole = all(launches[w.__name__] % n == 0 if n else
                not launches[w.__name__] for w, n in kernels.items())
    # bf16 at D % 8 == 0: never the SIMT kernel
    whole = whole and not any(c["simt"] for c in serve_by_kernel.values())
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
               serve_launches_by_kernel=serve_by_kernel)
    del engine, params
    torch.cuda.empty_cache()
    return out


def _by_kernel(wrappers) -> dict:
    """Launches by kernel of each wrapper that counts them (flash
    attention's three)."""
    return {w.__name__: dict(w.launches_by_kernel) for w in wrappers
            if hasattr(w, "launches_by_kernel")}


def _reset_launches(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0
        if hasattr(w, "launches_by_kernel"):  # flash attention's three
            w.launches_by_kernel = dict.fromkeys(w.launches_by_kernel, 0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
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
    wkv_kernel.library()
    ssm_kernel.library()
    print("build: " + ", ".join(f"{lib} {sec:.2f} s"
                                for lib, sec in seconds.items())
          + f" (in parallel, {time.perf_counter() - t0:.2f} s wall)",
          flush=True)
    ptxas = {n: info for n, info in _ptxas_lines(
        _build.LOGS.get("flash_attention", "")).items() if "flash_" in n}
    train_ptxas = {n: info for lib in ("lstm_sequence", "lstm_sequence_bwd")
                   for n, info in _ptxas_lines(_build.LOGS.get(lib, "")).items()
                   if any(k in n for k in (TRAIN_FWD_KERNEL, *BWD_KERNELS))}
    for n, info in {**ptxas, **train_ptxas}.items():
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
    wrappers = (fused, fwd_train, bwd, int8)
    rows = {"lstm_sequence_fused": kernel_phase(), **train_kernel_phase(),
            "lstm_cell": cell_kernel_phase(),
            "int8_matmul": int8_kernel_phase(),
            "flash_attention": flash_kernel_phase(),
            "rwkv6_scan": wkv_kernel_phase(),
            "ssm_scan": ssm_kernel_phase()}
    for kname, names in (("lstm_sequence_fwd_train", [TRAIN_FWD_KERNEL]),
                         ("lstm_sequence_bwd", BWD_KERNELS)):
        rows[kname]["ptxas"] = {n: info for n, info in train_ptxas.items()
                                if any(k in n for k in names)}

    # phase 4: the serving path
    fx = load_fixture()
    _reset_launches(*wrappers, flash, wkv, ssm, cell)
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

    # phase 11: the scan path, kernel #5 under ops.lstm_sequence_scan
    scan = scan_phase(fx)

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
    served = {ZOO_ARCH: zoo, RWKV_ARCH: rwkv, ZAMBA_ARCH: zamba}
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
                       "scan": scan["launches"].get(kname, 0)}
        if kname == flash.__name__:
            row["launches_by_kernel_by_path"] = {
                f"{arch}_{what}": run[f"{what}_launches_by_kernel"][kname]
                for arch, run in served.items()
                for what in ("generate", "serve")
                if run[f"{what}_launches"][kname]}
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
    print(json.dumps({"scan": scan}))
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
