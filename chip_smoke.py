#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the device: CUDA must be present; prints the card's name and
   ``nvidia-smi``'s name and power limit;
2. the build: compiles every CUDA library of the port with ``nvcc`` from the
   sources in this checkout, one ``nvcc`` per library, all at once;
3. the kernels: each kernel against its plain PyTorch version on the card
   at the main paths' shapes and a few edge shapes (the backward also run
   twice, bit for bit), then timed beside the plain version and the library
   call that computes the same function;
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
6. where the time goes: ``torch.profiler`` gives each kernel's own device
   time, and the device's busy time and idle share over a warm drive of the
   serving path and over one warm speed fit.

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

# kernel phase: (B, T, F, H, dtype); H=None is the largest H that fits.
# Every row count the main paths give the serving kernel is a case: 250 and
# 245 (the windows), 256 and 245 (window 0's mask check, padded and not),
# 2048 and 1595 (the pretrain's mask check)
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
]
KERNEL_ATOL = 1e-5
# the training pair: the speed fit's and the pretrain's step shapes, the
# reference's gradient-test shapes, the backward's largest H (H=None), and
# bf16 x
TRAIN_SHAPES = ((64, 5, 5, 40), (256, 5, 5, 40))
TRAIN_CASES = [
    (*TRAIN_SHAPES[0], "float32"),
    (*TRAIN_SHAPES[1], "float32"),
    (33, 7, 3, 16, "float32"),
    (1, 1, 2, 8, "float32"),
    (130, 12, 4, 24, "float32"),
    (64, 5, 5, None, "float32"),
    (*TRAIN_SHAPES[0], "bfloat16"),
]
# the backward's tolerance is the reference's own for its gradient tests
# (tests/test_kernels.py); the card sums in another order than the plain
# version
BWD_ATOL = BWD_RTOL = 2e-5
# the trained models and records on the card against the reference's
TRAIN_ATOL = 1e-4
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor
# cores, at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


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


def replay_trainer(speed_models, device):
    """A ``Forecaster.train`` that installs published speed models in window
    order, as the edge installs the models the cloud publishes.  Its wall is
    the transfer of the model onto the device."""
    from repro_torch.convert import params_from_numpy

    models = iter(speed_models)

    def train(data, params, key):
        t0 = time.perf_counter()
        return params_from_numpy(next(models), device), time.perf_counter() - t0

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
        fc = dataclasses.replace(fc, train=replay_trainer(speed, device))
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


def draw_replay_trainer(engine, draws, device):
    """A ``Forecaster.train`` that trains every window itself, from draws
    made elsewhere: window t's (init params, permutation indices), taken in
    window order, go to ``engine.fit_window``.  Its wall is the fit's,
    synced.  Returns (train, published), where ``published`` collects the
    models it trains."""
    import torch

    from repro_torch.convert import params_from_numpy

    todo = iter(draws)
    published = []

    def train(data, params, key):
        init, idx = next(todo)
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
        device)
    batch_params, batch_wall = pretrain_batch_model(
        dataclasses.replace(fc_batch, train=train),
        make_supervised(hist, int(setup["lag"]), 0), int(setup["batch_key"]))
    results, speed = {}, {}
    for name in modes:
        mode, solver = MODES[name]
        fc = lstm_forecaster(cfg, epochs=int(setup["speed_epochs"]),
                             batch_size=int(setup["speed_batch_size"]),
                             device=device)
        train, speed[name] = draw_replay_trainer(fc.engine, speed_draws(fx),
                                                 device)
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


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def _kernel_inputs(B, T, F, H, dtype, seed):
    import torch

    rng = np.random.default_rng(seed)
    x = rng.random((B, T, F))  # min-max scaled inputs lie in [0, 1]
    wx = rng.normal(size=(F, 4 * H)) * F**-0.5
    wh = rng.normal(size=(H, 4 * H)) * H**-0.5
    b = rng.normal(size=(4 * H,)) * 0.1
    dev = torch.device("cuda")
    return (torch.tensor(x, dtype=getattr(torch, dtype), device=dev),
            *(torch.tensor(a, dtype=torch.float32, device=dev)
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


def _bound(nbytes: float, flops: float):
    """Least time for work that moves ``nbytes`` and does ``flops`` float32
    operations: the larger of the two over the card's peak rates.  Returns
    (ms, "bytes" | "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
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
    for i, (B, T, F, H, dtype) in enumerate(KERNEL_CASES):
        H = lstm_kernel.max_hidden(F) if H is None else H
        x, wx, wh, b = _kernel_inputs(B, T, F, H, dtype, seed=i)
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
        print(f"kernel lstm_sequence_fused B={B} T={T} F={F} H={H} {dtype}: "
              f"max|dh|={errs[0]:.3g} max|dc|={errs[1]:.3g} ({limit}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(
                f"lstm_sequence_fused disagrees with its plain version at "
                f"B={B} T={T} F={F} H={H} {dtype}: {errs}")

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
    bound_ms, bound_by = _lstm_bound(B, T, F, H)
    print(f"timing at {MAIN_SHAPE} float32 (median of 200, CUDA events): "
          f"kernel {kernel_ms:.6f} ms, plain {plain_ms:.6f} ms, "
          f"torch.nn.LSTM {library_ms:.6f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by})", flush=True)
    return {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _train_case(B, T, F, H, dtype, seed):
    """Inputs of the training pair at one case: x and the weights, the
    residuals of the training forward on the card, and random cotangents
    dh, dc of the final state."""
    import torch

    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel

    x, wx, wh, b = _kernel_inputs(B, T, F, H, dtype, seed)
    res = lstm_kernel.lstm_sequence_fwd_train(x, wx, wh, b)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dh = torch.randn((B, H), generator=g, device="cuda")
    dc = torch.randn((B, H), generator=g, device="cuda")
    return (x, wx, wh, b), res, dh, dc


def train_kernel_phase() -> dict:
    """The training pair against its plain versions at every case, the
    backward's rerun bit for bit, then both timed at the speed fit's and
    the pretrain's step shapes beside their plain versions and cuDNN.
    Returns the numbers of their rows."""
    import torch

    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.lstm_cell import ref

    max_fwd = max_bwd = 0.0
    for i, (B, T, F, H, dtype) in enumerate(TRAIN_CASES):
        H = lstm_kernel.max_hidden_bwd(F) if H is None else H
        (x, wx, wh, b), res, dh, dc = _train_case(B, T, F, H, dtype, 200 + i)
        res_ref = ref.lstm_sequence_fwd_train_ref(x, wx, wh, b)
        fwd_errs = [float((k - r).abs().max()) for k, r in zip(res, res_ref)]
        grads = lstm_kernel.lstm_sequence_bwd(x, *res, wx, wh, dh, dc)
        again = lstm_kernel.lstm_sequence_bwd(x, *res, wx, wh, dh, dc)
        grads_ref = ref.lstm_sequence_bwd_ref(x, *res, wx, wh, dh, dc)
        torch.cuda.synchronize()
        bwd_errs = [float((k - r).abs().max()) for k, r in zip(grads, grads_ref)]
        fwd_ok = max(fwd_errs) <= KERNEL_ATOL
        bwd_ok = all(bool(((k - r).abs() <= BWD_ATOL + BWD_RTOL * r.abs()).all())
                     for k, r in zip(grads[1:], grads_ref[1:]))
        if dtype == "float32":
            bwd_ok = bwd_ok and bool(((grads[0] - grads_ref[0]).abs() <= BWD_ATOL
                                      + BWD_RTOL * grads_ref[0].abs()).all())
            max_fwd, max_bwd = max(max_fwd, *fwd_errs), max(max_bwd, *bwd_errs)
        else:
            # dx goes back in x's type: held to one bf16 step of the value
            dxk, dxr = grads[0].to(x.dtype).float(), grads_ref[0].to(x.dtype).float()
            bwd_ok = bwd_ok and bool(
                ((dxk - dxr).abs() <= 2.0**-7 * dxr.abs() + KERNEL_ATOL).all())
        same = all(torch.equal(k, r) for k, r in zip(grads, again))
        print(f"kernel lstm_sequence_fwd_train B={B} T={T} F={F} H={H} {dtype}: "
              f"max|d gates, c_seq, h_seq|={max(fwd_errs):.3g} "
              f"(<= {KERNEL_ATOL}) {'ok' if fwd_ok else 'FAIL'}")
        print(f"kernel lstm_sequence_bwd B={B} T={T} F={F} H={H} {dtype}: "
              f"max|d dx, dwx, dwh, db|="
              f"{', '.join(f'{e:.3g}' for e in bwd_errs)} (atol = rtol = "
              f"{BWD_ATOL}{'; dx to one bf16 step' if dtype != 'float32' else ''}"
              f") {'ok' if bwd_ok else 'FAIL'}; rerun "
              f"{'bit-identical' if same else 'DIFFERS'}", flush=True)
        if not (fwd_ok and bwd_ok and same):
            raise AssertionError(
                f"training pair at B={B} T={T} F={F} H={H} {dtype}: forward "
                f"{fwd_errs}, backward {bwd_errs}, rerun identical {same}")

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
                       "library_ms": _median_ms(lib), "bound_ms": bound_ms,
                       "bound_by": bound_by}
            rows[name]["by_batch"][B] = numbers
            print(f"timing {name} at {(B, T, F, H)} float32 (median of 200, "
                  f"CUDA events): kernel {numbers['ms']:.6f} ms, plain "
                  f"{numbers['plain_ms']:.6f} ms, torch.nn.LSTM "
                  f"{numbers['library_ms']:.6f} ms, bound {bound_ms:.6f} ms "
                  f"({bound_by})", flush=True)
    for row in rows.values():  # the row's own numbers: the speed fit's shape
        row.update(row["by_batch"][TRAIN_SHAPES[0][0]])
    return rows


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


def _kernel_device_ms(fn, names, calls=100):
    """Median device time per call of each kernel in ``names`` (a substring
    of its name), over ``calls`` profiled calls of ``fn`` after warm-up;
    None where the profiler saw none."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()

    def many():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    spans = _profile(many)
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
    return {"wall_s": wall_s, "busy_ms": busy_us / 1e3, "idle_share": idle}


def profile_phase(fx: dict) -> dict:
    """Where the time goes, from ``torch.profiler``: each kernel's own
    device time per call (the serving kernel at the serving shape, the
    training pair at both step shapes), the device's busy time over a warm
    drive of the serving path, over one warm speed fit and over one warm
    pretrain.  Measures only;
    where the profiler sees no device events it reports "not measured"."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import lstm_forecaster, make_supervised
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel

    out = {}
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
        fwd = _kernel_device_ms(
            lambda: lstm_kernel.lstm_sequence_fwd_train(x, wx, wh, b),
            ["lstm_sequence_train_kernel"])["lstm_sequence_train_kernel"]
        bwd = _kernel_device_ms(
            lambda: lstm_kernel.lstm_sequence_bwd(x, *res, wx, wh, dh, dc),
            ["lstm_sequence_bwd_kernel", "lstm_sequence_wgrad_kernel"])
        pair = (None if None in bwd.values() else sum(bwd.values()))
        out.setdefault("lstm_sequence_fwd_train", {})[B] = {"device_ms": fwd}
        out.setdefault("lstm_sequence_bwd", {})[B] = {
            "device_ms": pair, "device_ms_parts": bwd}
        print(f"profile: device time at {(B, T, F, H)} (median of 100): "
              f"lstm_sequence_train_kernel {fwd} ms; lstm_sequence_bwd_kernel "
              f"{bwd['lstm_sequence_bwd_kernel']} ms + "
              f"lstm_sequence_wgrad_kernel {bwd['lstm_sequence_wgrad_kernel']}"
              f" ms = {pair} ms")

    def serve():
        run_main_path(fx, "cuda")
        torch.cuda.synchronize()

    out["serving"] = _busy(serve, "serving path, 5 modes")

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


def _reset_launches(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0


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
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.training.optimizer import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    print(smi, flush=True)

    # phase 2: every library, one nvcc each, all at once
    t0 = time.perf_counter()
    seconds = _build.build_all(lstm_kernel.LIBRARIES)
    lstm_kernel.library()
    lstm_kernel.bwd_library()
    print("build: " + ", ".join(f"{lib} {sec:.2f} s"
                                for lib, sec in seconds.items())
          + f" (in parallel, {time.perf_counter() - t0:.2f} s wall)",
          flush=True)

    # phase 3: the kernels against their plain versions, and timed
    fused = lstm_kernel.lstm_sequence_fused
    fwd_train = lstm_kernel.lstm_sequence_fwd_train
    bwd = lstm_kernel.lstm_sequence_bwd
    rows = {"lstm_sequence_fused": kernel_phase(), **train_kernel_phase()}

    # phase 4: the serving path
    fx = load_fixture()
    _reset_launches(fused, fwd_train, bwd)
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
    if fwd_train.launches or bwd.launches:
        raise AssertionError("the serving path launched a training kernel")

    # phase 5: the training path
    expected = expected_training_launches(fx)
    _reset_launches(fused, fwd_train, bwd)
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

    # phase 6: where the time goes
    prof = profile_phase(fx)

    sources = "src/repro_torch/kernels/lstm_cell/csrc/"
    replaces = "src/repro/kernels/lstm_cell/kernel.py:"
    meta = {
        "lstm_sequence_fused": (sources + "lstm_sequence.cu", replaces + "131"),
        "lstm_sequence_fwd_train": (sources + "lstm_sequence.cu",
                                    replaces + "216"),
        "lstm_sequence_bwd": (sources + "lstm_sequence_bwd.cu",
                              replaces + "330"),
    }
    kernels = []
    for kname, (source, repl) in meta.items():
        row = rows[kname]
        device = prof[kname]
        if kname != "lstm_sequence_fused":
            for B, numbers in row["by_batch"].items():
                numbers.update(device[B])
            device = device[TRAIN_SHAPES[0][0]]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": repl, "launches": training_launches[kname],
            "launches_by_path": {
                "serving": serving_launches if kname == fused.__name__ else 0,
                "training": training_launches[kname]},
            **row, "kernel_ms": row["ms"], "device_ms": device["device_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
