#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the device: CUDA must be present; prints the card's name and
   ``nvidia-smi``'s name and power limit;
2. the build: compiles every CUDA kernel of the port with ``nvcc`` from the
   sources in this checkout;
3. the kernels: each kernel against its plain PyTorch version on the card
   at the main path's shapes and a few edge shapes, then timed beside the
   plain version and the library call that computes the same function;
4. the main path: the paper's per-window loop (``HybridStreamAnalytics.run``)
   on the card in every weighting mode, serving the stream with the models
   the JAX reference published (``tests/data/torch_parity_lstm_paper.npz``);
   every per-window record must match the reference's, and the launch
   counters must show that every predict went through the kernels;
5. where the time goes: ``torch.profiler`` gives the kernel's own device
   time and the device's idle share over a warm drive of the main path.

It prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  The helpers above ``main`` need no
GPU; the port's CPU tests drive the same main path through them.
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

# kernel phase: (B, T, F, H, dtype); H=None is the largest H that fits
MAIN_SHAPE = (250, 5, 5, 40)
KERNEL_CASES = [
    (*MAIN_SHAPE, "float32"),
    (1, 1, 1, 8, "float32"),
    (129, 7, 3, 40, "float32"),
    (1024, 5, 5, 40, "float32"),
    (250, 5, 5, None, "float32"),
    (*MAIN_SHAPE, "bfloat16"),
]
KERNEL_ATOL = 1e-5
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


def port_stream(setup: dict):
    """The scaled windowed stream of the fixture's setup, from the port's
    own sources, scaler and windows."""
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
    return WindowedStream(scaler.transform(stream), plan)


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


def _lstm_bound(B, T, F, H):
    """Least time for one call at (B,T,F,H) float32: each input read once,
    each output written once, over the memory rate; the two products over
    the float32 rate.  Returns (ms, "bytes" | "operations")."""
    nbytes = 4 * (B * T * F + F * 4 * H + H * 4 * H + 4 * H + 2 * B * H)
    flops = 2 * B * T * (F + H) * 4 * H
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def kernel_phase() -> dict:
    """The fused LSTM kernel against its plain version at every case, then
    timed at the main path's shape.  Returns the numbers of its row."""
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
    lstm = torch.nn.LSTM(F, H, batch_first=True).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.T)
        lstm.weight_hh_l0.copy_(wh.T)
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
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


def _device_intervals(prof):
    """(name, start_us, end_us) of every device-side event of a profile:
    kernels, copies and memsets."""
    import torch

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_phase(fx: dict) -> dict:
    """Where the time goes, from ``torch.profiler``: the kernel's own device
    time per call at the main path's shape, and the device's busy time over
    a profiled drive of the main path (all modes, warm), against the wall of
    an unprofiled warm drive.  Measures only; a profile with no device
    events reports "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    x, wx, wh, b = _kernel_inputs(*MAIN_SHAPE, "float32", seed=100)
    with torch.inference_mode():
        for _ in range(10):
            lstm_kernel.lstm_sequence_fused(x, wx, wh, b)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(100):
                lstm_kernel.lstm_sequence_fused(x, wx, wh, b)
            torch.cuda.synchronize()
    kern = [end - start for name, start, end in _device_intervals(prof)
            if "lstm_sequence_kernel" in name]
    device_ms = statistics.median(kern) / 1e3 if kern else None

    t0 = time.perf_counter()
    run_main_path(fx, "cuda")
    torch.cuda.synchronize()
    path_wall_s = time.perf_counter() - t0
    with profile(activities=acts) as prof:
        run_main_path(fx, "cuda")
        torch.cuda.synchronize()
    spans = sorted((s, e) for _, s, e in _device_intervals(prof))
    busy_us, covered = 0.0, float("-inf")
    for s, e in spans:  # length of the union of the device intervals
        busy_us += max(0.0, e - max(s, covered))
        covered = max(covered, e)
    by_name: dict = {}
    for name, s, e in _device_intervals(prof):
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    if not kern or not spans:
        print("profile: the profiler saw no device events; device time not "
              "measured")
        return {"device_ms": None}
    print(f"profile: kernel device time at {MAIN_SHAPE} {device_ms:.6f} ms "
          f"(median of {len(kern)}); main path device busy "
          f"{busy_us / 1e3:.3f} ms in {len(spans)} device events against "
          f"{1e3 * path_wall_s:.3f} ms of unprofiled wall: idle share "
          f"{1 - busy_us / 1e6 / path_wall_s:.4f}")
    for name, us in top:
        print(f"profile: device time {us / 1e3:.3f} ms  {name[:90]}")
    return {"device_ms": device_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    _import_port()
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel

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

    t0 = time.perf_counter()
    lstm_kernel.library()
    print(f"build: lstm_sequence {time.perf_counter() - t0:.2f} s", flush=True)

    row = kernel_phase()

    fx = load_fixture()
    lstm_kernel.lstm_sequence_fused.launches = 0
    t0 = time.perf_counter()
    results = run_main_path(fx, "cuda")
    wall = time.perf_counter() - t0
    launches = lstm_kernel.lstm_sequence_fused.launches
    n_windows = int(fx["setup/n_windows"])
    # window 0 only trains: its 2 eval predicts; every later window adds
    # batch and speed inference
    expected = sum(2 * n_windows + 2 * len(fx[f"records/{m}"]) for m in MODES)
    worst = check_records(fx, results, rtol=1e-4, atol=1e-4)
    for mode, res in results.items():
        for r in res.records:
            print(f"main path {mode} window {r.window}: batch_infer "
                  f"{1e3 * r.t_batch_infer:.3f} ms, speed_infer "
                  f"{1e3 * r.t_speed_infer:.3f} ms, hybrid_infer "
                  f"{1e3 * r.t_hybrid_infer:.3f} ms")
    print(f"main path: {len(MODES)} modes in {wall:.3f} s, records match the "
          f"reference (worst relative RMSE error {worst:.3g}); "
          f"lstm_sequence_fused launches {launches}, expected {expected}",
          flush=True)
    if launches != expected or launches == 0:
        raise AssertionError(f"lstm_sequence_fused launched {launches} times "
                             f"on the main path, expected {expected}")
    row.update(profile_phase(fx))

    print(json.dumps({"kernels": [{
        "name": "lstm_sequence_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/lstm_cell/csrc/lstm_sequence.cu",
        "replaces": "src/repro/kernels/lstm_cell/kernel.py:131",
        "launches": launches,
        **row,
        "kernel_ms": row["ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
