"""The port stands alone: it imports without JAX and without the reference
package, and its entry points refuse to fall back to the CPU quietly."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))
assert not loaded, loaded
print("\n".join(names))
"""
# the modules of the training slice, which must be among those imported
TRAINING_MODULES = {"repro_torch.training", "repro_torch.training.optimizer",
                    "repro_torch.training.train_loop",
                    "repro_torch.training.compiled"}
# the modules of the dense transformer's serving path
ZOO_MODULES = {"repro_torch.configs.tinyllama_1_1b",
               "repro_torch.kernels.flash_attention.kernel",
               "repro_torch.kernels.flash_attention.ops",
               "repro_torch.kernels.flash_attention.ref",
               "repro_torch.models.attention", "repro_torch.models.blocks",
               "repro_torch.models.transformer",
               "repro_torch.serving.batching", "repro_torch.serving.engine",
               "repro_torch.launch.serve"}
# the modules of RWKV6's serving path
RWKV_MODULES = {"repro_torch.configs.rwkv6_3b",
                "repro_torch.kernels.rwkv6_scan.kernel",
                "repro_torch.kernels.rwkv6_scan.ops",
                "repro_torch.kernels.rwkv6_scan.ref",
                "repro_torch.models.rwkv"}
# the modules of the Zamba2 hybrid's serving path
ZAMBA2_MODULES = {"repro_torch.configs.zamba2_1_2b",
                  "repro_torch.kernels.ssm_scan.kernel",
                  "repro_torch.kernels.ssm_scan.ops",
                  "repro_torch.kernels.ssm_scan.ref",
                  "repro_torch.models.ssm", "repro_torch.models.hybrid_arch"}
# the modules of the fleet slice
FLEET_MODULES = {"repro_torch.core.drift", "repro_torch.core.stages",
                 "repro_torch.stacked", "repro_torch.kernels._streams",
                 "repro_torch.runtime.executor", "repro_torch.runtime.modules",
                 "repro_torch.streams.sources", "repro_torch.serving.quantize",
                 "repro_torch.launch.edge_cloud"}
# the modules of the request and placement planes
PLANE_MODULES = {"repro_torch.serving.query_plane",
                 "repro_torch.runtime.placement"}
# the modules of the chaos and health planes
CHAOS_MODULES = {"repro_torch.runtime.faults", "repro_torch.runtime.health",
                 "repro_torch.core.scenarios"}
# the modules of the dense trio and the MoE pair
ZOO_REST_MODULES = {"repro_torch.models.moe",
                    "repro_torch.configs.h2o_danube_3_4b",
                    "repro_torch.configs.codeqwen1_5_7b",
                    "repro_torch.configs.nemotron_4_15b",
                    "repro_torch.configs.grok_1_314b",
                    "repro_torch.configs.kimi_k2_1t_a32b"}
# the modules of the encoder-decoder and the VLM
ENCDEC_VLM_MODULES = {"repro_torch.models.encdec",
                      "repro_torch.configs.seamless_m4t_medium",
                      "repro_torch.configs.paligemma_3b"}
# the modules of the zoo's training
ZOO_TRAIN_MODULES = {"repro_torch.training.checkpoint",
                     "repro_torch.training.metrics",
                     "repro_torch.launch.train",
                     "repro_torch.core.weighting"}
# the zoo's analysis tools: the dry run on meta and the kernels' meta ops
ANALYSIS_MODULES = {"repro_torch.launch.analysis",
                    "repro_torch.launch.dryrun",
                    "repro_torch.launch.mesh", "repro_torch.launch.steps",
                    "repro_torch.kernels._meta"}

# the launcher's calibrated mode and the legacy trainer
CALIBRATED_MODULES = {"repro_torch.launch.calibrate",
                      "repro_torch.streams.csv_source",
                      "repro_torch.streams.injection",
                      "repro_torch.runtime.modules"}


def test_port_imports_with_jax_and_reference_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH=str(SRC)), timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 25  # every subpackage and module
    assert TRAINING_MODULES <= names
    assert ZOO_MODULES <= names
    assert RWKV_MODULES <= names
    assert ZAMBA2_MODULES <= names
    assert FLEET_MODULES <= names
    assert PLANE_MODULES <= names
    assert CHAOS_MODULES <= names
    assert ZOO_REST_MODULES <= names
    assert ENCDEC_VLM_MODULES <= names
    assert ZOO_TRAIN_MODULES <= names
    assert ANALYSIS_MODULES <= names
    assert CALIBRATED_MODULES <= names


def test_forecaster_without_device_raises_without_cuda(monkeypatch):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import lstm_forecaster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lstm_forecaster(get_config("lstm-paper"), epochs=1, batch_size=8)
    fc = lstm_forecaster(get_config("lstm-paper"), epochs=1, batch_size=8,
                         device="cpu")
    assert fc.engine.device == torch.device("cpu")


def test_calibrated_and_legacy_entry_points_raise_without_cuda(monkeypatch):
    """``run_calibrated``, ``calibrate``, the legacy ``fit`` and
    ``lstm_forecaster(compiled=False)`` refuse the CPU unless asked for
    it."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import lstm_forecaster
    from repro_torch.launch import edge_cloud
    from repro_torch.launch.calibrate import calibrate
    from repro_torch.models.model import get_model
    from repro_torch.training import fit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("lstm-paper")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        edge_cloud.run_calibrated(edge_cloud.parse_args(["--fast"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate(fast=True)
    data = {"x": np.zeros((3, 5, 5), np.float32),
            "y": np.zeros((3, 1), np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(get_model(cfg), data, epochs=1, batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lstm_forecaster(cfg, epochs=1, batch_size=2, compiled=False)
    fc = lstm_forecaster(cfg, epochs=1, batch_size=2, compiled=False,
                         device="cpu")
    params, wall = fc.train(data, None, 0)
    assert params["lstm"]["kernel"].device.type == "cpu" and wall > 0


def test_params_and_init_without_device_raise_without_cuda(monkeypatch):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import get_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"a": np.zeros(2, np.float32)})
    model = get_model(get_config("lstm-paper"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(torch.Generator().manual_seed(0))


def test_serving_entry_points_raise_without_cuda(monkeypatch):
    """``Engine``, the dense model's init and cache, and the serve launcher
    refuse the CPU unless asked for it; the flash kernel's wrapper refuses
    a CPU tensor (``attend`` on a CPU tensor is the plain path the caller
    chose by putting the tensor there)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch import serve
    from repro_torch.models.attention import attend
    from repro_torch.models.model import get_model
    from repro_torch.serving.engine import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tinyllama-1.1b").reduced()
    model = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
    params = model.init(gen, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params, max_len=8)
    assert Engine(cfg, params, max_len=8, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(serve.parse_args(["--arch", "tinyllama-1.1b"]))
    q = torch.zeros(1, 2, 4, 32)
    kv = torch.zeros(1, 2, 2, 32)
    pos = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.flash_attention(q, kv, kv, pos, pos)
    assert attend(q, kv, kv, pos, pos).shape == q.shape


def test_rwkv_entry_points_raise_without_cuda(monkeypatch):
    """RWKV6's init and cache and its serve launcher refuse the CPU unless
    asked for it; the WKV kernel's wrapper refuses a CPU tensor, and
    ``ops.wkv`` on a CPU tensor is the plain path the caller chose."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_scan import kernel, ops
    from repro_torch.launch import serve
    from repro_torch.models.model import get_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = get_model(get_config("rwkv6-3b").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(serve.parse_args(["--arch", "rwkv6-3b"]))
    x = torch.zeros(1, 2, 3, 8)
    u = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.rwkv6_scan(x, x, x, x, u)
    y, state = ops.wkv(x, x, x, x, u)
    assert y.shape == x.shape and state.shape == (1, 3, 8, 8)


def test_zamba2_entry_points_raise_without_cuda(monkeypatch):
    """The hybrid's init and cache and its serve launcher refuse the CPU
    unless asked for it; the selective-scan kernel's wrapper refuses a CPU
    tensor, and ``ops.selective_scan`` on a CPU tensor is the plain path
    the caller chose."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import kernel, ops
    from repro_torch.launch import serve
    from repro_torch.models.model import get_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = get_model(get_config("zamba2-1.2b").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(serve.parse_args(["--arch", "zamba2-1.2b"]))
    x = torch.zeros(1, 2, 3, 8)
    bc = torch.zeros(1, 2, 4)
    dt = torch.zeros(1, 2, 3)
    a = torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.ssm_scan(x, bc, bc, dt, a, a)
    y, state = ops.selective_scan(x, bc, bc, dt, a, a)
    assert y.shape == x.shape and state.shape == (1, 3, 8, 4)


def test_placement_entry_points_raise_without_cuda(monkeypatch):
    """``LoadForecaster`` and a proactive ``PlacementController``'s default
    forecaster refuse the CPU unless asked for it; a reactive controller
    builds no forecaster and needs no device."""
    import torch

    from repro_torch.runtime import LoadForecaster, PlacementController

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LoadForecaster()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PlacementController()
    assert PlacementController(proactive=False).forecaster is None
    ctl = PlacementController(device="cpu")
    assert ctl.forecaster.device == torch.device("cpu")
