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
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_with_jax_and_reference_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH=str(SRC)), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20  # every subpackage and module


def test_forecaster_without_device_raises_without_cuda(monkeypatch):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import lstm_forecaster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lstm_forecaster(get_config("lstm-paper"), epochs=1, batch_size=8)
    fc = lstm_forecaster(get_config("lstm-paper"), epochs=1, batch_size=8,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="training slice"):
        fc.train({}, None, 0)


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
