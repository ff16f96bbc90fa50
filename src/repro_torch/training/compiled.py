"""The speed layer's trainer for one stream: ``CompiledForecaster``.

The port of ``src/repro/training/compiled.py``'s single-stream path.  As in
the reference, every window is padded up to a fixed shape bucket
(``bucket_examples``: the next power-of-two multiple of the batch size) with
a per-example validity mask threaded into the model's ``loss_fn``, so the
ragged final batch trains and padding never biases the gradient; the first
padded window of each bucket checks that the loss honours the mask.

Where the reference runs the whole fit as one jitted ``lax.scan``, the port
runs its ``epochs x steps`` train steps in a Python loop: each step gathers
its minibatch on the device from a pre-drawn ``(epochs * steps,
batch_size)`` permutation index tensor, takes the gradient through the LSTM
training kernels and updates the params and moments in place.  No step reads
a device value on the host; the per-step losses reach the host once, after
the loop, as ``last_losses``.  A CUDA-graph capture of a bucket's loop, the
counterpart of the reference's one dispatch per fit, is not done yet.

``predict`` serves an int8-synced model (``QTensor`` leaves) as it is,
through ``models.lstm._forward_int8``: the reference's
dequantize-once cache (``_serving_params``) exists only because the Pallas
interpreter runs the int8 kernel slowly off the TPU, and has no counterpart
here, where the card runs the int8 kernel and the CPU its plain version.
The fleet trainer (``FleetForecaster``) comes with its own slice.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import Model
from repro_torch.training.optimizer import adamw, tree_map
from repro_torch.training.train_loop import make_train_step

Params = Any


def bucket_examples(n: int, batch_size: int) -> int:
    """Fixed-shape bucket for an ``n``-example window: the next power-of-two
    multiple of ``batch_size``.  Buckets grow geometrically, so a stream of
    arbitrary window sizes touches only O(log n) shapes, and the paper's
    fixed-size windows (150/250 records) always reuse one."""
    if n <= 0:
        raise ValueError(f"cannot bucket an empty window (n={n})")
    per = max(1, math.ceil(n / batch_size))
    return batch_size * (1 << max(0, math.ceil(math.log2(per))))


def pad_to_bucket(data: Dict[str, np.ndarray], nb: int) -> Dict[str, np.ndarray]:
    """Zero-pad every array's leading dim to ``nb`` and attach a f32 validity
    ``mask`` (1 for real examples, 0 for padding)."""
    n = len(next(iter(data.values())))
    if n > nb:
        raise ValueError(f"window of {n} examples exceeds bucket {nb}")
    out = {}
    for k, v in data.items():
        v = np.asarray(v)
        if n < nb:
            pad = np.zeros((nb - n,) + v.shape[1:], v.dtype)
            v = np.concatenate([v, pad], axis=0)
        out[k] = v
    mask = np.zeros((nb,), np.float32)
    mask[:n] = 1.0
    out["mask"] = mask
    return out


class CompiledForecaster:
    """Speed-layer trainer with a fixed-shape, host-sync-free step loop.

    Matches the ``Forecaster`` protocol (``train(data, params, key) ->
    (params, wall_s)``; ``predict(params, x) -> np.ndarray``) so it drops
    into ``SpeedTraining`` and the executor unchanged.  ``predict_fn(params,
    x)`` is the host-level predict it serves with.  Training runs on
    ``device`` (the current CUDA device by default).

    ``train`` draws its randomness from ``torch.Generator().manual_seed(key)``
    and hands it to ``fit_window``, which takes the draws explicitly: a
    caller holding another framework's draws (the reference's init and
    permutations) trains from those instead.

    Counters: ``fits`` and ``steps`` since construction."""

    def __init__(
        self,
        model: Model,
        *,
        epochs: int,
        batch_size: int,
        lr: float = 1e-3,
        warm_start: bool = False,
        predict_fn: Optional[Callable[[Params, np.ndarray], np.ndarray]] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.model = model
        self.epochs = int(epochs)
        self.batch_size = int(batch_size)
        self.warm_start = warm_start
        self.opt = adamw(lr)
        self.device = resolve_device(device)
        self._train_step = make_train_step(model, self.opt)
        self._predict_fn = predict_fn
        self._mask_checked: set = set()
        self.fits = 0
        self.steps = 0
        self.last_losses: Optional[np.ndarray] = None

    def permutations(self, nb: int, generator: torch.Generator
                     ) -> torch.Tensor:
        """The fit's minibatch indices, (epochs * steps, batch_size) int64 on
        the CPU: one ``torch.randperm(nb)`` per epoch over the padded
        bucket, cut into ``steps = nb // batch_size`` rows."""
        perms = torch.stack([torch.randperm(nb, generator=generator)
                             for _ in range(self.epochs)])
        return perms.reshape(-1, self.batch_size)

    def _check_mask_honored(self, data: Dict[str, np.ndarray],
                            padded: Dict[str, np.ndarray], params: Params,
                            nb: int) -> None:
        """Once per bucket: when a window actually needed padding, the
        masked loss on the padded batch must equal the plain loss on the
        unpadded batch.  A model whose ``loss_fn`` ignores the validity mask
        would otherwise silently average its padding rows into every
        gradient."""
        n = len(next(iter(data.values())))
        if n == nb or nb in self._mask_checked:
            return
        dev = self.device
        with torch.no_grad():
            plain, _ = self.model.loss_fn(
                params, {k: torch.as_tensor(v, device=dev)
                         for k, v in data.items()})
            masked, _ = self.model.loss_fn(
                params, {k: torch.as_tensor(v, device=dev)
                         for k, v in padded.items()})
        plain, masked = float(plain), float(masked)
        if not np.allclose(plain, masked, rtol=1e-4, atol=1e-6):
            raise ValueError(
                "model.loss_fn ignores the per-example validity 'mask': "
                f"padded-batch loss {masked:.6g} != unpadded loss "
                f"{plain:.6g}. Fixed-shape bucketing would bias training "
                "toward the padding; thread batch['mask'] into the loss as "
                "repro_torch.models.lstm.loss_fn does.")
        self._mask_checked.add(nb)

    def fit_window(self, data: Dict[str, np.ndarray], init_params: Params,
                   idx: torch.Tensor) -> Params:
        """Train from ``init_params`` over the window's padded bucket, one
        step per row of ``idx`` ((epochs * steps, batch_size) indices into
        the bucket).  The params are updated in place: ``init_params`` is
        the returned, trained tree.  Ends with the device synchronized."""
        dev = self.device
        n = len(next(iter(data.values())))
        nb = bucket_examples(n, self.batch_size)
        shape = (self.epochs * (nb // self.batch_size), self.batch_size)
        if tuple(idx.shape) != shape:
            raise ValueError(f"fit_window: idx is {tuple(idx.shape)}, the "
                             f"bucket of {nb} needs {shape}")
        padded = pad_to_bucket(data, nb)
        self._check_mask_honored(data, padded, init_params, nb)
        x, y, mask = (torch.as_tensor(padded[k], device=dev)
                      for k in ("x", "y", "mask"))
        idx = idx.to(device=dev, dtype=torch.long)
        params, opt_state = init_params, self.opt.init(init_params)
        losses = []
        for ib in idx:
            batch = {"x": x[ib], "y": y[ib], "mask": mask[ib]}
            params, opt_state, metrics = self._train_step(params, opt_state,
                                                          batch)
            losses.append(metrics["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.last_losses = torch.stack(losses).cpu().numpy()
        self.fits += 1
        self.steps += len(losses)
        return params

    # -- Forecaster protocol -------------------------------------------------

    def train(self, data: Dict[str, np.ndarray], params: Optional[Params],
              key: int) -> Tuple[Params, float]:
        """Fit the window from the draws of ``key``: its permutations, and
        fresh init params or, on a warm start with ``params`` given, a
        private copy of them (the update is in place, and the caller's tree
        is the model being served; ``SpeedTraining`` hands it a float tree).
        Returns (params, synced wall seconds)."""
        t0 = time.perf_counter()
        n = len(next(iter(data.values())))
        nb = bucket_examples(n, self.batch_size)
        gen = torch.Generator().manual_seed(int(key))
        idx = self.permutations(nb, gen)
        if self.warm_start and params is not None:
            init = tree_map(lambda p: p.detach().to(self.device, copy=True),
                            params)
        else:
            init = self.model.init(gen, self.device)
        params = self.fit_window(data, init, idx)
        return params, time.perf_counter() - t0

    def predict(self, params: Params, x: np.ndarray) -> np.ndarray:
        """``predict_fn(params, x)``: a float tree or an int8 (``QTensor``)
        tree, served as it is."""
        if self._predict_fn is None:
            raise ValueError("CompiledForecaster built without a predict_fn")
        return self._predict_fn(params, x)
