"""The speed layer's trainers: ``CompiledForecaster`` for one stream and
``FleetForecaster`` for a fleet of streams.

The port of ``src/repro/training/compiled.py``.  As in
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

``FleetForecaster`` trains one speed model per stream of a fleet in one
stacked tree: every leaf carries a leading stream axis, padded up to
``bucket_streams(S)`` with slots whose data and mask are zero (their loss
and gradient are exactly zero, their params never move), and each step of
the fit is one launch of the LSTM training kernels for the whole fleet
(their stream axis), whatever S.  The step differentiates the sum of the
per-stream losses, so each stream gets exactly its own gradient, and the
optimizer clips each stream by its own norm (the reference's ``jax.vmap``
of its fit).  Stream ``i`` draws its init and permutations from ``keys[i]``
as ``CompiledForecaster.train`` draws them, so it equals a sequential fit
with that key; ``fit_fleet_window`` takes the draws explicitly.  The fit
hands back lazy ``FleetParamView`` handles of the stacked output, and
``predict_fleet`` serves a whole fleet's predictions in one launch of the
serving kernel (or of each int8 product).  Window data is staged in
persistent host buffers per (stream bucket, shape bucket) and shipped in
one copy each.  The reference's device mesh (``stream_mesh_devices``, the
stream shardings) has no counterpart on one H100 and is not ported.
"""
from __future__ import annotations

import math
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.quantize import QTensor
from repro_torch.training.optimizer import adamw, tree_map
from repro_torch.stacked import (  # noqa: F401
    FleetParamView,
    _FleetStack,
    materialize_params,
)
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


def _next_pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(n, 1))))


def bucket_streams(s: int) -> int:
    """Stream-count bucket for an ``s``-stream fleet: the next power of two.
    A fleet of any size, or any drift-gated subset of it, touches only
    O(log S) stacked shapes."""
    if s <= 0:
        raise ValueError(f"cannot bucket an empty fleet (s={s})")
    return _next_pow2(s)


def _staging_buffer(cache: Dict[Tuple, np.ndarray], key: Tuple,
                    shape: Tuple[int, ...], dtype) -> Tuple[np.ndarray, bool]:
    """Get-or-allocate a persistent host staging buffer; returns the buffer
    and whether this call allocated it (the caller counts allocations)."""
    buf = cache.get(key)
    if buf is not None:
        return buf, False
    buf = np.zeros(shape, dtype)
    cache[key] = buf
    return buf, True


def _stack_leaves(leaves: List[Any]) -> Any:
    """One stacked leaf from the streams' leaves: tensors (or arrays) stack
    along a new stream axis, ``QTensor`` leaves stack their ``q`` and
    ``scale``."""
    if isinstance(leaves[0], QTensor):
        return QTensor(q=torch.stack([l.q for l in leaves]),
                       scale=torch.stack([l.scale for l in leaves]),
                       orig_dtype=leaves[0].orig_dtype)
    return torch.stack([torch.as_tensor(l) for l in leaves])


def _stack_trees(trees: List[Params], device: torch.device) -> Params:
    """Leaf-wise stack of per-stream trees of one structure, on ``device``
    (a fresh copy: the fit updates it in place)."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees], device)
                for k in sorted(trees[0])}
    out = _stack_leaves(trees)
    if isinstance(out, QTensor):
        return QTensor(q=out.q.to(device), scale=out.scale.to(device),
                       orig_dtype=out.orig_dtype)
    return out.to(device)


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


class FleetForecaster:
    """One speed model per stream of a fleet, the whole fleet fit as one
    stacked tree: each train step is one launch of each LSTM training
    kernel for all streams.

    Wraps a single-stream ``CompiledForecaster`` (``.single``; ``train`` and
    ``predict`` delegate to it, so a ``FleetForecaster`` serves anywhere a
    single-stream trainer does).  ``train_fleet`` groups the streams by
    shape bucket; a group of one delegates to ``single`` (byte for byte the
    single-stream fit), a larger one fits stacked, its stream axis padded
    to ``bucket_streams``.

    Counters: ``train_dispatches`` (fits: one per group a window),
    ``predict_dispatches`` (stacked predicts), ``restacks`` (stacked
    predicts that had to stack their params trees anew: a serving set that
    changed since the last predict), ``staging_allocs`` (host staging
    buffers allocated; flat after a bucket's first window) and
    ``last_losses`` (each stream's per-step losses of the last fit)."""

    def __init__(
        self,
        model: Model,
        *,
        epochs: int,
        batch_size: int,
        lr: float = 1e-3,
        predict_fn: Optional[Callable[[Params, np.ndarray], np.ndarray]] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.single = CompiledForecaster(
            model, epochs=epochs, batch_size=batch_size, lr=lr,
            predict_fn=predict_fn, device=device)
        self.model = model
        self.epochs = int(epochs)
        self.batch_size = int(batch_size)
        self.device = self.single.device
        self.opt = self.single.opt
        self._fleet_step = make_train_step(model, self.opt, stacked=True)
        self._train_bufs: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
        self._predict_bufs: Dict[Tuple, np.ndarray] = {}
        self._stack_tree_cache: Dict[Tuple, Tuple[list, Params]] = {}
        self.staging_allocs = 0
        self.train_dispatches = 0
        self.predict_dispatches = 0
        self.restacks = 0
        self.last_losses: Optional[List[Optional[np.ndarray]]] = None

    # -- Forecaster protocol (the fleet's single-stream view) ----------------

    def train(self, data: Dict[str, np.ndarray], params: Optional[Params],
              key: int) -> Tuple[Params, float]:
        return self.single.train(data, params, key)

    def predict(self, params: Params, x: np.ndarray) -> np.ndarray:
        return self.single.predict(params, x)

    # -- the fleet fit -------------------------------------------------------

    def draws(self, data: Dict[str, np.ndarray], key: int
              ) -> Tuple[Params, torch.Tensor]:
        """The (init params, permutation indices) ``CompiledForecaster.train``
        draws from ``key`` for ``data``: the permutations first, then the
        init, from one ``torch.Generator``."""
        n = len(next(iter(data.values())))
        gen = torch.Generator().manual_seed(int(key))
        idx = self.single.permutations(bucket_examples(n, self.batch_size),
                                       gen)
        return self.model.init(gen, self.device), idx

    def train_fleet(self, datas: Sequence[Dict[str, np.ndarray]],
                    keys: Sequence[int]) -> Tuple[List[Params], float]:
        """Cold-start fit of one speed model per stream, ``keys[i]`` playing
        for stream ``i`` the role ``key`` plays in
        ``CompiledForecaster.train``.  Returns the per-stream params (in the
        order of ``datas``: ``FleetParamView`` handles of a stacked group, a
        plain tree for a group of one) and the synced wall seconds."""
        t0 = time.perf_counter()
        if len(datas) != len(keys):
            raise ValueError(f"{len(datas)} windows but {len(keys)} keys")
        draws = [self.draws(d, k) for d, k in zip(datas, keys)]
        out = self.fit_fleet_window(datas, [d[0] for d in draws],
                                    [d[1] for d in draws])
        return out, time.perf_counter() - t0

    def fit_fleet_window(self, datas: Sequence[Dict[str, np.ndarray]],
                         inits: Sequence[Params],
                         idxs: Sequence[Any]) -> List[Params]:
        """The fleet counterpart of ``CompiledForecaster.fit_window``: train
        stream ``i`` from ``inits[i]`` (a tree of tensors or arrays) over
        the rows of ``idxs[i]`` ((epochs * steps, batch_size) indices into
        its padded bucket), draws made elsewhere.  Streams are grouped by
        shape bucket, a group of one through ``single.fit_window``.  The
        inits are copied, never trained in place.  Returns the per-stream
        params; ends with the device synchronized."""
        if not len(datas) == len(inits) == len(idxs):
            raise ValueError(f"{len(datas)} windows, {len(inits)} inits and "
                             f"{len(idxs)} index sets")
        out: List[Optional[Params]] = [None] * len(datas)
        losses: List[Optional[np.ndarray]] = [None] * len(datas)
        groups: Dict[int, List[int]] = {}
        for i, d in enumerate(datas):
            n = len(next(iter(d.values())))
            groups.setdefault(bucket_examples(n, self.batch_size),
                              []).append(i)
        for nb, members in sorted(groups.items()):
            if len(members) == 1:
                i = members[0]
                init = tree_map(lambda a: torch.as_tensor(a).detach().to(
                    self.device, copy=True), inits[i])
                out[i] = self.single.fit_window(
                    datas[i], init, torch.as_tensor(np.asarray(idxs[i])))
                losses[i] = self.single.last_losses
            else:
                for i, l in zip(members, self._fit_group(
                        nb, members, datas, inits, idxs, out)):
                    losses[i] = l
            self.train_dispatches += 1
        self.last_losses = losses
        return out

    def _train_staging(self, sb: int, nb: int,
                       data0: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The persistent stacked host buffers of one (stream bucket, shape
        bucket): x, y and mask, allocated once (counted), refilled in place
        every window."""
        bufs = self._train_bufs.get((sb, nb))
        if bufs is None:
            bufs = {"mask": np.zeros((sb, nb), np.float32)}
            for k, v in data0.items():
                v = np.asarray(v)
                bufs[k] = np.zeros((sb, nb) + v.shape[1:], v.dtype)
            self._train_bufs[(sb, nb)] = bufs
            self.staging_allocs += 1
        return bufs

    def _fit_group(self, nb: int, members: List[int],
                   datas: Sequence[Dict[str, np.ndarray]],
                   inits: Sequence[Params], idxs: Sequence[Any],
                   out: List[Optional[Params]]) -> List[np.ndarray]:
        """Fit one shape bucket's streams stacked; pads the stream axis with
        zero-data, zero-mask slots that repeat the first stream's draws
        (their loss and gradient are exactly zero, so their params never
        move).  Fills ``out`` with views and returns each stream's
        losses."""
        dev = self.device
        s, sb = len(members), bucket_streams(len(members))
        steps = self.epochs * (nb // self.batch_size)
        bufs = self._train_staging(sb, nb, datas[members[0]])
        for j, i in enumerate(members):
            d = datas[i]
            n = len(next(iter(d.values())))
            for k, v in d.items():
                bufs[k][j, :n] = np.asarray(v)
                bufs[k][j, n:] = 0
            bufs["mask"][j, :n] = 1.0
            bufs["mask"][j, n:] = 0.0
        for k in bufs:  # the padded stream slots
            bufs[k][s:] = 0
        order = members + [members[0]] * (sb - s)
        idx = torch.stack([torch.as_tensor(np.asarray(idxs[i]),
                                           dtype=torch.long) for i in order])
        if tuple(idx.shape) != (sb, steps, self.batch_size):
            raise ValueError(f"fit_fleet_window: indices {tuple(idx.shape)}, "
                             f"the bucket of {nb} needs "
                             f"{(steps, self.batch_size)} a stream")
        params = _stack_trees([inits[i] for i in order], dev)
        first = datas[members[0]]
        self.single._check_mask_honored(
            first, {k: bufs[k][0] for k in bufs},
            tree_map(lambda a: a[0], params), nb)
        x, y, mask = (torch.as_tensor(bufs[k], device=dev)
                      for k in ("x", "y", "mask"))
        idx = idx.to(dev)
        rows = torch.arange(sb, device=dev)[:, None]
        opt_state = self.opt.init(params)
        losses = []
        for t in range(steps):
            ib = idx[:, t]
            batch = {"x": x[rows, ib], "y": y[rows, ib],
                     "mask": mask[rows, ib]}
            params, opt_state, metrics = self._fleet_step(params, opt_state,
                                                          batch)
            losses.append(metrics["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        losses_S = torch.stack(losses, 1).cpu().numpy()  # (sb, steps)
        owner = _FleetStack(params)
        for j, i in enumerate(members):
            out[i] = FleetParamView(owner, j)
        return [losses_S[j] for j in range(s)]

    # -- the fleet predict ---------------------------------------------------

    def _stack_fleet_params(self, params_seq: List[Params], sb: int
                            ) -> Params:
        """The stacked tree of one fleet predict: sibling
        ``FleetParamView`` handles of one fit output, in slot order and filling
        its bucket, serve its stacked tree as it is; anything else stacks
        the per-stream trees leaf-wise, stream 0 repeated into the padded
        slots.  An identical sequence (the shared batch model every window,
        a gated fleet's unchanged serving set) reuses its stacked tree: the
        cache holds the sequence itself and re-checks identity."""
        first = params_seq[0]
        if isinstance(first, FleetParamView):
            owner = first.owner
            if (owner.dim() == sb and all(
                    isinstance(p, FleetParamView) and p.owner is owner
                    and p.slot == j for j, p in enumerate(params_seq))):
                return owner.stacked
        ck = (sb,) + tuple(id(p) for p in params_seq)
        hit = self._stack_tree_cache.get(ck)
        if hit is not None and all(a is b for a, b in zip(hit[0],
                                                          params_seq)):
            return hit[1]
        trees = [materialize_params(p) for p in params_seq]
        trees += [trees[0]] * (sb - len(trees))
        stacked = _stack_trees(trees, self.device)
        self.restacks += 1
        if len(self._stack_tree_cache) >= 16:
            self._stack_tree_cache.clear()
        self._stack_tree_cache[ck] = (list(params_seq), stacked)
        return stacked

    def predict_fleet(self, params_seq: Sequence[Params],
                      xs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Stream ``i``'s predictions on ``xs[i]`` under ``params_seq[i]``,
        for the whole fleet in one stacked predict: one launch of the
        serving kernel (an int8 fleet: one of each ``qmatmul``).  Batches
        pad to a common power-of-two row bucket and the stream axis to its
        bucket in a persistent staging buffer; the padding is sliced away.
        A one-stream call is ``CompiledForecaster.predict``."""
        params_seq = list(params_seq)
        xs = [np.asarray(x) for x in xs]
        if len(params_seq) != len(xs):
            raise ValueError(f"{len(params_seq)} param trees but "
                             f"{len(xs)} stream batches")
        S = len(xs)
        if S == 0:
            return []
        if S == 1:
            return [self.single.predict(params_seq[0], xs[0])]
        ns = [x.shape[0] for x in xs]
        nb, sb = _next_pow2(max(ns)), bucket_streams(S)
        stacked = self._stack_fleet_params(params_seq, sb)
        tail = xs[0].shape[1:]
        buf, allocated = _staging_buffer(self._predict_bufs, (sb, nb) + tail,
                                         (sb, nb) + tail, np.float32)
        self.staging_allocs += allocated
        for j, x in enumerate(xs):
            buf[j, :ns[j]] = x
            buf[j, ns[j]:] = 0  # only the padding tail
        buf[S:] = 0  # the padded stream slots
        with torch.inference_mode():
            preds = self.model.predict(
                stacked, torch.as_tensor(buf, device=self.device))
            preds = preds.cpu().numpy()
        self.predict_dispatches += 1
        return [preds[j, :ns[j]] for j in range(S)]
