"""The fault plane: seeded, deterministic fault injection for the bus runtime.

The port of ``src/repro/runtime/faults.py``.  A :class:`FaultPlane`
interposes on the deterministic runtime at three seams, so every robustness
claim can be exercised instead of assumed:

* **message faults** (``TopicBus.publish`` per-subscriber delivery):
  drop, delay, duplicate, reorder (seeded delivery jitter), payload
  corruption (a bit-flipped int8 ``QTensor`` model publish among them) and
  forgery, selected by fnmatch topic patterns over an active time window.
* **site faults** (``EventKernel`` scheduling and delivery): a site is down
  over ``[t_down, t_up)``: publishes from it are lost, deliveries to it are
  lost, and in-flight stage work that would finish while it is down is lost
  (the executors check :meth:`site_down` at stage completion).  At ``t_up``
  the plane fires its restart hooks so executors can model a cold restart.
* **WAN partition and heal** between two sites: deliveries crossing the cut
  are either queued until ``t_heal`` (delayed model sync) or dead-lettered.
* **sensor faults** (``streams.injection.BusInjector``): whole-window
  dropout, duplicate windows, out-of-order (jittered) windows, per-record
  dropout, and Byzantine values (plausible but wrong target readings, the
  case ``runtime.health.ByzantineGuard`` exists to catch), applied before
  the window reaches the bus.

Determinism: every draw comes from a numpy RNG derived from ``(seed,
category, spec index[, stream, window])``, the reference's derivation, so
one seed and scenario give the reference's fault schedule, and the same
bits of the same leaves flipped, byte for byte; another seed gives another
schedule.  ``reset()`` rewinds the sequential per-spec RNGs so one plane can
drive repeated runs.

Trees are the port's params trees (nested dicts of tensors or arrays,
``QTensor`` leaves, ``FleetParamView`` handles), walked in
``serving.quantize.tree_leaves`` order: sorted keys, a ``QTensor`` as its
``q`` then its ``scale``, a ``FleetParamView`` materialized first.  That is
the reference's ``jax.tree_util`` order, so the same RNG picks the same
leaf.  ``tree_checksum`` is ``serving.quantize``'s, re-exported.

Every fault action is recorded in ``events`` (time, kind, detail), the
fault schedule, and tallied in ``stats``.
"""
from __future__ import annotations

import zlib
from collections import Counter
from dataclasses import dataclass
from fnmatch import fnmatchcase
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.runtime.bus import DeadLetter
from repro_torch.serving.quantize import QTensor, tree_checksum, tree_leaves
from repro_torch.stacked import materialize_params

INF = float("inf")

MESSAGE_FAULT_KINDS = ("drop", "delay", "duplicate", "reorder", "corrupt",
                       "forge")


@dataclass(frozen=True)
class MessageFault:
    """One message-level fault rule: applies ``kind`` with probability
    ``p`` to every delivery whose topic matches ``topic`` (fnmatch pattern,
    e.g. ``"model/latest/*"``) published in ``[start, end)``."""

    topic: str
    kind: str  # drop | delay | duplicate | reorder | corrupt | forge
    p: float = 1.0
    delay_s: float = 0.0  # delay: added latency; duplicate: copy offset
    jitter_s: float = 0.0  # reorder: uniform extra delay in [0, jitter_s)
    start: float = 0.0
    end: float = INF

    def __post_init__(self):
        if self.kind not in MESSAGE_FAULT_KINDS:
            raise ValueError(f"unknown message fault kind {self.kind!r}; "
                             f"pick from {MESSAGE_FAULT_KINDS}")

    def active(self, topic: str, t: float) -> bool:
        return self.start <= t < self.end and fnmatchcase(topic, self.topic)


@dataclass(frozen=True)
class SiteFault:
    """Site ``site`` crashes at ``t_down`` (losing in-flight work and every
    delivery addressed to it) and restarts cold at ``t_up`` (never, when
    infinite)."""

    site: str
    t_down: float
    t_up: float = INF

    def down(self, t: float) -> bool:
        return self.t_down <= t < self.t_up


@dataclass(frozen=True)
class PartitionFault:
    """The link between sites ``a`` and ``b`` is cut over
    ``[t_start, t_heal)``.  ``mode="queue"`` holds crossing deliveries and
    releases them at heal time (the delayed-model-sync scenario);
    ``mode="drop"`` dead-letters them."""

    a: str
    b: str
    t_start: float
    t_heal: float = INF
    mode: str = "queue"  # "queue" | "drop"

    def cuts(self, x: str, y: str, t: float) -> bool:
        return ({x, y} == {self.a, self.b}
                and self.t_start <= t < self.t_heal)


@dataclass(frozen=True)
class SensorFault:
    """Injection-layer chaos for streams matching ``stream`` (fnmatch):
    per-window drop, duplicate and out-of-order probabilities plus
    per-record dropout, active while the window's nominal injection time is
    in ``[start, end)``.

    Byzantine values: with probability ``p_byzantine`` a window has
    ``byzantine_frac`` of its target readings offset by ``byzantine_scale``
    robust sigmas, plausible magnitudes that pass range checks and go
    straight into training unless a plausibility gate
    (``runtime.health.ByzantineGuard``) screens them."""

    stream: str = "*"
    p_drop_window: float = 0.0
    p_dup_window: float = 0.0
    p_reorder: float = 0.0
    reorder_jitter_s: float = 1.0
    p_drop_record: float = 0.0
    p_byzantine: float = 0.0
    byzantine_frac: float = 0.25
    byzantine_scale: float = 8.0
    start: float = 0.0
    end: float = INF


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _is_array(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() > 0
    return hasattr(leaf, "dtype") and np.asarray(leaf).size > 0


def _with_leaf(tree: Any, i: int, new: np.ndarray) -> Any:
    """``tree`` with its ``i``-th leaf (``tree_leaves`` order) replaced by
    ``new``, on the old leaf's device (a tensor's device, or numpy); every
    other leaf is the same object.  A ``FleetParamView`` comes back as its
    materialized tree."""
    seen = [0]

    def leaf(x):
        j = seen[0]
        seen[0] += 1
        if j != i:
            return x
        if isinstance(x, torch.Tensor):
            return torch.from_numpy(new).to(x.device)
        return new

    def walk(t):
        t = materialize_params(t)
        if isinstance(t, dict):
            out = {k: walk(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if t is None:
            return None
        if isinstance(t, QTensor):
            q = leaf(t.q)
            return QTensor(q=q, scale=leaf(t.scale), orig_dtype=t.orig_dtype)
        return leaf(t)

    return walk(tree)


def _pick_leaf(tree: Any, rng: np.random.Generator
               ) -> Optional[Tuple[int, np.ndarray]]:
    """The reference's pick: one array leaf of nonzero size, uniformly, as
    (its index in ``tree_leaves`` order, a host copy); None without one."""
    leaves = list(tree_leaves(tree))
    idx = [i for i, leaf in enumerate(leaves) if _is_array(leaf)]
    if not idx:
        return None
    i = idx[int(rng.integers(len(idx)))]
    return i, np.array(_host(leaves[i]), copy=True)


def corrupt_tree(tree: Any, rng: np.random.Generator) -> Any:
    """Flip one random bit in one random array leaf of a copy of a params
    tree (the original is untouched).  On an int8 ``QTensor`` tree this is
    exactly a bit-flipped quantized weight in transit."""
    picked = _pick_leaf(tree, rng)
    if picked is None:
        return tree
    i, arr = picked
    flat = arr.reshape(-1).view(np.uint8)
    flat[int(rng.integers(flat.size))] ^= np.uint8(1 << int(rng.integers(8)))
    return _with_leaf(tree, i, arr)


def forge_tree(tree: Any, rng: np.random.Generator) -> Any:
    """A plausible tampered copy of a params tree: one float leaf nudged by
    small centred noise (~5% of its scale), or one int leaf by +-1s; no
    NaNs, no flipped sign bits, nothing a range check would flag.  Unlike
    :func:`corrupt_tree` (a damaged transfer), this models an adversary in
    the sync path shipping a wrong but well-formed model."""
    picked = _pick_leaf(tree, rng)
    if picked is None:
        return tree
    i, arr = picked
    if np.issubdtype(arr.dtype, np.floating):
        scale = 0.05 * (float(np.abs(arr).mean()) + 1e-6)
        arr = arr + rng.normal(0.0, scale, size=arr.shape).astype(arr.dtype)
    else:
        lo = np.iinfo(arr.dtype)
        arr = np.clip(arr.astype(np.int64)
                      + rng.integers(-1, 2, size=arr.shape),
                      lo.min, lo.max).astype(arr.dtype)
    return _with_leaf(tree, i, arr)


def _forge_payload(payload: Any, rng: np.random.Generator) -> Any:
    """Forge a copy of a model publish: tamper with the params plausibly
    and, the attack that motivates authenticated sync, recompute the CRC32
    over the forged tree, so checksum-only verification accepts it.  A
    ``sig`` field is left stale (the forger has no run key), so an
    HMAC-verifying receiver still rejects.  Other payloads pass through."""
    if isinstance(payload, dict) and payload.get("params") is not None:
        out = dict(payload)
        out["params"] = forge_tree(out["params"], rng)
        if "checksum" in out:
            out["checksum"] = tree_checksum(out["params"])
        return out
    return payload


def _corrupt_payload(payload: Any, rng: np.random.Generator) -> Any:
    """Corrupt a copy of a bus payload: the model tree when the payload
    carries one (``params``), else its data array (``x``); routing metadata
    (stream and window keys) is never touched: corruption models a damaged
    transfer, not a misrouted one."""
    if isinstance(payload, dict):
        out = dict(payload)
        if "params" in out and out["params"] is not None:
            out["params"] = corrupt_tree(out["params"], rng)
        elif "x" in out:
            out["x"] = corrupt_tree(np.asarray(out["x"]), rng)
        return out
    return payload


def _sid_key(sid: str) -> int:
    return zlib.crc32(sid.encode("utf-8"))


class FaultPlane:
    """Seeded fault injector for one run, or more through :meth:`reset`.

    Attach it to a run with ``FleetBusExecutor(fault_plane=...)``, which
    wires it into the ``TopicBus``, installs its restart events on the
    kernel and consults it at stage completion; or by hand, setting
    ``bus.fault_plane`` and calling :meth:`install`."""

    def __init__(
        self,
        seed: int = 0,
        *,
        message_faults: Sequence[MessageFault] = (),
        site_faults: Sequence[SiteFault] = (),
        partitions: Sequence[PartitionFault] = (),
        sensor_faults: Sequence[SensorFault] = (),
    ):
        self.seed = int(seed)
        self.message_faults = tuple(message_faults)
        self.site_faults = tuple(site_faults)
        self.partitions = tuple(partitions)
        self.sensor_faults = tuple(sensor_faults)
        self.reset()

    # -- lifecycle -----------------------------------------------------------

    def reset(self) -> None:
        """Rewind to a pristine pre-run state: fresh per-spec RNGs (so a
        second run under the same seed replays the identical fault
        schedule), empty stats and event log, no restart hooks."""
        self._rng_msg = [np.random.default_rng([self.seed, 3, i])
                         for i in range(len(self.message_faults))]
        self.stats: Counter = Counter()
        self.events: List[Tuple[float, str, str]] = []
        self._restart_hooks: List[Callable[[str], None]] = []

    def install(self, kernel) -> None:
        """Schedule the plane's own events on a run's kernel: crash markers
        and the restart firings that invoke the registered hooks."""
        for f in self.site_faults:
            self.note("site_crash_scheduled", f.t_down, f.site)
            if f.t_up != INF:
                kernel.at(f.t_up,
                          lambda s=f.site, t=f.t_up: self._fire_restart(s, t))

    def on_restart(self, hook: Callable[[str], None]) -> None:
        """Register a cold-restart hook, called with the site's name when a
        crashed site comes back up."""
        self._restart_hooks.append(hook)

    def _fire_restart(self, site: str, t: float) -> None:
        self.note("site_restart", t, site)
        for hook in self._restart_hooks:
            hook(site)

    # -- bookkeeping ---------------------------------------------------------

    def note(self, kind: str, t: float, detail: str = "") -> None:
        self.stats[kind] += 1
        self.events.append((float(t), kind, detail))

    def schedule_signature(self) -> List[Tuple[float, str, str]]:
        """The realized fault schedule: what the determinism contract
        compares across runs and seeds."""
        return list(self.events)

    # -- site faults ---------------------------------------------------------

    def site_down(self, site: str, t: float) -> bool:
        return any(f.site == site and f.down(t) for f in self.site_faults)

    def partitioned(self, a: str, b: str, t: float
                    ) -> Optional[PartitionFault]:
        for p in self.partitions:
            if p.cuts(a, b, t):
                return p
        return None

    # -- message faults (TopicBus.publish interposition) ---------------------

    def plan_deliveries(self, topic: str, payload: Any, src: str, dst: str,
                        t_pub: float, dt: float, bus
                        ) -> List[Tuple[float, Any]]:
        """Turn one (publish, subscriber) pair into its faulted delivery
        list, ``[(deliver_time, payload), ...]``: empty when dropped or
        lost, two entries when duplicated, a corrupted payload copy when
        corrupted.  ``bus`` receives dead letters for hard partitions."""
        if self.site_down(src, t_pub):
            self.note("lost_publish_site_down", t_pub, f"{src}:{topic}")
            return []
        t_del = t_pub + dt
        part = self.partitioned(src, dst, t_pub)
        if part is not None:
            if part.mode == "drop" or part.t_heal == INF:
                bus.dead_letters.append(DeadLetter(
                    topic=topic, src=src, dst=dst, t=t_pub,
                    reason="partitioned"))
                self.note("partition_drop", t_pub, f"{src}->{dst}:{topic}")
                return []
            # queue mode: the transfer re-sends after the heal
            t_del = part.t_heal + dt
            self.note("partition_queued", t_pub, f"{src}->{dst}:{topic}")

        out: List[Tuple[float, Any]] = [(t_del, payload)]
        for i, mf in enumerate(self.message_faults):
            if not mf.active(topic, t_pub):
                continue
            rng = self._rng_msg[i]
            nxt: List[Tuple[float, Any]] = []
            for t_i, pl in out:
                if rng.random() >= mf.p:
                    nxt.append((t_i, pl))
                    continue
                if mf.kind == "drop":
                    self.note("msg_drop", t_pub, f"{topic}->{dst}")
                elif mf.kind == "delay":
                    self.note("msg_delay", t_pub, f"{topic}->{dst}")
                    nxt.append((t_i + mf.delay_s, pl))
                elif mf.kind == "reorder":
                    j = float(rng.uniform(0.0, mf.jitter_s))
                    self.note("msg_reorder", t_pub, f"{topic}->{dst}")
                    nxt.append((t_i + j, pl))
                elif mf.kind == "duplicate":
                    self.note("msg_duplicate", t_pub, f"{topic}->{dst}")
                    off = mf.delay_s if mf.delay_s > 0 else 1e-3
                    nxt.append((t_i, pl))
                    nxt.append((t_i + off, pl))
                elif mf.kind == "corrupt":
                    self.note("msg_corrupt", t_pub, f"{topic}->{dst}")
                    nxt.append((t_i, _corrupt_payload(pl, rng)))
                elif mf.kind == "forge":
                    self.note("msg_forge", t_pub, f"{topic}->{dst}")
                    nxt.append((t_i, _forge_payload(pl, rng)))
            out = nxt
        return out

    # -- sensor faults (injection-layer interposition) -----------------------

    def sensor_windows(self, sid: str, w: int, t: float,
                       data: Dict[str, np.ndarray]
                       ) -> List[Tuple[float, Dict[str, np.ndarray]]]:
        """Turn one nominal window injection into its faulted delivery
        list of ``(inject_time, data)``: possibly empty (window dropped),
        jittered (out of order), duplicated, or with rows removed (record
        dropout).  The RNG derives from (seed, spec, stream, window), so the
        schedule is independent of call order."""
        out: List[Tuple[float, Dict[str, np.ndarray]]] = [(t, data)]
        for i, sf in enumerate(self.sensor_faults):
            if not fnmatchcase(sid, sf.stream) or not (sf.start <= t < sf.end):
                continue
            rng = np.random.default_rng([self.seed, 7, i, _sid_key(sid), w])
            if sf.p_drop_record > 0.0:
                nxt = []
                for t_i, d in out:
                    keep = rng.random(len(d["x"])) >= sf.p_drop_record
                    if not keep.any():
                        keep[0] = True  # a sensor glitch, not a dead window
                    if not keep.all():
                        self.note("sensor_record_dropout", t,
                                  f"{sid}/w{w}:{int((~keep).sum())}")
                        d = {"x": d["x"][keep], "y": d["y"][keep]}
                    nxt.append((t_i, d))
                out = nxt
            if sf.p_byzantine > 0.0 and rng.random() < sf.p_byzantine:
                nxt = []
                for t_i, d in out:
                    y = np.asarray(d["y"])
                    n = y.shape[0]
                    k = max(1, int(round(sf.byzantine_frac * n)))
                    rows = rng.choice(n, size=min(k, n), replace=False)
                    med = float(np.median(y))
                    sigma = 1.4826 * float(np.median(np.abs(y - med))) + 1e-6
                    off = (sigma * sf.byzantine_scale
                           * rng.choice([-1.0, 1.0], size=(len(rows), 1))
                           * (1.0 + 0.25 * rng.random(size=(len(rows), 1))))
                    y2 = np.array(y, copy=True)
                    y2[rows] = y2[rows] + off.astype(y2.dtype)
                    self.note("sensor_byzantine", t,
                              f"{sid}/w{w}:{len(rows)}")
                    nxt.append((t_i, {"x": d["x"], "y": y2}))
                out = nxt
            if rng.random() < sf.p_drop_window:
                self.note("sensor_window_drop", t, f"{sid}/w{w}")
                return []
            if rng.random() < sf.p_reorder:
                out = [(t_i + float(rng.uniform(0.0, sf.reorder_jitter_s)), d)
                       for t_i, d in out]
                self.note("sensor_window_reorder", t, f"{sid}/w{w}")
            if rng.random() < sf.p_dup_window:
                out = out + [(t_i + 1e-3, d) for t_i, d in out]
                self.note("sensor_window_duplicate", t, f"{sid}/w{w}")
        return out
