"""The request plane: user queries answered from the fleet's device-resident
serving state.

Three query kinds against a stream's freshest lag-window context (the last
supervised input row the serving site has seen):

* ``point``   — one-step-ahead forecast from the current context.
* ``horizon`` — an ``h``-step autoregressive forecast: each step's scalar
  prediction is written into the target column of the rolled context window
  (the ``make_supervised`` feedback convention), and the query occupies its
  batch slot for ``h`` serving ticks.
* ``whatif``  — a scenario query: the context is perturbed once at admission
  (``x' = x * perturb_scale + perturb_offset``) and forecast one step ahead.

Queries arrive on per-stream request topics (``serve/request/<sid>``), are
admitted into fixed batch slots by the slot-recycling
:class:`~repro_torch.serving.batching.BatchScheduler`, and every serving tick
answers *all* active slots across *all* streams in **one** stacked
``FleetForecaster.predict_fleet`` call (one launch of the serving kernel,
or of each int8 product) — the same stream and row buckets the per-window
inference path uses, reading the stacked fit output the training plane left
on the device.  Answers publish back on ``serve/response/<sid>``.

The open-loop load generator (:func:`open_loop_trace`) emits a deterministic
arrival trace — uniform ``1/qps`` spacing, seeded kind/horizon mix — so a
run is exactly replayable and the offered rate is exact by construction.

Copied from the reference (numpy only): the same arguments give the same
trace, admissions and rolled contexts in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.batching import BatchScheduler

QUERY_KINDS = ("point", "horizon", "whatif")


@dataclass
class ForecastQuery:
    """One user request against one stream's serving model.

    ``answer`` fills with one float per serving tick (``horizon`` of them);
    ``model_window`` records which training window produced the serving
    params that answered — the staleness bound: under the paper's
    M^s_{t-1} semantics it trails the newest injected window by at most
    one training window (plus any sync still in flight)."""

    uid: int
    stream: str
    kind: str = "point"
    horizon: int = 1
    perturb_scale: float = 1.0
    perturb_offset: float = 0.0
    arrived_at: float = 0.0
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    answer: List[float] = field(default_factory=list)
    model_window: int = -1
    context_window: int = -1
    # True when any tick of this query was answered by the batch-model
    # fallback (cold start, or the staleness watchdog tripping because the
    # speed model lagged past the executor's bound)
    served_fallback: bool = False
    # the query's working (lag, F) context; set at admission, rolled by
    # horizon feedback
    ctx: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.kind not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {self.kind!r}")
        if self.kind != "horizon":
            self.horizon = 1
        if self.horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {self.horizon}")

    @property
    def done(self) -> bool:
        return len(self.answer) >= self.horizon

    @property
    def prefill_len(self) -> int:
        # forecast queries carry no token prompt; admission consumes no
        # decode positions (BatchScheduler genericity contract)
        return 0


def open_loop_trace(ids: Sequence[str], qps: float, n_requests: int, *,
                    start: float = 0.0, seed: int = 0,
                    kinds: Sequence[str] = QUERY_KINDS,
                    max_horizon: int = 3) -> List[ForecastQuery]:
    """A deterministic open-loop arrival trace: ``n_requests`` queries at
    exactly uniform ``1/qps`` spacing from ``start``, round-robin over the
    streams, with a seeded kind/horizon/perturbation mix.  Same arguments
    -> byte-identical trace, so a run replays exactly."""
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    rng = np.random.default_rng(seed)
    out: List[ForecastQuery] = []
    for i in range(n_requests):
        kind = kinds[int(rng.integers(len(kinds)))]
        horizon = (int(rng.integers(2, max_horizon + 1))
                   if kind == "horizon" else 1)
        scale, offset = 1.0, 0.0
        if kind == "whatif":
            scale = float(1.0 + 0.1 * rng.standard_normal())
            offset = float(0.05 * rng.standard_normal())
        out.append(ForecastQuery(
            uid=i, stream=ids[i % len(ids)], kind=kind, horizon=horizon,
            perturb_scale=scale, perturb_offset=offset,
            arrived_at=start + i / qps))
    return out


class QueryPlane:
    """Admission + context bookkeeping between the request topics and the
    batched serving dispatch.

    The serving site calls :meth:`observe_window` as stream windows arrive
    (keeping each stream's freshest lag-window context), :meth:`submit` as
    requests arrive, and then, per serving tick: :meth:`admit` (strict FIFO
    into free slots; a query whose stream has produced no window yet waits
    at the queue head), :meth:`build_batch` (per-stream slot contexts
    stacked into one fleet batch, aligned to the fleet order), and — after
    the one stacked predict — :meth:`apply` (answers appended, horizon
    contexts rolled) and :meth:`retire` (finished slots recycled)."""

    def __init__(self, ids: Sequence[str], n_slots: int,
                 target_col: int = 0):
        self.ids = list(ids)
        self.sched = BatchScheduler(n_slots)
        self.target_col = target_col
        self._ctx: Dict[str, np.ndarray] = {}
        self._ctx_window: Dict[str, int] = {}
        self.submitted = 0

    # -- context + request intake --------------------------------------------

    def observe_window(self, sid: str, x: np.ndarray, window: int) -> None:
        """Record stream ``sid``'s freshest context: the last supervised
        input row of window ``window`` (a (lag, F) array)."""
        x = np.asarray(x)
        if len(x) == 0 or window < self._ctx_window.get(sid, -1):
            return
        self._ctx[sid] = np.array(x[-1], copy=True)
        self._ctx_window[sid] = window

    def has_context(self, sid: str) -> bool:
        return sid in self._ctx

    def context_window(self, sid: str) -> int:
        """The freshest window this stream's context came from (-1 before
        the first window lands) — what the staleness watchdog compares the
        served ``model_window`` against."""
        return self._ctx_window.get(sid, -1)

    def submit(self, query: ForecastQuery) -> None:
        self.sched.submit(query)
        self.submitted += 1

    # -- the serving tick -----------------------------------------------------

    def admit(self, now: float) -> List[int]:
        """FIFO admission into free slots, initializing each admitted
        query's working context (perturbed once here for what-if queries).
        A queue-head query whose stream has no context yet blocks admission
        — strict FIFO, no reordering — until its stream's first window
        lands."""
        admitted = []
        for i, s in enumerate(self.sched.slots):
            if not s.free or not self.sched.queue:
                continue
            q = self.sched.queue[0]
            if q.stream not in self._ctx:
                break
            self.sched.queue.popleft()
            s.request = q
            s.pos = q.prefill_len
            q.admitted_at = now
            ctx = np.array(self._ctx[q.stream], copy=True)
            if q.kind == "whatif":
                ctx = ctx * q.perturb_scale + q.perturb_offset
            q.ctx = ctx
            q.context_window = self._ctx_window[q.stream]
            admitted.append(i)
        return admitted

    def build_batch(self) -> Optional[Tuple[Dict[str, List[ForecastQuery]],
                                            List[np.ndarray]]]:
        """The tick's fleet batch: for every stream (in fleet order) the
        stacked contexts of its active slots — streams with no active query
        contribute a zero-row batch, so the dispatch shape stays one
        (stream bucket, shape bucket) entry.  None when no slot is
        active."""
        by_stream: Dict[str, List[ForecastQuery]] = {sid: []
                                                     for sid in self.ids}
        ref = None
        for s in self.sched.slots:
            if s.request is not None:
                by_stream[s.request.stream].append(s.request)
                ref = s.request.ctx
        if ref is None:
            return None
        xs = []
        for sid in self.ids:
            qs = by_stream[sid]
            if qs:
                xs.append(np.stack([q.ctx for q in qs]))
            else:
                xs.append(np.zeros((0,) + ref.shape, ref.dtype))
        return by_stream, xs

    def apply(self, by_stream: Dict[str, List[ForecastQuery]],
              preds: Sequence[np.ndarray],
              model_windows: Dict[str, int],
              fallback: Optional[Dict[str, bool]] = None
              ) -> List[ForecastQuery]:
        """Append the tick's predictions to their queries (same slot order
        ``build_batch`` emitted) and roll each unfinished horizon query's
        context: next row = last row with the target column replaced by the
        prediction, window shifted by one.  ``fallback[sid]`` stamps the
        stream's answers as served from the batch-model fallback."""
        answered = []
        for sid, pred in zip(self.ids, preds):
            for j, q in enumerate(by_stream[sid]):
                p = float(np.asarray(pred[j]).reshape(-1)[0])
                q.answer.append(p)
                q.model_window = model_windows.get(sid, -1)
                if fallback is not None and fallback.get(sid, False):
                    q.served_fallback = True
                if not q.done:
                    nxt = np.array(q.ctx[-1], copy=True)
                    nxt[self.target_col] = p
                    q.ctx = np.concatenate([q.ctx[1:], nxt[None]], axis=0)
                answered.append(q)
        return answered

    def retire(self, now: float) -> List[ForecastQuery]:
        return self.sched.retire_finished(now)

    @property
    def busy(self) -> bool:
        """Anything admitted or admittable?"""
        return not self.sched.idle


def answer_query_unbatched(predict_fn, params, query: ForecastQuery,
                           base_ctx: np.ndarray,
                           target_col: int = 0) -> List[float]:
    """The unbatched reference for one query: a batch-of-one predict per
    horizon step with the same admission perturbation and horizon-feedback
    convention the batched tick path applies.  ``bench_serving`` and the
    parity tests gate the batched answers against this to <=1e-6."""
    ctx = np.array(base_ctx, copy=True)
    if query.kind == "whatif":
        ctx = ctx * query.perturb_scale + query.perturb_offset
    out: List[float] = []
    for _ in range(query.horizon):
        p = float(np.asarray(predict_fn(params, ctx[None])).reshape(-1)[0])
        out.append(p)
        nxt = np.array(ctx[-1], copy=True)
        nxt[target_col] = p
        ctx = np.concatenate([ctx[1:], nxt[None]], axis=0)
    return out


def latency_stats(latencies: Sequence[float]) -> Dict[str, float]:
    """p50/p99/mean over a latency sample (seconds); inf when empty so a
    starved run can never report a finite tail."""
    if not latencies:
        return {"p50_s": float("inf"), "p99_s": float("inf"),
                "mean_s": float("inf"), "max_s": float("inf")}
    arr = np.asarray(sorted(latencies))
    return {"p50_s": float(np.percentile(arr, 50)),
            "p99_s": float(np.percentile(arr, 99)),
            "mean_s": float(arr.mean()),
            "max_s": float(arr.max())}
