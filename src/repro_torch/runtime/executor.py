"""Executors: schedule the hybrid learner's pipeline stages
(``repro_torch.core.stages``).

``InProcessExecutor`` replays the paper's synchronous per-window loop with
the reference's window bookkeeping and record timing conventions.  The
bus-scheduled and fleet executors come with later slices.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from repro_torch.core.hybrid import HybridRunResult, WindowRecord
from repro_torch.core.stages import PipelineStages
from repro_torch.core.weighting import rmse
from repro_torch.core.windows import WindowedStream

Params = Any


def window_seeds(seed: int, n: int) -> List[int]:
    """The per-window training keys: ``n`` integers drawn from
    ``numpy.random.SeedSequence(seed)``, so every executor derives the same
    keys for the same seed."""
    return [int(k) for k in np.random.SeedSequence(seed).generate_state(n)]


class InProcessExecutor:
    """The paper's synchronous loop over the extracted stages: same window
    bookkeeping and ``WindowRecord`` timing conventions as the reference
    (``t_weight_solve`` counts only the dynamic solve)."""

    def __init__(self, stages: PipelineStages, start_window: int = 1):
        self.stages = stages
        self.start_window = start_window

    def run(self, stream: WindowedStream, batch_params: Params, seed: int,
            n_windows: Optional[int] = None) -> HybridRunResult:
        st = self.stages
        n = len(stream) if n_windows is None else min(n_windows, len(stream))
        keys = window_seeds(seed, n)
        records: List[WindowRecord] = []
        speed_params: Optional[Params] = None
        prev_preds = prev_y = None

        for t in range(n):
            data = stream.supervised(t)
            x, y = data["x"], data["y"]
            if t >= self.start_window and speed_params is not None and len(x) > 0:
                b = st.batch_inference(batch_params=batch_params, x=x)
                s = st.speed_inference(speed_params=speed_params, x=x)
                w = st.weight_solve(prev_preds=prev_preds, prev_y=prev_y)
                t_w = (w.wall_s if st.weight_solve.is_dynamic
                       and prev_preds is not None else 0.0)
                h = st.hybrid_combine(
                    pred_speed=s["pred"], pred_batch=b["pred"],
                    w_speed=w["w_speed"], w_batch=w["w_batch"])
                records.append(WindowRecord(
                    window=t,
                    rmse_batch=rmse(y, b["pred"]),
                    rmse_speed=rmse(y, s["pred"]),
                    rmse_hybrid=rmse(y, h["pred"]),
                    w_speed=w["w_speed"],
                    w_batch=w["w_batch"],
                    t_batch_infer=b.wall_s,
                    t_speed_infer=s.wall_s,
                    t_hybrid_infer=h.wall_s + t_w,
                    t_weight_solve=t_w,
                ))
            # training phase: speed model for the next window
            tr = st.speed_training(data=data, speed_params=speed_params,
                                   batch_params=batch_params, key=keys[t])
            if records and records[-1].window == t:
                records[-1].t_speed_train = tr["train_wall_s"]
            if tr["eval_preds"] is not None:
                prev_preds, prev_y = tr["eval_preds"], tr["eval_y"]
            speed_params = tr["params"]
        return HybridRunResult(records=records, mode=str(st.mode))
