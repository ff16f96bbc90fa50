"""Serving engine: prefill + decode over the model zoo with a shared KV
cache, a simple ``generate()`` loop and continuous batching (``serve()``).

The counterpart of the reference's ``serving/engine.py``, call for call:
PyTorch runs eagerly, so ``Engine`` calls the model's ``prefill`` and
``decode_step`` where the reference calls their jitted versions.  The
stats are host clocks stopped after ``torch.cuda.synchronize()`` on the
card.  The engine runs on the current CUDA device unless it is given
``device="cpu"``; the params must lie on that device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import get_model
from repro_torch.serving.batching import BatchScheduler, Request

Params = Any


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(logits: torch.Tensor, generator: torch.Generator,
                       temp: float = 1.0) -> torch.Tensor:
    """One draw per row from softmax(logits / temp).  ``generator`` lies on
    the logits' device; it does not give the reference's ``jax.random``
    draws."""
    probs = torch.softmax(logits.float() / max(temp, 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s > 0 else 0.0


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


class Engine:
    """Single-model serving engine (the paper's edge-inference role)."""

    def __init__(self, cfg: ModelConfig, params: Params, max_len: int = 2048,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = get_model(cfg)
        if self.model.prefill is None:
            raise ValueError(f"{cfg.family} model has no prefill/decode to "
                             "serve")
        self.params = params
        self.max_len = max_len
        self._batch_axes: Any = None

    def _prefill(self, params: Params, batch):
        return self.model.prefill(params, batch, self.max_len)

    def _decode(self, params: Params, batch, cache):
        return self.model.decode_step(params, batch, cache)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.int32), device=self.device)

    @torch.no_grad()
    def generate(
        self,
        prompts: np.ndarray,  # (B, S) int32
        max_new_tokens: int,
        prefix_embed: Optional[np.ndarray] = None,
        greedy: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[np.ndarray, ServeStats]:
        stats = ServeStats()
        B, S = prompts.shape
        batch = {"tokens": self._tensor(prompts)}
        n_prefix = 0
        if prefix_embed is not None:
            batch["prefix_embed"] = torch.as_tensor(prefix_embed,
                                                    device=self.device)
            if self.cfg.family == "vlm":  # the prefix holds positions
                n_prefix = self.cfg.frontend.n_prefix_tokens
        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, batch)
        self._sync()
        stats.prefill_s = time.perf_counter() - t0

        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        tok = (greedy_sample(logits) if greedy
               else temperature_sample(logits, generator))
        out = [tok.cpu().numpy()]
        pos = torch.full((B,), S + n_prefix, dtype=torch.int32,
                         device=self.device)
        t0 = time.perf_counter()
        for i in range(max_new_tokens - 1):
            logits, cache = self._decode(
                self.params, {"token": tok[:, None], "pos": pos + i}, cache)
            tok = (greedy_sample(logits) if greedy
                   else temperature_sample(logits, generator))
            out.append(tok.cpu().numpy())
        self._sync()
        stats.decode_s = time.perf_counter() - t0
        stats.tokens_out = B * max_new_tokens
        return np.stack(out, axis=1), stats

    # -- continuous batching ------------------------------------------------

    def _cache_batch_axes(self, n_slots: int) -> Any:
        """Per-leaf batch axis of the KV cache, probed once from
        ``init_cache`` shapes on the meta device (the axis whose extent
        changes with the batch size), so the slot scatter works over any
        model family's cache layout without hard-coding it."""
        if self._batch_axes is None:
            if self.model.init_cache is None:
                raise ValueError(
                    f"{self.cfg.family} model exposes no init_cache; "
                    "serve() needs one to recycle batch slots")
            a = self.model.init_cache(n_slots, self.max_len, device="meta")
            b = self.model.init_cache(n_slots + 1, self.max_len,
                                      device="meta")

            def axis(sa, sb):
                for i, (x, y) in enumerate(zip(sa.shape, sb.shape)):
                    if x != y:
                        return i
                raise ValueError(f"cache leaf {tuple(sa.shape)} has no "
                                 "batch axis")

            self._batch_axes = _tree_map(axis, a, b)
        return self._batch_axes

    @staticmethod
    def _scatter_slots(cache: Any, new_cache: Any, axes: Any,
                       ids: np.ndarray) -> Any:
        """Overwrite the admitted slots' rows of the persistent cache with
        the fresh prefill's rows, in place, leaving every other slot's
        decode state untouched."""

        def put(c, n, ax):
            idx = torch.as_tensor(ids, dtype=torch.long, device=c.device)
            return c.index_copy_(ax, idx, n.index_select(ax, idx))

        return _tree_map(put, cache, new_cache, axes)

    @torch.no_grad()
    def serve(self, requests: List[Request], n_slots: int = 4,
              pad_id: int = 0) -> List[Request]:
        """Slot-recycling continuous batching: admit into free slots every
        tick, one batched decode dispatch per tick, retire and refill
        without draining a wave.

        Each tick: (1) queued requests FIFO-admit into free slots — their
        prompts left-pad to a pow2-bucketed length and prefill at the fixed
        ``(n_slots, Lb)`` shape (non-admitted rows carry pads; no attention
        mask hides the pads, as in the reference), the fresh cache rows
        scattering into the persistent shared cache so live slots' decode
        state is untouched; (2) one ``(n_slots, 1)`` decode dispatch
        advances *every* active slot — per-slot ``pos`` carries each
        request's own position, so requests admitted at different ticks
        interleave in the same batch; (3) finished requests retire
        immediately and their slots refill next tick.  The tick index is
        the clock threaded into ``admitted_at``/``finished_at``."""
        sched = BatchScheduler(n_slots)
        for r in requests:
            sched.submit(r)
        finished: List[Request] = []
        cache: Any = None
        axes: Any = None
        cur_tok = np.full((n_slots,), pad_id, np.int32)
        pos = np.zeros((n_slots,), np.int32)
        tick = 0
        while not sched.idle:
            progress = False
            admitted = sched.admit(now=float(tick))
            if admitted:
                progress = True
                reqs = [sched.slots[i].request for i in admitted]
                lb = max(len(r.prompt) for r in reqs)
                lb = 1 << max(0, (lb - 1).bit_length())  # pow2 bucket
                toks = np.full((n_slots, lb), pad_id, np.int32)
                for i, r in zip(admitted, reqs):
                    toks[i, lb - len(r.prompt):] = r.prompt  # left-pad
                logits, new_cache = self._prefill(
                    self.params, {"tokens": self._tensor(toks)})
                first = greedy_sample(logits).cpu().numpy()
                if cache is None:
                    cache = new_cache
                else:
                    if axes is None:
                        axes = self._cache_batch_axes(n_slots)
                    cache = self._scatter_slots(
                        cache, new_cache, axes,
                        np.asarray(admitted, np.int32))
                for i, r in zip(admitted, reqs):
                    r.generated.append(int(first[i]))  # prefill's token
                    cur_tok[i] = first[i]
                    pos[i] = lb
                    sched.slots[i].pos = lb
            finished.extend(sched.retire_finished(now=float(tick)))
            active = sched.active()
            if active:
                progress = True
                logits, cache = self._decode(
                    self.params,
                    {"token": self._tensor(cur_tok[:, None]),
                     "pos": self._tensor(pos)},
                    cache)
                tok = greedy_sample(logits).cpu().numpy()
                for i in active:
                    r = sched.slots[i].request
                    r.generated.append(int(tok[i]))
                    cur_tok[i] = tok[i]
                    pos[i] += 1
                    sched.slots[i].pos = int(pos[i])
                finished.extend(sched.retire_finished(now=float(tick)))
            if not progress:  # defensive: avoid a silent spin
                raise RuntimeError("serve() made no progress")
            tick += 1
        return finished
