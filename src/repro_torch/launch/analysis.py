"""A step's FLOPs, memory traffic and the three-term roofline, from a trace
on ``meta`` tensors.

The reference parses the partitioned HLO of a compiled step
(``parse_hlo``, ``summarize``, ``while_trip_count``); the port has no HLO.
Its counterpart runs the step once on ``meta`` tensors (shapes, no values,
no device) under two dispatch modes and summarizes what was dispatched in
a ``StepSummary``:

    dot_flops     = FlopCounterMode's total: every matrix product, and each
                    kernel's products by its formula (``kernels/_meta.py``)
    traffic_bytes = every dispatched op's input and output bytes, plus the
                    step's argument and output bytes

Reported roofline terms are **seconds per step per chip**, as the
reference's:

    compute    = dot_flops / peak_flops          (tensor-core term)
    memory     = traffic_bytes / hbm_bw          (HBM term)
    collective = collective_bytes / ici_bw       (0 on one card)

``count_params_analytic``, ``gated_ffn_params``, ``model_flops`` and
``roofline`` are the reference's, term for term.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import H100, HardwareModel

# the port's kernels on meta: torch.ops.repro_torch.* (kernels/_meta.py)
KERNEL_NAMESPACE = "repro_torch"


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def storage_bytes(tree: Any) -> int:
    """Bytes of the distinct storages under ``tree`` (a view adds none)."""
    seen = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


@dataclass
class StepSummary:
    """What a traced step dispatched; the fields ``roofline`` reads are the
    reference's ``HLOSummary``'s.

    ``traffic_bytes`` counts each dispatched op's inputs and outputs as
    read and written once, a count without fusion like the reference's
    count per HLO op (views move nothing and count nothing), plus the
    step's argument (``param_bytes``) and output bytes.  ``peak_bytes``
    is the most bytes of live storages at once, the arguments included.
    One card has no collectives."""

    dot_flops: float
    traffic_bytes: float
    param_bytes: float
    output_bytes: float
    peak_bytes: float
    n_ops: int
    flops_by_op: Dict[str, float]
    collective_bytes: float = 0.0
    collectives: Dict[str, float] = field(default_factory=dict)

    @property
    def kernel_flops(self) -> float:
        """The share of ``dot_flops`` in the port's kernels."""
        return sum(v for k, v in self.flops_by_op.items()
                   if k.startswith(KERNEL_NAMESPACE + "."))

    def as_dict(self) -> dict:
        return {"dot_flops": self.dot_flops,
                "aten_flops": self.dot_flops - self.kernel_flops,
                "kernel_flops": self.kernel_flops,
                "flops_by_op": self.flops_by_op,
                "traffic_bytes": self.traffic_bytes,
                "param_bytes": self.param_bytes,
                "output_bytes": self.output_bytes,
                "peak_bytes": self.peak_bytes,
                "n_ops": self.n_ops,
                "collective_bytes": self.collective_bytes,
                "collectives": self.collectives}


class _ByteTracer(TorchDispatchMode):
    """Sums each dispatched op's bytes and follows the live storages.

    A storage is live while a tensor object that refers to it is: each
    op's outputs are followed by a finalizer, and autograd's saved tensors
    are kept as those objects (``pack``), so a storage the graph holds
    stays counted until the graph frees it.  The arguments' storages are
    live throughout."""

    def __init__(self, held: Iterable[torch.Tensor]):
        super().__init__()
        held = list(held)
        self._held = {t.untyped_storage()._cdata for t in held}
        self.live = self.peak = storage_bytes(held)
        self._storages: Dict[int, List[int]] = {}  # key -> [bytes, objects]
        self._objects: Dict[int, int] = {}  # id(tensor) -> storage key
        self.traffic = 0
        self.n_ops = 0

    def pack(self, t: torch.Tensor) -> torch.Tensor:
        self._follow(t)
        return t

    def _follow(self, t: torch.Tensor) -> None:
        if id(t) in self._objects:
            return
        s = t.untyped_storage()
        key = s._cdata
        if key in self._held:
            return
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [s.nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        self._objects[id(t)] = key
        weakref.finalize(t, self._release, id(t))

    def _release(self, obj: int) -> None:
        key = self._objects.pop(obj)
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        if not func.is_view:
            self.traffic += _nbytes((args, kwargs)) + _nbytes(out)
        for t in _tensors(out):
            self._follow(t)
        return out


def trace_step(fn: Callable[..., Any], kwargs: Dict[str, Any]
               ) -> Tuple[StepSummary, Any]:
    """Run ``fn(**kwargs)`` once on meta tensors under ``FlopCounterMode``
    and the byte tracer; returns (its ``StepSummary``, its output)."""
    args = _tensors(kwargs)
    counter = FlopCounterMode(display=False)
    with counter:
        tracer = _ByteTracer(args)
        with tracer, torch.autograd.graph.saved_tensors_hooks(
                tracer.pack, lambda t: t):
            out = fn(**kwargs)
    by_op = {str(op): float(n) for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    param_bytes = storage_bytes(args)
    output_bytes = _nbytes(out)
    summary = StepSummary(
        dot_flops=float(counter.get_total_flops()),
        traffic_bytes=float(tracer.traffic + param_bytes + output_bytes),
        param_bytes=float(param_bytes), output_bytes=float(output_bytes),
        peak_bytes=float(tracer.peak), n_ops=tracer.n_ops,
        flops_by_op=by_op)
    return summary, out


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_per_chip: float
    useful_ratio: float  # MODEL_FLOPS / (traced flops * chips)
    collectives: Dict[str, float]

    def as_dict(self):
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops_per_chip": self.hlo_flops_per_chip,
            "useful_ratio": self.useful_ratio,
            "collectives": self.collectives,
        }


def roofline(summary, n_chips: int, model_flops: float,
             hw: HardwareModel = H100) -> Roofline:
    """The reference's three terms from a summary's ``dot_flops``,
    ``traffic_bytes``, ``collective_bytes`` and ``collectives``.  Without
    collective bytes the collective term is 0, also where ``hw`` has no
    collective bandwidth (one card)."""
    compute_s = summary.dot_flops / hw.peak_flops_bf16
    memory_s = summary.traffic_bytes / hw.hbm_bw
    collective_s = (summary.collective_bytes / hw.ici_bw
                    if summary.collective_bytes else 0.0)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total_hlo = summary.dot_flops * n_chips
    return Roofline(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        hlo_flops_per_chip=summary.dot_flops,
        useful_ratio=model_flops / total_hlo if total_hlo > 0 else 0.0,
        collectives=summary.collectives,
    )


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS
# ---------------------------------------------------------------------------


def count_params_analytic(cfg) -> Tuple[float, float]:
    """(total_params, active_params) — active differs for MoE."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    qd, kvd = cfg.q_dim, cfg.kv_dim
    attn = d * qd + 2 * d * kvd + qd * d
    gated = 3 if cfg.mlp_variant in ("swiglu", "geglu") else 2
    total = V * d * (1 if cfg.tie_embeddings else 2)
    active = total
    if cfg.family == "ssm":  # rwkv6: 5 square proj + channel mix
        per_layer = 5 * d * d + gated_ffn_params(cfg, d)
        total += L * per_layer
        active = total
        return float(total), float(active)
    for li in range(L):
        is_moe = cfg.moe is not None and li >= (cfg.moe.first_dense_layers
                                                if cfg.moe else 0)
        if cfg.family == "hybrid":
            # mamba2 backbone layer
            from repro_torch.models import ssm as ssm_mod

            d_inner, H, xbc, d_in_proj = ssm_mod.dims(cfg)
            per = d * d_in_proj + d_inner * d
            total += per
            active += per
            continue
        if is_moe:
            e = cfg.moe
            expert = gated * d * e.d_ff_expert
            total += attn + e.n_experts * expert + d * e.n_experts
            total += e.n_shared_experts * gated * d * e.d_ff_expert
            active += attn + e.top_k * expert + d * e.n_experts
            active += e.n_shared_experts * gated * d * e.d_ff_expert
        else:
            ffn = gated_ffn_params(cfg, d)
            total += attn + ffn
            active += attn + ffn
    if cfg.family == "hybrid":
        # one shared transformer block + down-proj
        shared = attn + gated_ffn_params(cfg, d) + 2 * d * d
        total += shared
        active += shared
    if cfg.family == "audio" and cfg.encdec:
        enc = cfg.encdec.n_encoder_layers * (attn + gated_ffn_params(cfg, d))
        cross = L * (d * qd + 2 * d * kvd + qd * d)
        total += enc + cross
        active += enc + cross
    return float(total), float(active)


def gated_ffn_params(cfg, d) -> int:
    gated = 3 if cfg.mlp_variant in ("swiglu", "geglu") else 2
    return gated * d * cfg.d_ff


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N_active*D for train (fwd+bwd), 2*N_active*D for
    inference, plus the attention score/value matmuls (which dominate long
    decode and are not captured by the parametric term).  Global FLOPs."""
    total, active = count_params_analytic(cfg)
    B = shape.global_batch
    if shape.kind == "train":
        tokens, mult = B * shape.seq_len, 6.0
        sq, skv = shape.seq_len, shape.seq_len
    elif shape.kind == "prefill":
        tokens, mult = B * shape.seq_len, 2.0
        sq, skv = shape.seq_len, shape.seq_len
    else:
        tokens, mult = B, 2.0
        sq, skv = 1, shape.seq_len
    if shape.kind == "decode" and cfg.family == "audio" and cfg.encdec:
        # the encoder does not run at decode (cross K/V live in the cache)
        d = cfg.d_model
        enc_params = cfg.encdec.n_encoder_layers * (
            cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
            + cfg.q_dim * cfg.d_model + gated_ffn_params(cfg, d)
        )
        active = max(active - enc_params, 1.0)
    flops = mult * active * tokens

    # attention: per layer 4*B*Sq*Skv_eff*q_dim fwd (QK^T + PV), x3 train
    if cfg.attention != "none" and cfg.family != "lstm":
        if cfg.attention == "swa":
            skv_eff = min(skv, cfg.window_size)
        else:
            skv_eff = skv
        if sq > 1 and cfg.attention != "swa":
            skv_eff = skv_eff / 2  # causal halves the average span
        n_attn = cfg.n_layers
        if cfg.family == "hybrid" and cfg.hybrid is not None:
            n_attn = cfg.n_layers // cfg.hybrid.attn_every
        if cfg.family == "audio" and cfg.encdec is not None:
            # decoder self + cross + encoder self
            enc = cfg.encdec
            flops += (4.0 * B * sq * enc.encoder_len * cfg.q_dim
                      * (3.0 if shape.kind == "train" else 1.0)) * cfg.n_layers
            if shape.kind in ("train",):
                flops += (12.0 * B * enc.encoder_len * enc.encoder_len / 2
                          * cfg.q_dim) * enc.n_encoder_layers
        a_mult = 3.0 if shape.kind == "train" else 1.0
        flops += 4.0 * a_mult * B * sq * skv_eff * cfg.q_dim * n_attn
    return flops
