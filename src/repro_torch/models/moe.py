"""Mixture-of-experts layer: the reference's ``models/moe.py`` on one card.

The reference has two expert-parallel strategies: ``moe_onehot``, the
Switch capacity dispatch through one-hot einsums over sub-groups of the
sequence, and ``moe_shard_map``, experts sharded over a mesh's ``model``
axis with ``_local_ep_body`` as its per-device body.  Without a mesh,
``moe_shard_map`` returns ``moe_onehot(cfg, p, x)``, so on one device the
two are one function: ``dispatch`` ports the one-hot dispatch, and
``moe_shard_map`` and ``_local_ep_body`` are not ported (a mesh collapses
to the one card).

``dispatch`` keeps exactly the slots the one-hot dispatch keeps.  A slot
is one of a token's top-k experts; its place in its expert's queue counts
the earlier slots of that expert in (token, slot) order within the group,
and it is kept while that place is below the capacity.  What differs is
the method: the reference builds (N, g, E, C) one-hot tensors and runs
every expert over its whole capacity; ``dispatch`` sorts the kept slots
by expert (stably, so a slot's queue order is kept) and runs only the
experts that got slots, each on its own token rows, then sums each token's
weighted expert outputs in float32 (``index_add_``; a token's k experts
are distinct, so no row is added twice in one call).  So a no-drop
prefill computes the tokens it routes, not the worst case's capacity, and
a decode step reads only the weights of the experts its tokens chose.  One
host sync a call reads how many slots each expert got.  On the ``meta``
device (the dry run's trace) there are no counts to read, and every
expert runs its full capacity.

Routing is float32 whatever the model's dtype, as the reference's: softmax
over the router's logits, then the top k by a stable descending sort, so a
tie in probability goes to the lower expert index as ``jax.lax.top_k``
picks it, then renormalised over the k.  The expert FFN runs in x's dtype,
the combine in float32, cast back to x's dtype, and the shared experts are
added after.  The expert products stay ``torch.matmul``: the reference
computes them outside any Pallas kernel, and no kernel of the port
replaces them.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn

Params = Dict[str, Any]

# the routed experts' leaves, with a leading expert axis
EXPERT_LEAVES = ("we_in", "we_gate", "we_out")
EP_MODES = (None, "auto", "onehot", "shard_map")


def _normal(generator: torch.Generator, lead: Sequence[int],
            shape: Tuple[int, int], dtype: torch.dtype,
            device: Optional[torch.device]) -> torch.Tensor:
    """(*lead, in, out) truncated-normal weights at fan-in scale, drawn one
    (in, out) slice at a time: the float32 draw of a whole stack of
    experts would not fit beside the model on the card."""
    std = shape[0] ** -0.5
    out = torch.empty((*lead, *shape), dtype=dtype, device=device)
    if nn.is_meta(device):
        return out
    for idx in itertools.product(*(range(n) for n in lead)):
        out[idx] = (nn._trunc_normal(generator, shape) * std).to(
            device=device, dtype=dtype)
    return out


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             n_stack: Optional[int] = None,
             device: Optional[torch.device] = None) -> Params:
    """The reference's leaves and shapes: ``router`` (d, E), ``we_in`` and
    ``we_gate`` (E, d, f), ``we_out`` (E, f, d), and the shared experts'
    ``w_in``, ``w_gate`` (d, f * n_shared) and ``w_out``; each with a
    leading ``n_stack`` axis when given."""
    moe = cfg.moe
    dt = getattr(torch, cfg.param_dtype)
    d, f, E = cfg.d_model, moe.d_ff_expert, moe.n_experts
    lead = () if n_stack is None else (n_stack,)

    def mk(experts, i, o):
        return _normal(generator, lead + experts, (i, o), dt, device)

    p = {"router": mk((), d, E), "we_in": mk((E,), d, f),
         "we_out": mk((E,), f, d)}
    if nn.is_gated(cfg.mlp_variant):
        p["we_gate"] = mk((E,), d, f)
    if moe.n_shared_experts > 0:
        fs = f * moe.n_shared_experts
        p["w_in"] = mk((), d, fs)
        p["w_out"] = mk((), fs, d)
        if nn.is_gated(cfg.mlp_variant):
            p["w_gate"] = mk((), d, fs)
    return p


def route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities (..., E) and the top-k (weights renormalised
    over the k, expert ids), all from float32.  x: (..., d)."""
    logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_p, top_idx = vals[..., :k], idx[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_idx


def aux_loss(cfg: ModelConfig, probs: torch.Tensor,
             top_idx: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss: E * sum_e f_e * P_e."""
    E = cfg.moe.n_experts
    sel = F.one_hot(top_idx.long(), E).float()  # (..., k, E)
    frac_tokens = sel.sum(-2).reshape(-1, E).mean(0)
    mean_prob = probs.reshape(-1, E).mean(0)
    return E * torch.sum(frac_tokens * mean_prob)


def expert_ffn(cfg: ModelConfig, p: Params, xe: torch.Tensor
               ) -> torch.Tensor:
    """Per-expert FFN in xe's dtype.  xe: (E, C, d) -> (E, C, d), against
    ``p``'s (E, d, f) and (E, f, d) experts."""
    h = torch.matmul(xe, p["we_in"].to(xe.dtype))
    gate = (torch.matmul(xe, p["we_gate"].to(xe.dtype)) if "we_gate" in p
            else None)
    h = nn.mlp_act(h, cfg.mlp_variant, gate)
    return torch.matmul(h, p["we_out"].to(xe.dtype))


def kept_slots(top_idx: torch.Tensor, n_experts: int,
               capacity: int) -> torch.Tensor:
    """Which of the (N, g, k) slots the capacity keeps: a slot's place in
    its expert's queue counts the earlier slots of that expert over the
    group's flattened (g * k) axis, in (token, slot) order, and it is
    kept while that place is below ``capacity``."""
    N, g, k = top_idx.shape
    flat = top_idx.reshape(N, g * k).long()
    counts = torch.cumsum(F.one_hot(flat, n_experts), dim=1,
                          dtype=torch.int32)
    place = counts.gather(2, flat[..., None])[..., 0] - 1
    return (place < capacity).reshape(N, g, k)


def group_and_capacity(cfg: ModelConfig, S: int, group: int = 0,
                       no_drop: bool = False) -> Tuple[int, int, int]:
    """(groups a sequence, group length, capacity) of the reference's
    one-hot dispatch (``moe_onehot(..., group, no_drop)``) for a sequence
    of S tokens."""
    moe = cfg.moe
    E, k = moe.n_experts, moe.top_k
    g = min(group or moe.dispatch_group, S)
    n_groups = S // g if S % g == 0 else 1
    if S % g != 0:
        g = S
    if no_drop:
        cap = g * k
    else:
        cap = max(1, int(g * k * moe.capacity_factor / E))
    return n_groups, g, cap


def dispatch(cfg: ModelConfig, p: Params, x: torch.Tensor,
             no_drop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``moe_onehot``: x (B, S, d) -> (out, aux_loss).

    ``no_drop`` sets the capacity to the worst case (every token of the
    group routed to one expert); otherwise it is the Switch capacity
    factor's.  See the module docstring for how the kept slots are
    computed."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    B, S, d = x.shape
    n_groups, g, cap = group_and_capacity(cfg, S, no_drop=no_drop)
    probs, top_p, top_idx = route(cfg, p["router"],
                                  x.reshape(B * n_groups, g, d))
    aux = aux_loss(cfg, probs, top_idx)
    keep = kept_slots(top_idx, E, cap).reshape(-1)
    # dropped slots sort after every expert's: key E
    key = torch.where(keep, top_idx.reshape(-1), E)
    order = torch.sort(key, stable=True).indices
    if x.device.type == "meta":
        # a meta tensor has no counts to read: every expert runs its full
        # capacity, the work the reference's one-hot dispatch compiles
        counts = [B * n_groups * cap] * E
        order = order.new_empty((E * counts[0],))
    else:
        counts = torch.bincount(key, minlength=E + 1)[:E].tolist()
    token = order // k
    weight = top_p.reshape(-1)[order]
    xf = x.reshape(B * S, d)
    out = torch.zeros((B * S, d), dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if not n:
            continue
        rows = token[start:start + n]
        pe = {name: p[name][e:e + 1] for name in EXPERT_LEAVES if name in p}
        ye = expert_ffn(cfg, pe, xf[rows][None])[0]
        out.index_add_(0, rows, ye.float() * weight[start:start + n, None])
        start += n
    return out.reshape(B, S, d).to(x.dtype), aux


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor,
              ep_mode: Optional[str] = None, no_drop: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's entry point: the routed experts, then the shared
    ones; returns (out, aux_loss * router_aux_loss).  ``ep_mode`` names
    the reference's strategy, which is one function on one device; as
    there, no_drop is dropped above 64 experts (fine-grained MoE serves at
    capacity)."""
    moe = cfg.moe
    if ep_mode not in EP_MODES:
        raise ValueError(f"unknown ep_mode {ep_mode!r}; one of {EP_MODES}")
    if no_drop and moe.n_experts > 64:
        no_drop = False
    out, aux = dispatch(cfg, p, x, no_drop=no_drop)
    if moe.n_shared_experts > 0:
        h = nn.dense(x, p["w_in"])
        gate = nn.dense(x, p["w_gate"]) if "w_gate" in p else None
        h = nn.mlp_act(h, cfg.mlp_variant, gate)
        out = out + nn.dense(h, p["w_out"])
    return out, aux * moe.router_aux_loss
