"""Training launcher: trains a reduced variant of a zoo arch on synthetic
tokens on the card, the reference's ``launch/train.py --local``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --local --steps 20 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --local --steps 20 --device cpu

``--local`` trains ``cfg.reduced()`` for ``--steps`` steps with
``adamw(warmup_cosine(lr, warmup=max(steps // 10, 1), total=steps))``
through ``make_train_step``: the params from ``model.init`` and every
batch from one ``torch.Generator`` seeded 0 on the device.  Every family
of the zoo trains: the transformers (``dense``, ``moe``, ``vlm``), the
encoder-decoder (``audio``), RWKV6 (``ssm``) and the Zamba2 hybrid
(``hybrid``), each scan's gradient in its backward kernel on the card.
The reference's other mode,
the production mesh, delegates to its dry run; so does the port's: without
``--local`` the launcher prints how to run ``repro_torch.launch.dryrun``
(the step traced on ``meta`` against one H100) and exits.  ``--device
cpu`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Iterable, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device


def synthetic_batch(cfg, batch: int, seq: int,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Uniform tokens (batch, seq + 1) on the generator's device, split into
    ``tokens`` and next-token ``targets``; with a frontend, prefix
    embeddings 0.02 normal (batch, n_prefix_tokens, embed_dim)."""
    dev = generator.device
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=generator, device=dev)
    out = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    if cfg.frontend is not None:
        fe = cfg.frontend
        out["prefix_embed"] = torch.randn(
            (batch, fe.n_prefix_tokens, fe.embed_dim), generator=generator,
            device=dev) * 0.02
    return out


def train_local(arch: str, steps: int, batch: int, seq: int, lr: float,
                ckpt_path: Optional[str] = None, log_every: int = 10, *,
                device: Optional[Union[str, torch.device]] = None,
                params: Optional[dict] = None,
                batches: Optional[Iterable[dict]] = None) -> dict:
    """Train ``get_config(arch).reduced()`` for ``steps`` steps on
    ``device`` (the current CUDA device unless the caller asks for the
    CPU).  ``params`` (a tree of tensors on the device) and ``batches``
    (one dict of arrays a step) replace the generator's draws, so a caller
    can hand over another run's.  Returns the losses, the wall, the first
    and final loss and the trained params; saves them to ``ckpt_path``
    when given."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import get_model
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import adamw, warmup_cosine
    from repro_torch.training.train_loop import make_train_step

    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    model = get_model(cfg)
    generator = torch.Generator(device=dev).manual_seed(0)
    if params is None:
        params = model.init(generator, dev)
    opt = adamw(warmup_cosine(lr, warmup=max(steps // 10, 1), total=steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)
    given = iter(batches) if batches is not None else None

    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        if given is None:
            b = synthetic_batch(cfg, batch, seq, generator)
        else:
            b = {k: torch.as_tensor(v, device=dev) for k, v in
                 next(given).items()}
        params, opt_state, metrics = step_fn(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i+1}/{steps} loss={losses[-1]:.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f}")
    wall = time.perf_counter() - t0
    if ckpt_path:
        h = checkpoint.save(ckpt_path, params, step=steps)
        print(f"saved checkpoint {h.path} ({h.nbytes/1e6:.1f} MB)")
    return {"losses": losses, "wall_s": wall, "final_loss": losses[-1],
            "first_loss": losses[0], "params": params}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--local", action="store_true")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--device", default=None,
                   help="the device to train on (default: the current CUDA "
                        "device; 'cpu' for the plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if not args.local:
        print("production-mesh mode delegates to repro_torch.launch.dryrun "
              "(the step traced on meta against one H100); run: python -m "
              f"repro_torch.launch.dryrun --arch {args.arch} --shape "
              "train_4k")
        return
    res = train_local(args.arch, args.steps, args.batch, args.seq, args.lr,
                      args.ckpt, device=args.device)
    print(f"done: first_loss={res['first_loss']:.4f} "
          f"final_loss={res['final_loss']:.4f} wall={res['wall_s']:.1f}s")
    if not np.isfinite(res["final_loss"]):
        raise SystemExit(f"training diverged: final loss "
                         f"{res['final_loss']}")


if __name__ == "__main__":
    main()
