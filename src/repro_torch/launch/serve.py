"""Serving launcher: runs the Engine on a reduced arch (batched requests,
prefill + decode) on the card, printing latency stats.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --batch 4 --prompt-len 64 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium

The reference's CLI on the port: the arch is ``.reduced()`` as the
reference's launcher runs it, the params are initialised from a
``torch.Generator`` seeded 0, and every attention runs through the flash
kernel (``tinyllama-1.1b``, ``zamba2-1.2b``'s shared block), every WKV
recurrence through the WKV kernel (``rwkv6-3b``), every Mamba2 scan
through the selective-scan kernel (``zamba2-1.2b``).  An arch with a
modality frontend (``paligemma-3b``, ``seamless-m4t-medium``) gets random
prefix embeddings from the same numpy generator, as the reference's
launcher gives them.  ``run(args, device="cpu")`` runs the plain versions
on the CPU.
"""
from __future__ import annotations

import argparse
from typing import Optional, Union

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--new-tokens", type=int, default=32)
    return p.parse_args(argv)


def run(args: argparse.Namespace,
        device: Optional[Union[str, torch.device]] = None):
    """Generate ``--new-tokens`` tokens for ``--batch`` random prompts on
    ``device`` (the current CUDA device by default); prints and returns
    (tokens (batch, new_tokens), ServeStats)."""
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models.model import get_model
    from repro_torch.serving.engine import Engine

    dev = resolve_device(device)
    cfg = get_config(args.arch).reduced()
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    engine = Engine(cfg, params, max_len=args.prompt_len + args.new_tokens,
                    device=dev)

    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    prefix = None
    if cfg.frontend is not None:
        fe = cfg.frontend
        prefix = rng.normal(0, 0.02, (args.batch, fe.n_prefix_tokens,
                                      fe.embed_dim)).astype(np.float32)
    out, stats = engine.generate(prompts, args.new_tokens,
                                 prefix_embed=prefix)
    print(f"generated {out.shape} tokens")
    print(f"prefill: {stats.prefill_s*1e3:.1f} ms  "
          f"decode: {stats.decode_s*1e3:.1f} ms  "
          f"throughput: {stats.tokens_per_s:.1f} tok/s")
    return out, stats


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
