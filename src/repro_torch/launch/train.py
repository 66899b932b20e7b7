"""Training from the command line:
``python -m repro_torch.launch.train --arch <id> [--no-smoke]
[--device cuda|cpu]``.

Runs real optimisation steps (AdamW, the synthetic token stream) on the
card, or on the CPU with ``--device cpu``; ``--smoke`` (the default)
trains the reduced config, ``--no-smoke`` the full-width one.  Weights are
random, from a seed.  Checkpoints via ``repro_torch.checkpoint``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device
from ..checkpoint import save_checkpoint
from ..configs import ARCHS, get_config, smoke_config
from ..data import TokenStream
from ..models import init_params, param_count
from ..optim import adamw_init
from .steps import make_train_step

__all__ = ["main", "train_loop"]


def train_loop(cfg, steps: int = 50, batch: int = 4, seq: int = 64,
               base_lr: float = 3e-4, ckpt_dir: str | None = None,
               log_every: int = 10, seed: int = 0,
               device: str | torch.device = "cuda"):
    """``steps`` AdamW steps on ``TokenStream`` batches (frontend configs
    train on embeddings drawn as the reference draws them).  Returns
    (params, per-step losses as floats)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, device=dev)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, base_lr=base_lr,
                              total_steps=max(steps, 10))
    stream = iter(TokenStream(vocab=cfg.vocab, batch=batch, seq=seq,
                              seed=seed))
    losses = []
    t0 = time.time()
    for step in range(steps):
        tokens, labels = next(stream)
        batch_d = {"labels": torch.from_numpy(labels).to(dev)}
        if cfg.frontend != "none":
            emb = (np.random.default_rng(step).standard_normal(
                (batch, seq, cfg.d_model)).astype(np.float32) * 0.05)
            batch_d["embeds"] = torch.from_numpy(emb).to(dev, cfg.dtype)
        else:
            batch_d["tokens"] = torch.from_numpy(tokens).to(dev)
        params, opt, loss = step_fn(params, opt, batch_d, step)
        losses.append(float(loss))
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)")
    if ckpt_dir:
        path = save_checkpoint(ckpt_dir, steps, {"params": params})
        print(f"checkpoint -> {path}")
    return params, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCHS), default="internvl2-1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the reduced config (the default) or, with "
                    "--no-smoke, the full one")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    print(f"training {cfg.name} on {dev}")
    params, losses = train_loop(cfg, steps=args.steps, batch=args.batch,
                                seq=args.seq, ckpt_dir=args.ckpt, device=dev)
    print(f"{param_count(params):,} params; loss: {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
