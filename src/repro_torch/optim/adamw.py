"""AdamW and the learning-rate schedules (cosine, and MiniCPM's WSD): the
port of ``repro.optim.adamw``.

The optimiser state mirrors the parameter tree (the port's: ``layers`` a
per-layer list), so a checkpoint or a conversion walks both the same way.
The arithmetic is the reference's: f32 moments, the bias corrections
``1 - b ** step`` taken in f32, weight decay on every leaf, the new value
cast back to the parameter's type.  :func:`adamw_update` works under
``torch.no_grad()`` and writes the parameters and the moments in place;
the state stays on the parameters' device.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "wsd_schedule", "tree_leaves", "tree_map"]


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: dict
    nu: dict


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list / tuple tree, dict keys in
    sorted order (the order jax flattens a dict in)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in a tree of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return fn(tree, *rest)


def adamw_init(params) -> AdamWState:
    """Zero f32 moments beside every parameter, step 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step.  ``params`` and ``state``'s moments are updated in
    place; returns ``(params, AdamWState)`` with the step advanced by one.
    ``lr`` is a number or a 0-d tensor (a schedule's value)."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=step.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=step.device), stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        step_dir = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        pf = p.to(torch.float32)
        p_new = pf - lr * (step_dir + weight_decay * pf)
        p.copy_(p_new.to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warmup to ``base_lr``, then a half cosine to 0 at ``total``.
    The returned function maps a step (int or tensor) to an f32 0-d
    tensor."""
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def wsd_schedule(base_lr: float, warmup: int, stable: int, decay: int,
                 floor: float = 0.1) -> Callable:
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup, a
    long constant plateau, a short linear decay to ``floor * base_lr``."""
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0,
                           1.0)
        dec = base_lr * (1.0 - (1.0 - floor) * prog)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       torch.full_like(step, base_lr), dec))
    return lr
