"""Step functions: train, prefill and serve (the port of
``repro.launch.steps``).

``make_train_step`` differentiates the model with autograd (the SSD scan
through its hand-written backward kernel, flash attention through its
recomputing backward) and applies AdamW in place.  The reference's other
half of this module -- ``abstract_params``, ``abstract_opt_state``,
``abstract_cache``, ``input_specs`` and ``step_and_specs``, the sharded
no-allocation stand-ins that its dry-run lowers -- is not ported yet: it
needs the production mesh and the shardings (ROADMAP.md, Queue A item 4).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models import model as M
from ..optim import (adamw_update, cosine_schedule, tree_leaves, tree_map,
                     wsd_schedule)

__all__ = ["cross_entropy", "make_train_step", "make_serve_step",
           "make_prefill_step"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL, stable in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def make_train_step(cfg: M.ModelConfig, base_lr: float = 3e-4,
                    total_steps: int = 10_000,
                    microbatches: int = 1) -> Callable:
    """(params, opt_state, batch, step) -> (params, opt_state, loss).

    ``batch`` holds ``labels`` and ``tokens`` or ``embeds`` (tensors on the
    parameters' device).  minicpm uses its WSD schedule (the arch's
    signature trick); everything else cosine.  ``microbatches`` > 1 splits
    the batch and accumulates f32 gradients over the pieces in a loop, so
    activation memory scales with B / microbatches.  The parameters and
    the optimiser's moments are updated in place and returned; ``loss`` is
    a detached f32 0-d tensor.
    """
    if cfg.name.startswith("minicpm"):
        sched = wsd_schedule(base_lr, warmup=total_steps // 100,
                             stable=int(total_steps * 0.89),
                             decay=total_steps // 10)
    else:
        sched = cosine_schedule(base_lr, warmup=total_steps // 100,
                                total=total_steps)

    def loss_and_grads(leaves, params, batch):
        logits = M.forward(cfg, params, tokens=batch.get("tokens"),
                           embeds=batch.get("embeds"))
        loss = cross_entropy(logits, batch["labels"])
        return loss, torch.autograd.grad(loss, leaves)

    def train_step(params, opt_state, batch, step):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if microbatches == 1:
            loss, grads = loss_and_grads(leaves, params, batch)
        else:
            parts = {k: torch.chunk(v, microbatches, dim=0)
                     for k, v in batch.items()}
            if any(len(v) != microbatches or v[0].shape[0] * microbatches
                   != batch[k].shape[0] for k, v in parts.items()):
                raise ValueError(f"batch does not split into {microbatches} "
                                 "equal microbatches")
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            for i in range(microbatches):
                loss_i, g_i = loss_and_grads(
                    leaves, params, {k: v[i] for k, v in parts.items()})
                loss = loss + loss_i.detach()
                grads = [a + g.float() for a, g in zip(grads, g_i)]
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        for p in leaves:
            p.requires_grad_(False)
        grad_tree = _rebuild(params, grads)
        params, opt_state = adamw_update(params, grad_tree, opt_state,
                                         sched(step))
        return params, opt_state, loss.detach()

    return train_step


def _rebuild(params, flat: list):
    """``flat`` (in ``tree_leaves`` order) in the tree of ``params``."""
    it = iter(flat)
    order = {id(t): next(it) for t in tree_leaves(params)}
    return tree_map(lambda p: order[id(p)], params)


def make_serve_step(cfg: M.ModelConfig) -> Callable:
    """(params, cache, batch) -> (logits, cache): ONE new token against the
    populated KV / SSM cache."""
    def serve_step(params, cache, batch):
        return M.decode_step(cfg, params, cache, token=batch.get("tokens"),
                             embed=batch.get("embeds"))
    return serve_step


def make_prefill_step(cfg: M.ModelConfig, max_seq: int) -> Callable:
    def prefill_step(params, batch):
        return M.prefill(cfg, params, tokens=batch.get("tokens"),
                         embeds=batch.get("embeds"), max_seq=max_seq)
    return prefill_step
