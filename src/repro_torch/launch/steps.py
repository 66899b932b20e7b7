"""Step functions: train, prefill and serve, and the sharded stand-ins
the dry-run runs them on (the port of ``repro.launch.steps``).

``make_train_step`` differentiates the model with autograd (the SSD scan
through its hand-written backward kernel, flash attention through its
recomputing backward) and applies AdamW in place.

``abstract_params``, ``abstract_opt_state``, ``abstract_cache``,
``input_specs`` and ``step_and_specs`` give the no-allocation stand-ins of
every (arch x input-shape) combination: DTensors on a ``DeviceMesh`` (which
may sit on the fake process group), placed by ``launch/sharding.py``'s
rules, whose local shards are fake tensors (``FakeTensorMode``: shape,
dtype and device, no storage).  They are made under the active fake mode,
or a new one when none is active; ``launch/dryrun.py`` runs a step on them
under that mode.  Parameter shapes come from ``init_params`` on the
``meta`` device, which draws nothing, so kimi-k2's 1.04e12 parameters cost
no time.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..configs.base import InputShape, for_shape
from ..models import model as M
from ..optim import (AdamWState, adamw_update, cosine_schedule, tree_leaves,
                     tree_map, wsd_schedule)
from .sharding import (Spec, cache_specs, input_spec, local_shape,
                       map_with_path, param_specs, to_placements)

__all__ = ["cross_entropy", "make_train_step", "make_serve_step",
           "make_prefill_step", "abstract_params", "abstract_opt_state",
           "abstract_cache", "input_specs", "step_and_specs"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL, stable in f32.

    The gold logit is picked by a one-hot mask and a sum over the vocab,
    which gives the bits of a gather (every other term is an exact zero)
    and, unlike a gather, has a sharding rule when the vocab is sharded
    (the dry-run's DTensors)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=labels.device)
    hit = labels.long()[..., None] == vocab
    gold = torch.where(hit, logits, torch.zeros((), dtype=logits.dtype,
                                                 device=logits.device))
    return torch.mean(logz - gold.sum(dim=-1))


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


# ---------------------------------------------------------------------------
# abstract (no-allocation) inputs
# ---------------------------------------------------------------------------

def _fake_mode():
    """The active ``FakeTensorMode``, or a new one."""
    from torch._guards import active_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    return active_fake_mode() or FakeTensorMode()


def _stand_in(shape, dtype, spec, mesh, mode):
    """A DTensor of global ``shape`` placed by ``spec`` on ``mesh``, whose
    local shard (this rank's) is a fake tensor."""
    from torch.distributed.tensor import DTensor

    shape = tuple(int(d) for d in shape)
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    with mode:
        local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                            device=mesh.device_type)
        return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=tuple(reversed(stride)))


def _stand_ins(tree, specs, mesh, mode, dtype=None):
    """A stand-in for every leaf of ``tree`` (tensors with a shape and a
    dtype), placed by the matching leaf of ``specs``."""
    flat = {}
    map_with_path(lambda path, s: flat.__setitem__(path, s), specs)
    return map_with_path(
        lambda path, t: _stand_in(t.shape, dtype or t.dtype, flat[path],
                                  mesh, mode), tree)


def abstract_params(cfg: M.ModelConfig, mesh, fsdp: bool = True):
    """The parameters of ``cfg`` as stand-ins placed by the rules."""
    shapes = M.init_params(cfg, torch.Generator(), device="meta")
    return _stand_ins(shapes, param_specs(shapes, mesh, fsdp), mesh,
                      _fake_mode())


def abstract_opt_state(params_abstract, mesh, fsdp: bool = True
                       ) -> AdamWState:
    """AdamW's state beside stand-in parameters: f32 moments placed as the
    parameters are, the step a replicated int32 scalar."""
    mode = _fake_mode()
    specs = param_specs(params_abstract, mesh, fsdp)
    return AdamWState(
        step=_stand_in((), torch.int32, Spec(), mesh, mode),
        mu=_stand_ins(params_abstract, specs, mesh, mode, torch.float32),
        nu=_stand_ins(params_abstract, specs, mesh, mode, torch.float32))


def abstract_cache(cfg: M.ModelConfig, mesh, batch: int, seq: int):
    """The KV ring / SSM cache of ``batch`` sequences of ``seq`` as
    stand-ins placed by the rules."""
    shapes = M.init_cache(cfg, batch, seq, device="meta")
    return _stand_ins(shapes, cache_specs(shapes, mesh, batch), mesh,
                      _fake_mode())


def input_specs(cfg: M.ModelConfig, shape: InputShape, mesh) -> dict:
    """Stand-ins for the step's data arguments: ``tokens`` (B, T) int32 or
    ``embeds`` (B, T, D) for a frontend arch, T = 1 for decode, and
    ``labels`` (B, T) for train."""
    mode = _fake_mode()
    B, T = shape.global_batch, shape.seq_len
    seq = 1 if shape.kind == "decode" else T
    out: dict[str, Any] = {}
    if cfg.frontend != "none":
        out["embeds"] = _stand_in((B, seq, cfg.d_model), cfg.dtype,
                                  input_spec(mesh, B, 3), mesh, mode)
    else:
        out["tokens"] = _stand_in((B, seq), torch.int32,
                                  input_spec(mesh, B, 2), mesh, mode)
    if shape.kind == "train":
        out["labels"] = _stand_in((B, T), torch.int32,
                                  input_spec(mesh, B, 2), mesh, mode)
    return out


def step_and_specs(cfg: M.ModelConfig, shape: InputShape, mesh,
                   fsdp: bool = True):
    """Returns ``(step_fn, args)``: the step of ``shape``'s kind for
    ``for_shape(cfg, shape)`` and its stand-in arguments, to be run under
    the stand-ins' fake mode."""
    cfg = for_shape(cfg, shape)
    mode = _fake_mode()
    with mode:  # one fake mode for every stand-in
        batch = input_specs(cfg, shape, mesh)
        params = abstract_params(cfg, mesh, fsdp)
        if shape.kind == "train":
            step_fn = make_train_step(cfg)
            opt = abstract_opt_state(params, mesh, fsdp)
            step = _stand_in((), torch.int32, Spec(), mesh, mode)
            return step_fn, (params, opt, batch, step)
        if shape.kind == "prefill":
            step_fn = make_prefill_step(cfg, max_seq=shape.seq_len)
            return step_fn, (params, batch)
        # decode: cache of seq_len (ring-capped at the sliding window)
        step_fn = make_serve_step(cfg)
        cache = abstract_cache(cfg, mesh, shape.global_batch, shape.seq_len)
        return step_fn, (params, cache, batch)
