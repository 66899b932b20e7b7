"""Batched serving engine: prefill + iterative decode with ring KV caches
and Mamba states (the port of ``repro.serving.engine``).

Requests are bucketed by prompt length (the prefill has no padding mask —
equal-length batching keeps positions exact), prefilled once, then decoded
greedily step by step.  ``coded`` switches the FFN GEMMs to CoCoI (n, k)
coded execution under any scheme registered in core/schemes.py, and
``executor`` runs those coded GEMMs live on a
``repro_torch.dist.CodedExecutor`` worker pool: each is split, encoded,
dispatched as n piece GEMMs, and decoded at the k-th arrival while
stragglers are cancelled.  ``executor="mesh"`` (or a
``repro_torch.dist.MeshExecutor``) runs each coded GEMM as one device
program instead: encode, the n pieces in one launch, decode, replayed as a
CUDA graph on the card.  The model runs eagerly either way.
``adaptive=True`` wraps the pool's executor as a
``repro_torch.dist.AdaptiveExecutor``: every coded GEMM re-solves k° and
the piece allocation from the workers' live (mu, theta) profiles.

Parameters keep their own type on every backend (bf16 by default): a coded
GEMM hands the backend its source weight, which casts it to f32 inside the
op (on the mesh, inside the captured program).

Latency accounting is per request: ``latency_s`` measures from
``max(Request.arrival_s, generate() entry)`` to that request's last token,
``first_token_s`` to its first generated token.  Buckets are processed in
arrival order of their earliest request.

``generate()`` serves one closed batch; open-loop serving (requests
arriving over time, admission into a running decode batch, packed and
chunked prefill, the coded prefix cache) lives in
:mod:`repro_torch.serving.scheduler`, built on the step-level API here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..models.model import (ModelConfig, _coded_scheme, coded_executor,
                            decode_step, init_cache, init_params, prefill,
                            prefill_resume, supports_prefill_pack)
from ..models.moe import MoECounters, counting
from ..telemetry.trace import span

__all__ = ["Request", "Completion", "Engine", "cache_cat", "cache_take"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (T,) int32 token ids
    max_new: int = 16
    # when the request entered the system, on the caller's clock (0.0 =
    # "at the generate() call"); latencies are measured from
    # max(arrival_s, generate() entry)
    arrival_s: float = 0.0


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray  # generated ids
    latency_s: float        # max(arrival, generate() entry) -> last token
    first_token_s: float = 0.0  # same reference -> its first token


class Engine:
    def __init__(self, cfg: ModelConfig, params=None, *,
                 coded: tuple | None = None, scheme: str | None = None,
                 max_batch: int = 8, seed: int = 0, executor=None,
                 adaptive: bool = False, adaptive_prior=None,
                 segment: bool | None = None, device: str | torch.device = "cuda"):
        # scheme=None means "whatever cfg.coded_scheme says"
        if scheme is not None:
            from ..core.schemes import get_scheme

            get_scheme(scheme)  # fail fast on unknown scheme names
        if coded is not None:
            cfg = dataclasses.replace(cfg, coded_n=coded[0], coded_k=coded[1],
                                      coded_scheme=scheme or cfg.coded_scheme)
        elif scheme is not None and scheme != cfg.coded_scheme:
            cfg = dataclasses.replace(cfg, coded_scheme=scheme)
        if segment is not None:
            from ..core.schemes import commutes_elementwise

            if segment and not commutes_elementwise(cfg.coded_scheme):
                raise ValueError(
                    f"segment=True needs a selection scheme (replication/"
                    f"uncoded): {cfg.coded_scheme!r} is a linear mix and "
                    "cannot keep token slices resident across the FFN "
                    "activation — it would silently fall back per-GEMM")
            cfg = dataclasses.replace(cfg, coded_segment=segment)
        if isinstance(executor, str):
            # backend shorthand (dist/backend.py): executor="mesh" serves
            # the coded GEMMs as one device program each
            # (dist/mesh_exec.py); "threads" asks for the pool backend,
            # which needs constructor arguments we cannot guess
            if executor == "mesh":
                from ..dist.mesh_exec import MeshExecutor

                executor = MeshExecutor()
            else:
                raise ValueError(
                    f"unknown executor backend {executor!r}: pass 'mesh' "
                    "or a constructed executor (repro_torch.dist."
                    "CodedExecutor / repro_torch.dist.MeshExecutor)")
        if executor is not None and segment:
            from ..dist.mesh_exec import MeshExecutor

            if isinstance(executor, MeshExecutor):
                raise ValueError(
                    "segment=True needs the threaded backend: segment "
                    "chains dispatch opaque per-piece thunks, which one "
                    "device program cannot hold")
        if adaptive:
            if executor is None:
                raise ValueError(
                    "adaptive=True needs an executor= worker pool: the "
                    "adaptive loop learns from live run telemetry "
                    "(dist/adaptive.py), which only the pool produces")
            from ..dist.mesh_exec import MeshExecutor

            if isinstance(executor, MeshExecutor):
                raise ValueError(
                    "adaptive=True needs the threaded pool backend: the "
                    "planner fits per-worker (mu, theta) from per-piece "
                    "arrival timings, which one device program does not "
                    "produce (every lane finishes together)")
            from ..dist.adaptive import AdaptiveExecutor

            if isinstance(executor, AdaptiveExecutor):
                if adaptive_prior is not None:
                    raise ValueError(
                        "executor is already an AdaptiveExecutor with its "
                        "own planner prior; pass adaptive_prior via "
                        "AdaptiveExecutor(prior=...) instead (silently "
                        "dropping it here would calibrate against the "
                        "wrong prior)")
            else:
                # wrap the caller's pool: every coded GEMM now re-plans k°
                # and the piece allocation from the live worker profiles
                executor = AdaptiveExecutor(pool=executor.pool,
                                            prior=adaptive_prior)
        if executor is not None and not cfg.coded_n:
            raise ValueError(
                "executor= requires coded execution: pass coded=(n, k) "
                "or a cfg with coded_n/coded_k set (otherwise the "
                "engine would just run with the pool idle)")
        self.cfg = cfg
        if params is None:
            dev = resolve_device(device)
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = init_params(cfg, gen, device=dev)
        self.params = params
        self.device = params["embed"].device
        self.max_batch = max_batch
        self.executor = executor
        # real-clock counters of the step-level API, cumulative (the
        # scheduler reads them as deltas a step): host seconds blocked on
        # the card while the sampled tokens are copied out, and the prefill
        # calls with their prompt tokens
        self.wait_s = 0.0
        self.prefill_calls = 0
        self.prefill_tokens = 0
        # the mixture-of-experts layers' counts of every step (models/moe.py)
        self.moe_counters = MoECounters()
        self._bind_steps()
        self._warm_decode()

    def _bind_steps(self) -> None:
        """(Re)bind the prefill/decode step callables to the CURRENT cfg —
        the closures capture ``cfg`` by value, which is what makes
        ``retarget_coded`` take effect."""
        cfg = self.cfg
        counted = self._counted
        self._prefill = counted(
            lambda p, t, ms: prefill(cfg, p, t, max_seq=ms))
        self._prefill_pack = counted(
            lambda p, t, ln, ms: prefill(cfg, p, t, max_seq=ms, lens=ln))
        self._decode = counted(lambda p, c, t: decode_step(cfg, p, c, token=t))
        self._resume = counted(lambda p, c, t: prefill_resume(cfg, p, c, t))

    def _counted(self, step):
        """``step`` with its mixture-of-experts layers counted into
        ``moe_counters``."""
        def run(*args):
            with counting(self.moe_counters):
                return step(*args)
        return run

    def _warm_decode(self) -> None:
        if self.cfg.coded_n:
            # warm the scheme's lru-cached decode matrices at startup so the
            # first serving step pays steady-state decode cost
            from ..core.schemes import warm_decode_cache

            warm_decode_cache(_coded_scheme(
                self.cfg.coded_scheme, self.cfg.coded_n,
                self.cfg.coded_k or None))

    def retarget_coded(self, n: int, k: int | None = None) -> None:
        """Re-plan the LIVE coded scheme to (n, k).  ``k=None`` lets
        schemes with structural k (replication, uncoded) derive their own.
        Params, caches and in-flight lanes are untouched — the next coded
        GEMM simply splits (and encodes) at the new (n, k)."""
        if not self.cfg.coded_n:
            raise ValueError("retarget_coded needs a coded engine "
                             "(cfg.coded_n unset: there is no live scheme)")
        self.cfg = dataclasses.replace(
            self.cfg, coded_n=int(n), coded_k=0 if k is None else int(k))
        self._bind_steps()
        self._warm_decode()

    def executor_ctx(self):
        """Route this thread's coded GEMMs through the engine's executor
        (a no-op context when the engine runs without one)."""
        if self.executor is None:
            return contextlib.nullcontext()
        return coded_executor(self.executor)

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        return logits[..., : self.cfg.vocab].argmax(-1)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """The greedy pick at the last position, copied to the host: the
        copy waits for the call's work on the card, and that wait is
        summed into ``wait_s`` (a ``repro.engine.sample`` span).  Then the
        executor's reports of the call's runs are delivered."""
        with span("engine.sample"):
            nxt = self._greedy(logits)[:, 0]
            t0 = time.perf_counter()
            out = nxt.cpu().numpy()
            self.wait_s += time.perf_counter() - t0
            self._settle()
        return out

    def _settle(self) -> None:
        """Deliver the reports a one-program executor holds until its runs
        have finished on the card, as they have after a copy to the host
        (the thread pool's are delivered as its runs return)."""
        settle = getattr(self.executor, "settle", None)
        if settle is not None:
            settle()

    def _count_prefill(self, tokens: int) -> None:
        self.prefill_calls += 1
        self.prefill_tokens += int(tokens)

    def generate(self, requests: Sequence[Request]) -> list[Completion]:
        t0 = time.perf_counter()
        out: list[Completion] = []
        # bucket by (prompt length, max_new) for exact equal-length batching
        buckets: dict[tuple, list[Request]] = {}
        first_seen: dict[tuple, int] = {}
        for i, r in enumerate(requests):
            key = (len(r.prompt), r.max_new)
            buckets.setdefault(key, []).append(r)
            first_seen.setdefault(key, i)
        # buckets run serially, so their order IS queueing policy: earliest
        # arrival first (input position breaking ties)
        ordered = sorted(
            buckets.items(),
            key=lambda kv: (min(r.arrival_s for r in kv[1]), first_seen[kv[0]]))
        with self.executor_ctx():
            for (T, max_new), rs in ordered:
                for i in range(0, len(rs), self.max_batch):
                    chunk = rs[i: i + self.max_batch]
                    out.extend(self._run_batch(chunk, T, max_new, t0))
        return sorted(out, key=lambda c: c.rid)

    # -- step-level API ------------------------------------------------------
    # One model step each; callers enter `executor_ctx()` around a step so
    # coded GEMMs reach the pool, and compose lanes with cache_cat /
    # cache_take.  A prefill is a `repro.engine.prefill` span, a decode
    # step a `repro.engine.decode` one.

    def prefill_batch(self, prompts: np.ndarray, max_seq: int
                      ) -> tuple[np.ndarray, dict]:
        """Prefill b equal-length prompts: (b, T) int -> ((b,) first
        generated tokens, cache with per-lane (b,) positions sized for
        ``max_seq``)."""
        with span("engine.prefill"):
            toks = self._tokens(prompts)
            b, T = toks.shape
            self._count_prefill(b * T)
            logits, cache = self._prefill(self.params, toks, max_seq)
            cache = {**cache, "pos": torch.full((b,), T, dtype=torch.int32,
                                                device=self.device)}
            return self._sample(logits), cache

    def decode_batch(self, cache: dict, tokens: np.ndarray
                     ) -> tuple[np.ndarray, dict]:
        """One decode step for the whole running batch: (B,) last tokens ->
        ((B,) next tokens, updated cache).  The step's FFN GEMMs see the
        stacked (B, d) token batch: ONE coded dispatch per GEMM."""
        with span("engine.decode"):
            toks = self._tokens(tokens)[:, None]
            logits, cache = self._decode(self.params, cache, toks)
            return self._sample(logits), cache

    # -- prefill-efficient serving ------------------------------------------
    # Each call's sampled tokens leave the device once, at its end (the
    # host copy that also finishes the call's device work).

    @property
    def supports_packed(self) -> bool:
        """Whether packed mixed-length prefill / chunk resume / prefix
        caching are exact for this engine's architecture (dense attention,
        no MoE, no SSM state, no sliding window)."""
        return supports_prefill_pack(self.cfg)

    def _require_packed(self, what: str) -> None:
        if not self.supports_packed:
            raise ValueError(
                f"{what} needs a dense-attention architecture (packed "
                "padding must be invisible to real tokens and KV slices "
                "must resume): see models.supports_prefill_pack "
                f"(cfg: block={self.cfg.block!r}, "
                f"n_experts={self.cfg.n_experts}, "
                f"sliding_window={self.cfg.sliding_window})")

    def prefill_packed(self, prompts: Sequence[np.ndarray], max_seq: int
                       ) -> tuple[np.ndarray, dict]:
        """Prefill b prompts of MIXED lengths in one padded, masked call:
        -> ((b,) first generated tokens, cache with per-lane (b,)
        positions).  Prompts are right-padded to the longest; causality
        keeps padding in every real token's future and each lane's logits
        are gathered at its own last real position, so tokens match the
        per-length prefill while the coded GEMMs see one (b * T_max, d)
        token stack: ONE n-piece dispatch per GEMM for the admission."""
        self._require_packed("prefill_packed (mixed-length packing)")
        lens = np.asarray([len(p) for p in prompts], np.int32)
        if lens.min() < 1:
            raise ValueError("prefill_packed needs non-empty prompts")
        with span("engine.prefill"):
            T = int(lens.max())
            toks = np.zeros((len(lens), T), np.int32)
            for j, p in enumerate(prompts):
                toks[j, : lens[j]] = np.asarray(p, np.int32)
            self._count_prefill(lens.sum())
            logits, cache = self._prefill_pack(
                self.params, self._tokens(toks),
                torch.as_tensor(lens, device=self.device), max_seq)
            return self._sample(logits), cache

    def new_stream_cache(self, max_seq: int, batch: int = 1) -> dict:
        """Empty ring cache for a chunked-prefill stream (scalar pos 0):
        feed it prompt chunks via :meth:`prefill_chunk`."""
        self._require_packed("chunked prefill")
        return init_cache(self.cfg, batch, max_seq, device=self.device)

    def prefill_chunk(self, cache: dict, tokens: np.ndarray
                      ) -> tuple[np.ndarray, dict]:
        """Consume one (b, Tc) chunk of prompt into a stream cache:
        -> ((b,) next-token samples at the chunk's last position, updated
        cache).  The tokens only mean anything on the final chunk; the
        cache is valid after every chunk.  A chunk's FFN GEMMs take the
        coded path like any prefill: chunks with >= k token rows dispatch
        to the executor, smaller ones (a prefix-cache hit's one-token
        suffix) stay on the master and issue no dispatch."""
        self._require_packed("prefill_chunk (chunk resume)")
        toks = self._tokens(tokens)
        pos0 = int(cache["pos"])
        S = _seq_extent(cache)
        if pos0 + toks.shape[1] > S:
            raise ValueError(
                f"chunk overruns the ring cache: pos {pos0} + chunk "
                f"{toks.shape[1]} > cache extent {S}")
        with span("engine.prefill"):
            self._count_prefill(toks.numel())
            logits, cache = self._resume(self.params, cache, toks)
            return self._sample(logits), cache

    def kv_prefix(self, cache: dict, lane: int, t0: int, t1: int) -> list:
        """One lane's KV for positions [t0, t1) out of a batch cache — the
        segment a :class:`~repro_torch.serving.prefix_cache.PrefixCache`
        stores per block: per-layer device copies with a length-1 lane
        axis (copies, so that a cached block does not keep the whole
        batch cache alive)."""
        return _tree_map(lambda x: x[lane: lane + 1, t0:t1].clone(),
                         cache["layers"])

    def cache_from_prefix(self, segments: Sequence, length: int,
                          max_seq: int) -> dict:
        """Rebuild a single-lane stream cache on the engine's device from
        prefix-cache segments: slots [0, length) restored, ``pos`` the
        SCALAR ``length``, ready for :meth:`prefill_chunk` to consume the
        prompt's unmatched suffix.  Restored KV is post-decode plaintext:
        no coded GEMM runs for it, and the live (n, k) is irrelevant to
        its validity."""
        self._require_packed("prefix-cache restore")
        base = init_cache(self.cfg, 1, max_seq, device=self.device)
        joined = _tree_map(lambda *xs: torch.cat(xs, dim=1), *segments)

        def put(z, seg):
            z[:, : seg.shape[1]] = seg.to(z.dtype)
            return z

        layers = _tree_map(put, base["layers"], joined)
        return {"layers": layers,
                "pos": torch.tensor(length, dtype=torch.int32,
                                    device=self.device)}

    def _run_batch(self, chunk: list[Request], T: int, max_new: int,
                   t0: float):
        toks = self._tokens(np.stack([r.prompt for r in chunk]))
        logits, cache = self._prefill(self.params, toks, T + max_new)
        generated = []
        nxt = self._greedy(logits)
        t_first = None
        for step in range(max_new):
            step_tok = nxt[:, 0].cpu().numpy()  # materialized -> token exists
            self._settle()
            if t_first is None:
                t_first = time.perf_counter() - t0
            generated.append(step_tok)
            if step + 1 < max_new:  # the last token needs no further decode
                logits, cache = self._decode(self.params, cache, nxt)
                nxt = self._greedy(logits)
        dt = time.perf_counter() - t0
        if t_first is None:  # max_new == 0: prefill-only request
            t_first = dt
        gen = (np.stack(generated, axis=1).astype(np.int32) if generated
               else np.zeros((len(chunk), 0), np.int32))  # (B, max_new)
        out = []
        for j, r in enumerate(chunk):
            shift = min(max(r.arrival_s - t0, 0.0), dt)
            out.append(Completion(r.rid, gen[j], dt - shift,
                                  max(t_first - shift, 0.0)))
        return out


# ---------------------------------------------------------------------------
# cache membership: join/leave for continuous batching
# ---------------------------------------------------------------------------
# A running-batch cache is the tree prefill/decode_step use, with `pos`
# widened to a (B,) vector.  The port keeps a per-layer list, so the lane
# axis of every leaf is 0.


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [_tree_map(fn, *parts) for parts in zip(*trees)]
    return fn(*trees)


def _seq_extent(cache: dict) -> int:
    """Ring size S of a dense-attention cache (the slot axis sits just
    after the lanes)."""
    return int(cache["layers"][0]["kv"]["k"].shape[1])


def cache_cat(caches: Sequence[dict]) -> dict:
    """Concatenate running-batch caches along the lane axis (join)."""
    if not caches:
        raise ValueError("cache_cat needs at least one cache")
    if len(caches) == 1:
        # still normalize pos to the (B,) lane vector the multi-cache path
        # produces, so downstream rank never depends on how many joined
        return {"layers": caches[0]["layers"],
                "pos": torch.atleast_1d(caches[0]["pos"])}
    layers = _tree_map(lambda *xs: torch.cat(xs, dim=0),
                       *(c["layers"] for c in caches))
    pos = torch.cat([torch.atleast_1d(c["pos"]) for c in caches])
    return {"layers": layers, "pos": pos}


def cache_take(cache: dict, lanes: Sequence[int]) -> dict:
    """Keep only ``lanes`` (in the given order) of a running-batch cache —
    how finished requests leave the batch."""
    pos = torch.atleast_1d(cache["pos"])
    idx = torch.as_tensor(list(lanes), dtype=torch.long, device=pos.device)
    layers = _tree_map(lambda x: x.index_select(0, idx.to(x.device)),
                       cache["layers"])
    return {"layers": layers, "pos": pos.index_select(0, idx)}
