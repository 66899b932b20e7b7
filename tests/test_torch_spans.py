"""The port's live spans (``telemetry.trace.span``) and the scheduler's
real-clock counters.

With no profiler running ``span`` hands back one shared no-op context and
builds nothing; under a profiler it is a ``record_function`` named
``repro.<name>``, so the program's stages lie in the profile beside the
ops they hold.  ``StepRecord``'s real-clock fields are counted on a
measured serve (the mesh backend, and no executor at all) and stay 0 on
the virtual plane, though the engine's own counters run there too.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.dist import (CodedExecutor, DeterministicDelay, FakeClock,
                              MeshExecutor)
from repro_torch.models.model import ModelConfig
from repro_torch.serving import Engine, Request, ServingScheduler
from repro_torch.telemetry import trace

TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=64, gated=False, dtype=torch.float32)
REAL = ("wait_s", "sched_s", "prefill_calls", "prefill_tokens")


def _reqs(n=6):
    lens = [4, 4, 7, 7, 5, 9]
    return [Request(i, (np.arange(lens[i % 6]) + 3 * i).astype(np.int32)
                    % 64, max_new=3, arrival_s=0.01 * i) for i in range(n)]


def _serve(executor=None, **kw):
    coded = dict(coded_n=4, coded_k=2) if executor is not None else {}
    eng = Engine(ModelConfig(**TINY, **coded), seed=0, executor=executor,
                 device="cpu")
    res = ServingScheduler(eng, max_seq=16, max_batch=4,
                           master_call_s=0.001, **kw).serve(_reqs())
    return eng, res


def test_span_off_is_one_shared_no_op(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    a, b = trace.span("serve.step"), trace.span("mesh.sync")
    assert a is b
    with a:
        pass


def test_span_on_records_under_its_name():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("coded.matmul"):
            torch.ones(2) + 1
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "repro.coded.matmul" in names


def test_virtual_serve_keeps_real_fields_at_zero():
    with CodedExecutor(4, clock=FakeClock(),
                       delay_model=DeterministicDelay(0.01)) as ex:
        eng, res = _serve(ex)
    assert res.steps and eng.prefill_calls > 0
    for s in res.steps:
        assert [getattr(s, f) for f in REAL] == [0.0, 0.0, 0, 0]


@pytest.mark.parametrize("backend,kw", [
    ("mesh", {}), ("none", {}), ("none", dict(chunk_tokens=4)),
    ("none", dict(packed=False))], ids=["mesh", "none", "chunked", "grouped"])
def test_measured_serve_counts_its_steps(backend, kw):
    """Packed, chunked and per-length prefills each count their prompt
    tokens once."""
    ex = MeshExecutor() if backend == "mesh" else None
    eng, res = _serve(ex, **kw)
    assert sum(s.prefill_calls for s in res.steps) == eng.prefill_calls > 0
    assert sum(s.prefill_tokens for s in res.steps) == \
        eng.prefill_tokens == sum(len(r.prompt) for r in _reqs())
    for s in res.steps:
        assert s.sched_s >= 0.0
        assert 0.0 <= s.wait_s <= s.t_end - s.t_start
    waited = sum(s.wait_s for s in res.steps)
    assert waited == pytest.approx(
        eng.wait_s + (ex.wait_s if ex is not None else 0.0), abs=1e-9)
    if ex is not None:
        assert ex.run_count > 0 and ex.wait_s >= 0.0
