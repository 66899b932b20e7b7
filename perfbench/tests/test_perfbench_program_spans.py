"""The program's own spans and real-clock counters, seen through the
benchmark's tiny cells on the CPU: the ``repro.*`` spans lie in a torch
profile nested stage in stage, the pool's pieces on their worker threads;
the scheduler's steps carry the real-clock counters; and the four readers
of those counters give finite values on an lm run and nothing on a cnn
one."""
import math
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import perfbench_tiny as tiny
from benchlib import spec

LM_SPANS = {"repro.serve.step", "repro.serve.admit", "repro.serve.join",
            "repro.serve.retire", "repro.engine.prefill",
            "repro.engine.decode", "repro.engine.sample",
            "repro.model.mamba", "repro.model.attn", "repro.model.head",
            "repro.coded.matmul", "repro.mesh.replay", "repro.mesh.sync"}
CNN_SPANS = {"repro.cnn.layer", "repro.cnn.head", "repro.coded.segment",
             "repro.coded.encode", "repro.coded.decode",
             "repro.coded.assemble", "repro.pool.wait", "repro.pool.piece"}
READERS = ["sched_host_ms", "decode_host_ms", "decode_wait_ms",
           "sched_prefill_tokens_per_call"]


def events(prof) -> list:
    """(name, start_ns, end_ns, thread) of every host event."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()]


def enclosing(ev, spans: list) -> list:
    """Names of the ``repro.*`` spans on ``ev``'s thread that hold it,
    innermost first."""
    name, s, e, tid = ev
    out = [x for x in spans if x is not ev and x[3] == tid
           and x[1] <= s and e <= x[2]]
    return [x[0] for x in sorted(out, key=lambda x: x[2] - x[1])]


@pytest.fixture(scope="module")
def lm_profile():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = tiny.run(tiny.lm_cell(), 1.0)
    assert out["correct"]
    return [ev for ev in events(prof) if ev[0].startswith("repro.")]


def test_lm_spans_nest_step_call_layer_matmul_mesh(lm_profile):
    assert {ev[0] for ev in lm_profile} == LM_SPANS
    main = {ev[3] for ev in lm_profile if ev[0] == "repro.serve.step"}
    assert len(main) == 1
    runs = [ev for ev in lm_profile
            if ev[0] in ("repro.mesh.replay", "repro.mesh.sync")]
    assert runs and {ev[3] for ev in runs} == main
    served = 0
    for ev in runs:
        chain = enclosing(ev, lm_profile)
        assert chain[0] == "repro.coded.matmul", chain
        if "repro.serve.step" not in chain:
            continue  # the warm-up's calls, outside the scheduler
        assert chain[1:] in (
            ["repro.model.attn", "repro.engine.prefill", "repro.serve.step"],
            ["repro.model.attn", "repro.engine.decode", "repro.serve.step"],
        ), chain
        served += 1
    assert served > 0
    for ev in lm_profile:
        chain = enclosing(ev, lm_profile)
        if ev[0] in ("repro.model.mamba", "repro.model.head"):
            assert chain[0].startswith("repro.engine."), chain
        elif ev[0] == "repro.engine.sample":
            assert chain[0] in ("repro.engine.prefill",
                                "repro.engine.decode"), chain
        elif ev[0].startswith("repro.serve.") and ev[0] != "repro.serve.step":
            assert chain == ["repro.serve.step"], (ev[0], chain)


def test_cnn_pool_spans_and_pieces_on_worker_threads():
    """VGG16's tiny cell on the real-clock pool, under a profiler that
    follows every thread: the pieces' spans lie on the pool's threads,
    the master's stages on the thread that ran the forward."""
    from torch._C._profiler import _ExperimentalConfig

    cfg = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=cfg) as prof:
        out = tiny.run(tiny.vgg_cell(), 0.5)
    assert out["correct"]
    evs = [ev for ev in events(prof) if ev[0].startswith("repro.")]
    assert {ev[0] for ev in evs} == CNN_SPANS
    (master,) = {ev[3] for ev in evs if ev[0] == "repro.cnn.head"}
    pieces = [ev for ev in evs if ev[0] == "repro.pool.piece"]
    assert pieces and all(ev[3] != master for ev in pieces)
    assert len({ev[3] for ev in pieces}) > 1
    for ev in evs:
        if ev[0] in ("repro.coded.encode", "repro.coded.assemble",
                     "repro.pool.wait"):
            assert ev[3] == master
            assert "repro.coded.segment" in enclosing(ev, evs), ev[0]


@pytest.fixture(scope="module")
def lm_run():
    return tiny.run(tiny.lm_cell(), 2.0, trace=True)


def test_real_clock_step_counters(lm_run):
    """Every step of the real-clock mesh serve: the scheduler's own time
    is not negative, the waits on the card lie within the step's calls,
    and the program's prefill count gives the benchmark's own."""
    obs = lm_run["obs"]
    assert obs.steps
    for s in obs.steps:
        assert s.sched_s >= 0.0
        assert 0.0 <= s.wait_s <= s.t_end - s.t_start
    pre = [(rows, T) for kind, rows, T, _ in obs.calls if kind == "prefill"]
    assert sum(s.prefill_calls for s in obs.steps) == len(pre)
    assert sum(s.prefill_tokens for s in obs.steps) == \
        sum(rows * T for rows, T in pre)
    assert any(s.wait_s > 0.0 for s in obs.steps)


@pytest.mark.parametrize("name", READERS)
def test_readers_on_an_lm_run(lm_run, name):
    value = spec.load_module(spec.metric_path(name)).read(lm_run["obs"])
    assert value is not None and math.isfinite(value) and value >= 0.0


def test_prefill_tokens_per_call_read_alike(lm_run):
    obs = lm_run["obs"]
    ours = spec.load_module(spec.metric_path(
        "sched_prefill_tokens_per_call")).read(obs)
    theirs = spec.load_module(spec.metric_path(
        "prefill_tokens_per_call")).read(obs)
    assert ours == pytest.approx(theirs, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_on_a_cnn_run(name):
    obs = types.SimpleNamespace(kind="cnn", trace=None, steps=[],
                                latencies_s=[0.1], run_walls_s=[0.01])
    assert spec.load_module(spec.metric_path(name)).read(obs) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_without_the_counters(name):
    """A program whose steps keep no real-clock counter (before they were
    added): the readers return None and do not raise."""
    step = types.SimpleNamespace(t_start=0.0, t_end=0.1, admitted=0,
                                 batch=2)
    obs = types.SimpleNamespace(kind="lm", trace=None, steps=[step],
                                calls=[], records=[])
    assert spec.load_module(spec.metric_path(name)).read(obs) is None


@pytest.mark.parametrize("cell", [tiny.lm_cell, tiny.vgg_cell],
                         ids=["lm", "cnn"])
def test_no_profiler_no_span_built(monkeypatch, cell):
    """Run with no profiler, no span builds a ``record_function``."""
    from repro_torch.telemetry import trace

    def boom(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert trace.span("a") is trace.span("b")
    assert tiny.run(cell(), 0.5)["correct"]
