"""The rest of a ``zamba2`` run, driven on the CPU at a tiny size with the
look for a card skipped: a sound run comes out correct, and with the
timed path broken underneath ``correct`` comes out false."""
import numpy as np
import pytest

import perfbench_tiny as tiny


def test_sound_run_is_correct():
    out = tiny.run(tiny.lm_cell(), 2.0, trace=True)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 4
    assert out["e2e"]["tokens_per_s"] > 0 and out["e2e"]["setup_s"] > 0
    (c,) = out["checks"]
    assert c["name"] == "logit_gap" and c["value"] <= c["limit"]
    obs = out["obs"]
    served = sum(r.prompt_len + r.n_tokens for r in obs.records)
    # the rate is over the serve's wall time, which holds every step's
    assert out["e2e"]["tokens_per_s"] == served / obs.serve_s
    assert obs.serve_s >= sum(s.t_end - s.t_start for s in obs.steps)
    assert obs.trace is not None and obs.traced_ops and obs.traced_flops > 0
    # the served window was not profiled: its calls carry no traced mark
    assert obs.calls and not any(t for *_, t in obs.calls)


def broken(monkeypatch, fault):
    from repro_torch.serving.engine import Engine

    decode = Engine.decode_batch

    def wrapped(self, cache, tokens):
        nxt, new = decode(self, cache, tokens)
        nxt = np.array(nxt)
        if fault == "state_unchanged":  # the step hands back its input
            return nxt, cache
        if fault == "altered":  # a token changed where it is produced
            nxt[0] = (nxt[0] + 1) % self.cfg.vocab
        elif fault == "half_batch" and len(nxt) > 1:
            nxt[len(nxt) // 2:] = nxt[0]
        return nxt, new

    monkeypatch.setattr(Engine, "decode_batch", wrapped)


@pytest.mark.parametrize("fault", ["state_unchanged", "altered",
                                   "half_batch"])
def test_broken_path_is_not_correct(monkeypatch, fault):
    broken(monkeypatch, fault)
    out = tiny.run(tiny.lm_cell(), 3.0, seed=12)
    assert not out["correct"]
    assert out["checks"][0]["value"] > out["checks"][0]["limit"]


def test_missing_answers_count_as_failed(monkeypatch):
    from repro_torch.serving.scheduler import ServingScheduler

    serve = ServingScheduler.serve

    def drop_one(self, requests):
        res = serve(self, requests)
        res.completions = res.completions[1:]
        return res

    monkeypatch.setattr(ServingScheduler, "serve", drop_one)
    out = tiny.run(tiny.lm_cell(), 2.0)
    assert not out["correct"] and out["failed"] == 1


def test_control_reads_at_least_the_program():
    out = tiny.run(tiny.lm_cell(), 2.0, control=True)
    (ctl,) = out["control"]["checks"]
    assert ctl["name"] == "logit_gap" and ctl["limit"] == \
        out["checks"][0]["limit"]
    assert ctl["value"] >= out["checks"][0]["value"]
    assert out["control"]["correct"] == (ctl["value"] <= ctl["limit"])


@pytest.mark.card
def test_control_fails_at_cell_size(card):
    """On the card at the cell's own size, three seeds: the program is
    within the limit and the control (float8 weights) is not."""
    from benchlib import spec

    cell = spec.load_cell("zamba2.prefill.mesh")
    for seed in (201, 202, 203):
        out = cell.driver.run(cell, seed=seed, seconds=15.0, trace=False,
                              device="cuda", t_start=0.0, control=True)
        assert out["correct"] and not out["control"]["correct"]
