"""The rest of a ``vgg16`` run, driven on the CPU at a tiny size with the
look for a card skipped: a sound run comes out correct, and with the
timed path broken underneath ``correct`` comes out false."""
import numpy as np
import pytest
import torch

import perfbench_tiny as tiny


def test_sound_run_is_correct():
    out = tiny.run(tiny.vgg_cell(), 1.5, trace=True)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 3
    assert out["e2e"]["images_per_s"] > 0 and out["e2e"]["setup_s"] > 0
    (c,) = out["checks"]
    assert c["name"] == "logit_err" and c["value"] <= c["limit"]
    obs = out["obs"]
    assert obs.trace is not None and obs.traced_requests == 2
    # the profiled requests stay out of the host-clock readings
    assert len(obs.latencies_s) == out["attempted"] - 2


def broken(monkeypatch, fault):
    from repro_torch.models import cnn

    forward = cnn.vgg16_forward

    def wrapped(params, x, *a, **kw):
        y = forward(params, x, *a, **kw)
        if fault == "altered":  # one answer changed where it is produced
            y = y.clone()
            y[0, 0] += 0.01 * float(y.abs().max())
        elif fault == "half_batch":  # half left out, the rest's mean
            y = y.clone()
            h = y.shape[0] // 2
            y[h:] = y[:h].mean(0)
        return y

    monkeypatch.setattr(cnn, "vgg16_forward", wrapped)


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
def test_broken_path_is_not_correct(monkeypatch, fault):
    broken(monkeypatch, fault)
    out = tiny.run(tiny.vgg_cell(), 1.0)
    assert not out["correct"]
    assert out["checks"][0]["value"] > out["checks"][0]["limit"]


def test_wrong_shape_counts_as_failed(monkeypatch):
    from repro_torch.models import cnn

    forward = cnn.vgg16_forward
    monkeypatch.setattr(cnn, "vgg16_forward",
                        lambda p, x, **kw: forward(p, x, **kw)[:1])
    out = tiny.run(tiny.vgg_cell(), 1.0)
    assert not out["correct"] and out["failed"] == out["attempted"]


def test_control_reads_above_the_program():
    out = tiny.run(tiny.vgg_cell(), 1.0, control=True)
    (ctl,) = out["control"]["checks"]
    assert ctl["name"] == "logit_err" and ctl["limit"] == \
        out["checks"][0]["limit"]
    assert ctl["value"] > 3 * out["checks"][0]["value"]
    assert np.isfinite(ctl["value"]) and torch.get_num_threads() >= 1
    assert out["control"]["correct"] == (ctl["value"] <= ctl["limit"])


@pytest.mark.card
def test_control_fails_at_cell_size(card):
    """On the card at the cell's own size, three seeds: the program is
    within the limit and the control (TF32 operands) is not."""
    from benchlib import spec

    cell = spec.load_cell("vgg16.b128.pool")
    for seed in (101, 102, 103):
        out = cell.driver.run(cell, seed=seed, seconds=5.0, trace=False,
                              device="cuda", t_start=0.0, control=True)
        assert out["correct"] and not out["control"]["correct"]
