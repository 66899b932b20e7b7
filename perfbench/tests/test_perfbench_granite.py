"""The cells this benchmark gained with granite-4.0-h-small: the spec
loads them with their metrics, the new readers read a synthetic
observation, the expert GEMM's least time is that of a known shape, and a
``granite`` run driven on the CPU at a tiny size is correct when sound and
not correct with a fault planted in its mixture of experts."""
import pytest
import torch

import perfbench_tiny as tiny
import perfbench_tiny_granite as tiny_granite
from benchlib import roofline, roofline_moe, spec
from benchlib.trace import TraceData
from drivers.lm_serve import Obs

GRANITE = "granite4h.prefill.mesh"
CHAT = "zamba2.chat.mesh"


def _names(cell):
    return [m["name"] for m in cell.per_layer]


def test_the_granite_cell_loads_with_its_metrics():
    cell = spec.load_cell(GRANITE)
    assert cell.chips == 1 and cell.config_name == "granite-4.0-h-small"
    assert cell.workload["driver"] == "lm_serve_moe"
    assert cell.workload["backend"] == "mesh"
    assert [m["name"] for m in cell.end_to_end] == ["tokens_per_s",
                                                    "setup_s"]
    assert _names(cell) == [
        "ttft_p95_ms", "tpot_p95_ms", "queue_wait_p50_ms",
        "prefill_tokens_per_call", "decode_step_ms", "piece_gemm_roofline",
        "sched_host_ms", "decode_host_ms", "decode_wait_ms",
        "sched_prefill_tokens_per_call", "expert_gemm_roofline",
        "moe_rows_per_expert", "mesh.run_ms.granite4h",
        "idle_share.granite4h", "mfu.granite4h"]
    m = cell.config["model"]
    assert (m["n_layers"], m["d_model"], m["n_experts"], m["experts_held"],
            m["top_k"], m["d_ff"], m["shared_d_ff"]) == (
        40, 4096, 72, 18, 10, 768, 1536)
    assert cell.config["num_local_experts"] == 18
    assert cell.config["published_num_local_experts"] == 72


def test_the_chat_cell_loads_with_its_metrics():
    cell = spec.load_cell(CHAT)
    assert cell.chips == 1 and cell.config_name == "zamba2-1.2b"
    assert cell.workload["driver"] == "lm_serve"
    assert cell.workload["max_batch"] == 32
    assert [m["name"] for m in cell.end_to_end] == ["tokens_per_s",
                                                    "setup_s"]
    assert _names(cell) == [
        "ttft_p95_ms", "tpot_p95_ms", "queue_wait_p50_ms",
        "prefill_tokens_per_call", "decode_step_ms", "mesh.run_ms.zamba2",
        "piece_gemm_roofline", "idle_share.zamba2", "mfu.zamba2",
        "sched_host_ms", "decode_host_ms", "decode_wait_ms",
        "sched_prefill_tokens_per_call"]
    assert cell.traffic["requests_per_s"] == cell.traffic["arrivals"]["rate"]


def test_expert_gemm_least_time_of_a_known_shape():
    # 5,000 rows over 36 experts, 30 of them with rows, K 4096, N 768:
    # 2 * 5000 * 4096 * 768 = 3.146e10 flops (31.8 us at 989 TFLOP/s);
    # 2 * (5000 * 4864 + 30 * 4096 * 768) = 2.374e8 bytes (70.9 us):
    # bound by the bytes
    sizes = [0] * 6 + [5000 // 30] * 29 + [5000 - 29 * (5000 // 30)]
    least = roofline_moe.expert_gemm_least_s(sizes, 4096, 768)
    n_bytes = 2 * (5000 * (4096 + 768) + 30 * 4096 * 768)
    assert least == pytest.approx(n_bytes / roofline.PEAK_BYTES_PER_S)
    # a prefill's rows make it bound by the operations
    big = roofline_moe.expert_gemm_least_s([20000] * 36, 4096, 768)
    assert big == pytest.approx(2.0 * 720000 * 4096 * 768 / 989e12)


def _obs(**kw):
    trace = TraceData(window_s=2.0, busy_s=1.5,
                      kernel_s={"expert_grouped_gemm_0d1d": 0.004,
                                "piece_gemm_tiled": 0.5},
                      kernel_n={}, device_ops=[], idle_gaps=[])
    base = dict(trace=trace, records=[], steps=[], calls=[], run_walls_s=
                [0.001, 0.003, 0.002], traced_ops=[], traced_flops=9.89e12,
                dtype="bfloat16", serve_s=1.0,
                moe={"calls": 80, "tokens": 8000, "rows": 40000,
                     "dropped": 0, "max_group": 900, "held": 36},
                expert_gemms=[(4096, 768, [100] * 36),
                              (768, 4096, [100] * 36)])
    base.update(kw)
    return Obs(**base)


def _read(name, obs):
    return spec.load_module(spec.metric_path(name)).read(obs)


def test_the_new_readers_on_a_synthetic_observation():
    obs = _obs()
    least = 2 * roofline_moe.expert_gemm_least_s([100] * 36, 4096, 768)
    assert _read("expert_gemm_roofline", obs) == pytest.approx(
        100.0 * least / 0.004)
    assert _read("moe_rows_per_expert", obs) == pytest.approx(
        40000 / (80 * 36))
    assert _read("mesh.run_ms.granite4h", obs) == pytest.approx(2.0)
    assert _read("idle_share.granite4h", obs) == pytest.approx(25.0)
    assert _read("mfu.granite4h", obs) == pytest.approx(0.5)


@pytest.mark.parametrize("name", ["expert_gemm_roofline",
                                  "moe_rows_per_expert",
                                  "mesh.run_ms.granite4h",
                                  "idle_share.granite4h", "mfu.granite4h"])
def test_the_new_readers_read_nothing_where_there_is_nothing(name):
    """An observation of a program without the mixture's counters, or an
    untraced run: the reader returns None and does not raise."""
    bare = _obs(trace=None, run_walls_s=[])
    del bare.moe, bare.expert_gemms
    assert _read(name, bare) is None


def test_sound_granite_run_is_correct():
    out = tiny.run(tiny_granite.granite_cell(), 2.0, trace=True)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 4
    checks = {c["name"]: c for c in out["checks"]}
    assert set(checks) == {"logit_gap", "graphs_in_window", "dropped_slots"}
    assert all(c["value"] <= c["limit"] for c in checks.values())
    obs = out["obs"]
    assert obs.moe["calls"] > 0 and obs.moe["rows"] > 0
    assert obs.moe["dropped"] == 0 and obs.moe["held"] == 4
    assert obs.expert_gemms and obs.traced_flops > 0
    # each traced call's groups: one size per held expert
    assert all(len(sizes) == 4 for _, _, sizes in obs.expert_gemms)


def broken(monkeypatch, fault):
    from repro_torch.models import model as TM
    from repro_torch.models import moe

    layer = moe.dropless_moe
    if fault == "no_shared_expert":
        def hybrid_ffn(cfg, lyr, h):
            u = TM.rms_norm(h, lyr["ffn_norm"], cfg.norm_eps)
            return TM._residual(cfg, h, layer(lyr["moe"], u, cfg.top_k))
        monkeypatch.setattr(TM, "_hybrid_ffn", hybrid_ffn)
        return

    def planted(p, x, top_k, first=0):
        if fault == "renormalised":  # the gates over the held experts only
            gates, is_held, *_ = moe.route(p["router"], x.reshape(
                -1, x.shape[-1]), top_k, first, p["w_in"].shape[0])
            held_sum = (gates * is_held).reshape(-1, top_k).sum(-1)
            out = layer(p, x, top_k, first)
            return out / held_sum.clamp(min=1e-9).reshape(out.shape[:-1])[
                ..., None]
        # a held expert's rows dropped: expert 0 computes nothing
        q = dict(p, w_out=p["w_out"].clone())
        q["w_out"][0] = 0
        return layer(q, x, top_k, first)

    monkeypatch.setattr(TM, "dropless_moe", planted)


@pytest.mark.parametrize("fault", ["no_shared_expert", "renormalised",
                                   "expert_dropped"])
def test_broken_mixture_is_not_correct(monkeypatch, fault):
    broken(monkeypatch, fault)
    out = tiny.run(tiny_granite.granite_cell(), 3.0, seed=12)
    assert not out["correct"]
    gap = next(c for c in out["checks"] if c["name"] == "logit_gap")
    assert gap["value"] > gap["limit"]


def test_short_grid_is_counted_as_dropped_and_not_correct(monkeypatch):
    """The grouped GEMM's grid cut to one row block: the slots of held
    experts it leaves uncomputed read as ``dropped_slots``."""
    from repro_torch.kernels import grouped_gemm as gg

    plan = gg.gemm_plan
    monkeypatch.setattr(gg, "gemm_plan", lambda rows, groups: (
        plan(rows, groups)[0], 1))
    out = tiny.run(tiny_granite.granite_cell(), 2.0, seed=12)
    assert not out["correct"]
    dropped = next(c for c in out["checks"] if c["name"] == "dropped_slots")
    assert dropped["value"] > 0 and dropped["value"] == out["obs"].moe[
        "dropped"]


def test_granite_control_reads_at_least_the_program():
    out = tiny.run(tiny_granite.granite_cell(), 2.0, control=True)
    (ctl,) = out["control"]["checks"]
    gap = next(c for c in out["checks"] if c["name"] == "logit_gap")
    assert ctl["limit"] == gap["limit"] and ctl["value"] >= gap["value"]


@pytest.mark.card
def test_granite_program_and_control_at_cell_size(card):
    """On the card at the cell's own size: the program within its limits
    and the control (float8 weights) not, on one seed."""
    cell = spec.load_cell(GRANITE)
    out = cell.driver.run(cell, seed=3_000_000_301, seconds=15.0,
                          trace=False, device="cuda", t_start=0.0,
                          control=True)
    assert out["correct"] and not out["control"]["correct"]
    assert torch.cuda.is_available()
