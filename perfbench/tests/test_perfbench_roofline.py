"""Each roofline and mfu count against a hand-worked shape."""
import json
import types

import pytest

from benchlib import roofline, spec
from benchlib.trace import TraceData


def trace_of(window_s, busy_s, kernel_s):
    return TraceData(window_s=window_s, busy_s=busy_s, kernel_s=kernel_s,
                     kernel_n={k: 1 for k in kernel_s}, device_ops=[],
                     idle_gaps=[])


def test_peaks():
    assert roofline.PEAK_BYTES_PER_S == 3.35e12
    assert roofline.PEAK_FLOPS == {"float32": 495e12, "bfloat16": 989e12}


def test_conv_hand_count():
    c = roofline.Conv(batch=2, c_in=3, c_out=4, h_in=6, w_in=6, kernel=3)
    assert (c.h_out, c.w_out) == (4, 4)
    assert c.flops() == 2 * 2 * 4 * 3 * 9 * 16 == 6912
    assert c.bytes() == 4 * (2 * 3 * 36 + 4 * 3 * 9 + 2 * 4 * 16) == 1808
    assert c.least_s() == pytest.approx(1808 / 3.35e12)
    piece = roofline.conv_piece(c, 2)
    assert (piece.w_in, piece.w_out) == (4, 2)
    assert roofline.width_split(112, 6) == (18, 4)


def test_stacked_gemm_hand_count():
    flops = 2 * 10 * 5 * 2048 * 8192
    n_bytes = 4 * (10 * 5 * 2048 + 2048 * 8192 + 10 * 5 * 8192)
    assert roofline.bound(n_bytes, flops, "float32") == (
        pytest.approx(n_bytes / 3.35e12), "bytes")
    assert roofline.stacked_gemm_least_s(10, 5, 2048, 8192) == \
        pytest.approx(n_bytes / 3.35e12)
    big = roofline.stacked_gemm_least_s(10, 5462, 2048, 8192)
    assert big == pytest.approx(2 * 10 * 5462 * 2048 * 8192 / 495e12)


def test_vgg16_conv_work_by_hand():
    """conv2_2 of a batch of 32, k = 6: 9 live pieces of 18 columns (20
    input columns) and a remainder of 4, against the per-request sum."""
    from repro_torch.core import SystemParams, compile_plan
    from repro_torch.models.cnn import vgg16_conv_specs

    cell = spec.load_cell("vgg16.b128.pool")
    cfg, ref = cell.config, cell.reference
    plan = compile_plan(vgg16_conv_specs(224), 10, SystemParams(), "mds")
    work = cell.driver.conv_work(cfg, ref, plan, 32, 9)

    def least(flops, n_bytes):
        return max(flops / 495e12, n_bytes / 3.35e12)

    total = flops_all = 0.0
    k_of = {i: s.scheme.k for s in plan.segments
            for i in range(s.start, s.stop)}
    for i, (name, ci, co, size, _) in enumerate(cfg["conv_layers"]):
        hin = size + 2
        full = 2.0 * 32 * co * ci * 9 * size * size
        flops_all += full
        if i not in k_of:
            total += least(full, 4 * (32 * ci * hin * hin + co * ci * 9
                                      + 32 * co * size * size))
            continue
        k = k_of[i]
        for cols, count in ((size // k, 9), (size - k * (size // k), 1)):
            if cols == 0:
                continue
            win = cols + 2
            total += count * least(
                2.0 * 32 * co * ci * 9 * size * cols,
                4 * (32 * ci * hin * win + co * ci * 9 + 32 * co * size * cols))
    assert {k_of[i] for i in k_of} == {6} and len(k_of) == 10
    assert work["conv_least_s"] == pytest.approx(total, rel=1e-12)
    assert work["model_flops"] == pytest.approx(
        flops_all + 2.0 * 32 * 25088 * 1000, rel=1e-12)
    # ~31 GFLOP an image for the convolutions: VGG16's published count
    assert flops_all / 32 == pytest.approx(30.7e9, rel=0.01)


def test_zamba2_matrix_flops_by_hand():
    cell = spec.load_cell("zamba2.prefill.mesh")
    f = cell.driver.matrix_flops
    cfg, ref = cell.config, cell.reference
    mamba = 2 * 2048 * 8384 + 2 * 4096 * 2048
    shared = (2 * 2048 * 96 * 64 + 2 * 32 * 64 * 2048
              + 3 * 2 * 2048 * 8192)
    per_token = 38 * mamba + 6 * shared
    head = 2 * 2048 * 32000
    assert f(cfg, ref, "decode", 8, 1) == 8 * (per_token + head)
    assert f(cfg, ref, "prefill", 2, 512) == (
        2 * 512 * per_token + 2 * head + 6 * 2 * 4 * 32 * 64 * 512 * 513 / 2)


def test_readers_hand_counts():
    load = lambda n: spec.load_module(spec.metric_path(n)).read
    obs = types.SimpleNamespace(
        kind="lm", trace=trace_of(2.0, 0.5, {"piece_gemm_tiled<...>": 1e-3,
                                              "other": 1.0}),
        traced_ops=[("matmul", 10, (6, 5, 2048), (2048, 8192))],
        traced_flops=989e12 * 0.02, dtype="bfloat16", records=[],
        calls=[("prefill", 2, 512, True), ("decode", 8, 1, True),
               ("prefill", 1, 1024, False)],
        steps=[], run_walls_s=[0.001, 0.003, 0.002])
    least = roofline.stacked_gemm_least_s(10, 5, 2048, 8192)
    assert load("piece_gemm_roofline")(obs) == pytest.approx(
        100 * least / 1e-3)
    assert load("idle_share.zamba2")(obs) == pytest.approx(75.0)
    assert load("mfu.zamba2")(obs) == pytest.approx(1.0)
    assert load("prefill_tokens_per_call")(obs) == pytest.approx(1024.0)
    assert load("mesh.run_ms.zamba2")(obs) == pytest.approx(2.0)
    assert load("idle_share.vgg16")(obs) is None
    rec = types.SimpleNamespace
    obs.records = [rec(ttft_s=0.1 * i, tpot_s=0.01 * i, n_tokens=2)
                   for i in range(1, 21)]
    assert load("ttft_p95_ms")(obs) == pytest.approx(1000 * (1.9 + 0.05 * 0.1))
    assert load("tpot_p95_ms")(obs) == pytest.approx(1000 * (0.19 + 0.005 * 0.1))
    cnn = types.SimpleNamespace(
        kind="cnn", trace=trace_of(1.0, 0.25, {"conv2d_implicit_gemm<>": 0.1}),
        traced_requests=4, conv_least_s=0.005, model_flops=495e12 * 0.01,
        dtype="float32", run_walls_s=[0.01, 0.02, 0.03],
        latencies_s=[0.1 * i for i in range(1, 21)])
    assert load("conv_roofline")(cnn) == pytest.approx(20.0)
    assert load("mfu.vgg16")(cnn) == pytest.approx(4.0)
    assert load("idle_share.vgg16")(cnn) == pytest.approx(75.0)
    assert load("pool.run_ms")(cnn) == pytest.approx(20.0)
    assert load("request_p95_ms")(cnn) == pytest.approx(
        1000 * (1.9 + 0.05 * 0.1))
    assert load("conv_roofline")(types.SimpleNamespace(
        kind="cnn", trace=None, traced_requests=0)) is None


def test_benchmark_names_every_reader_the_cells_use():
    bench = spec.load_benchmark()
    names = {m["name"] for m in bench["per_layer"]}
    files = {p.stem for p in (spec.BENCH / "metrics").glob("*.py")}
    assert names == files
    assert json.loads(spec.workload_path("vgg16.b128.pool").read_text())
