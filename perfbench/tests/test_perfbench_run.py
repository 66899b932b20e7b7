"""The command's contract around a run: no result without a card, without
the program, or for an unknown cell; the result line's keys, with the
compared numbers last."""
import json
import shutil
import subprocess
import sys
import types

import pytest

from benchlib import spec
from benchlib.trace import TraceData

RUN = spec.BENCH / "run.py"


def run_cmd(cwd, *args):
    return subprocess.run([sys.executable, str(cwd / "perfbench" / "run.py"),
                           *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = run_cmd(spec.ROOT, "--workload", "vgg16.b128.pool", "--seed",
                  str(2 ** 31 + 3), "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cmd(tmp_path, "--workload", "zamba2.prefill.mesh", "--seed",
                  "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert "not in this checkout" in out.stderr


def test_unknown_cell_no_result():
    out = run_cmd(spec.ROOT, "--workload", "nope", "--seed", "1",
                  "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


def fake_out():
    data = TraceData(window_s=2.0, busy_s=1.5, kernel_s={"k": 1.5},
                     kernel_n={"k": 3}, device_ops=[["k", 1.5]],
                     idle_gaps=[["aten::mm", 0.5]])
    obs = types.SimpleNamespace(kind="cnn", trace=data, traced_requests=2,
                                conv_least_s=0.0, model_flops=1e12,
                                dtype="float32", run_walls_s=[0.01],
                                latencies_s=[0.2] * 19 + [0.4])
    return {"e2e": {"images_per_s": 500.0, "setup_s": 12.0},
            "obs": obs, "correct": True, "attempted": 200, "failed": 0,
            "checks": [{"name": "logit_err", "value": 1e-4, "limit": 4e-4}],
            "device": {"memory_peak_bytes": 8, "platform": "gpu",
                       "kind": "x", "count": 1}}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    sys.path.insert(0, str(spec.BENCH))
    import run

    cell = spec.load_cell("vgg16.b128.pool")
    line = run.result_line(cell, fake_out(), trace)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert line["checks"] == {"logit_err": {"value": 1e-4, "limit": 4e-4}}
    names = set(line["metrics"])
    if trace:
        assert names == {"pool.run_ms", "idle_share.vgg16", "mfu.vgg16",
                         "request_p95_ms"}
        assert line["device"]["busy_s"] == 1.5
        assert line["device"]["window_s"] == 2.0
        assert line["breakdown"]["device_ops"] == [["k", 1.5]]
    else:
        assert names == {"images_per_s", "setup_s"}
        assert "breakdown" not in line
    json.dumps(line)
