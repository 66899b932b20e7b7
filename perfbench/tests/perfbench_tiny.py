"""Cells of the benchmark at sizes a CPU test run can hold: the cell's own
files, loaded by name, with the widths and the traffic cut down."""
from __future__ import annotations

import copy
import time

from benchlib import spec


def vgg_cell(name: str = "vgg16.b128.pool"):
    cell = spec.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(image=32, classes=10)
    for row in cfg["conv_layers"]:
        row[3] = row[3] * 32 // 224
    cell.config = cfg
    cell.traffic = dict(cell.traffic, batch=2, distinct_inputs=3)
    cell.workload = dict(cell.workload, warmup_requests=1,
                         trace_requests=[1, 3])
    return cell


def lm_cell(name: str = "zamba2.prefill.mesh"):
    cell = spec.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab=512, ssm_state=16, ssm_head_dim=16,
                        ssm_chunk=16, shared_attn_period=2, dtype="float32")
    cfg["dtype"] = "float32"
    cfg["embed_std"] = 1.0 / 64
    cell.config = cfg
    cell.traffic = dict(cell.traffic,
                        arrivals={"process": "poisson", "rate": 8.0},
                        prompt_len={"values": [16, 32, 64],
                                    "probs": [0.5, 0.3, 0.2]},
                        max_new={"range": [2, 5]})
    # in f32 the program's tokens are the reference's best (a gap of 0 on
    # sound runs); the tiny model's logits spread less than the cell's
    cell.workload = dict(cell.workload, max_batch=4, trace_calls=[2, 8],
                         check_requests=24, checks={"logit_gap": 0.05})
    return cell


def run(cell, seconds: float, seed: int = 2 ** 31 + 7, trace: bool = False,
        control: bool = False) -> dict:
    return cell.driver.run(cell, seed=seed, seconds=seconds, trace=trace,
                           device="cpu", t_start=time.perf_counter(),
                           control=control)
