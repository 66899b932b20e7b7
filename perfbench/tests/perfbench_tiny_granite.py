"""The Granite-4.0-H cell at a size a CPU test run can hold, loaded by name
like the cells of `perfbench_tiny`, with the widths and the traffic cut
down."""
from __future__ import annotations

import copy

from benchlib import spec


def granite_cell(name: str = "granite4h.prefill.mesh"):
    """Granite-4.0-H at a tiny width: 10 layers, attention at 5, 8
    experts of which 4 are held, top-2."""
    cell = spec.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(
        n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
        shared_d_ff=48, vocab=512, n_experts=8, experts_held=4, top_k=2,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16, dtype="float32",
        layer_types=["attn" if i == 5 else "mamba" for i in range(10)])
    cfg["dtype"] = "float32"
    cfg["embed_std"] = 1.0 / 64
    cell.config = cfg
    cell.traffic = dict(cell.traffic,
                        arrivals={"process": "poisson", "rate": 8.0},
                        requests_per_s=5.0,
                        prompt_len={"values": [16, 32, 64],
                                    "probs": [0.5, 0.3, 0.2]},
                        max_new={"range": [2, 5]})
    # in f32 the program's tokens are the reference's best (a gap of 0 on
    # sound runs, bar a near tie); a fault in the mixture opens gaps of
    # 0.013-0.031 at this size, its logits divided by 16
    cell.workload = dict(cell.workload, max_batch=4, trace_calls=[2, 8],
                         check_requests=24, checks={"logit_gap": 0.005})
    return cell
