"""End-to-end CoCoI CNN inference with the PyTorch/CUDA port.

Compiles the small CNN into coded segments (core/netplan.py) under a few
schemes, runs it through the segment pipeline, and checks that the logits
match local inference while counting the master encode/decode boundary
operations the run actually performs (2 per segment, not 2 per layer).
The port's twin of part 1 of examples/coded_cnn_inference.py.

Run: PYTHONPATH=src python examples/torch_coded_cnn.py [--device cuda|cpu]

On ``cuda`` (the default) every convolution and every MDS encode/decode
runs a hand-written CUDA kernel, built at first use; on ``cpu`` their plain
PyTorch versions run instead.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import compile_plan
from repro_torch.core.coded_conv import boundary_op_counter
from repro_torch.kernels.conv2d import conv2d as conv_kernel
from repro_torch.kernels.skinny_gemm import skinny_gemm
from repro_torch.models import init_small_cnn, small_cnn_forward
from repro_torch.models.cnn import SMALL_CNN_PARAMS, small_cnn_layers


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises if absent) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    device = resolve_device(args.device)

    gen = torch.Generator().manual_seed(args.seed)
    params = init_small_cnn(gen, device=device)
    x = torch.randn((2, 3, 32, 32), generator=gen).to(device)
    logits_local = small_cnn_forward(params, x)

    layers = small_cnn_layers(32)
    for scheme in ("mds", "replication", "uncoded"):
        plan = compile_plan(layers, 6, SMALL_CNN_PARAMS, scheme)
        with boundary_op_counter() as ops:
            logits = small_cnn_forward(params, x, plan=plan)
        err = float((logits - logits_local).abs().max())
        same = bool((logits.argmax(-1) == logits_local.argmax(-1)).all())
        print(f"{scheme:12s}: {plan.n_segments} segments, "
              f"{ops['encode'] + ops['decode']} boundary ops, "
              f"max abs err {err:.2e}, classes identical: {same}")
    print(f"device {device}: {conv_kernel.launches} conv kernel launches, "
          f"{skinny_gemm.launches} skinny-GEMM kernel launches")


if __name__ == "__main__":
    main()
