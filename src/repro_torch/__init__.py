"""CoCoI — coded distributed inference — in PyTorch and CUDA for Hopper.

The port of ``src/repro`` (JAX, the reference) grows here slice by slice.
It imports ``torch`` and never ``jax`` or ``repro``.  Sub-packages mirror
the reference's layout and names:

    kernels   — hand-written CUDA kernels (skinny GEMM, direct conv, the
                Mamba2 SSD chunk), each with its plain PyTorch version and a
                launch counter
    core      — codes and schemes, splitting, coded conv / GEMM pipelines,
                latency model, planner, network plan compiler
    dist      — threaded worker pool, virtual clock, fault plans, the
                decode-at-k-th-arrival ``CodedExecutor``
    models    — the paper's CNN workloads (small CNN, VGG16, ResNet18) and
                the Mamba2 / Zamba2 decoders
    serving   — the batched serving ``Engine``
    telemetry — span traces of the pool and the executor
    convert   — parameters between the reference and the port

Entry points that create tensors take ``device=`` (default ``"cuda"``)
and raise when CUDA is absent; kernel wrappers launch their CUDA kernel
for a CUDA tensor and compute the plain version only for a CPU tensor.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
