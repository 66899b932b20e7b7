"""Hand-written CUDA kernels for CoCoI's compute hot-spots on Hopper.

The paper's type-1 bottleneck is the 2D conv subtask; its master-side
hot-spot is the MDS encode/decode GEMM.  Each kernel: csrc/<name>.cu
(CUDA C++ for sm_90a, built at first use by _build.py), wrapped with its
plain PyTorch version in <name>.py, exposed in ops.py, oracled in ref.py.
"""
from .ops import conv2d_subtask, mds_decode, mds_encode

__all__ = ["conv2d_subtask", "mds_decode", "mds_encode"]
