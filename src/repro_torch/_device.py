"""Device resolution shared by every entry point that creates tensors."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for (the
    default) and absent.  Nothing moves to the CPU quietly: a caller that
    wants the CPU says ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "explicitly to run the plain PyTorch versions on the CPU")
    return dev
