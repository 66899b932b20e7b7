"""Command-line entry points (``python -m repro_torch.launch.serve``) and
the one-card piece-lane mesh of the coded dispatch backend."""
from .mesh import (MODEL_AXIS, PIECE_LANES, LocalMesh, PiecePlacementError,
                   make_local_mesh, validate_pieces)

__all__ = ["MODEL_AXIS", "PIECE_LANES", "LocalMesh", "PiecePlacementError",
           "make_local_mesh", "validate_pieces"]
