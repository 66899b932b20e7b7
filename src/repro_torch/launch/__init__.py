"""Command-line entry points (``python -m repro_torch.launch.serve``,
``.train``, ``.dryrun``), the meshes (the production ``DeviceMesh`` and the
one-card piece lanes of the coded dispatch backend) and the partitioning
rules.  ``launch.steps`` holds the step functions and the dry-run's
stand-ins, ``launch.hlo_analysis`` the roofline."""
from .mesh import (MODEL_AXIS, PIECE_LANES, LocalMesh, PiecePlacementError,
                   axis_sizes, dp_axes, make_local_mesh, make_production_mesh,
                   validate_pieces)
from .sharding import (Spec, batch_spec, cache_shardings, cache_specs,
                       decode_block_spec, input_sharding, input_spec,
                       param_shardings, param_specs, piece_sharding,
                       piece_spec, sanitize, to_placements)

__all__ = ["MODEL_AXIS", "PIECE_LANES", "LocalMesh", "PiecePlacementError",
           "axis_sizes", "dp_axes", "make_local_mesh", "make_production_mesh",
           "validate_pieces", "Spec", "batch_spec", "cache_shardings",
           "cache_specs", "decode_block_spec", "input_sharding", "input_spec",
           "param_shardings", "param_specs", "piece_sharding", "piece_spec",
           "sanitize", "to_placements"]
