"""The piece lanes of one card, and the typed front door for placing coded
pieces on them (the port of ``repro.launch.mesh``, one-card part).

The reference's coded path (``dist/mesh_exec.py``) treats the ``model`` axis
of a JAX device mesh as the worker fleet: one coded piece per axis slice.
One card has no device mesh.  Its counterpart of an axis slice is a *piece
lane*: one piece's block of rows in a stacked launch
(``kernels.skinny_gemm.piece_gemm_stacked``, ``kernels.conv2d.conv2d_stacked``).
:class:`LocalMesh` names the lanes with the reference's axis vocabulary, so
``validate_pieces`` keeps its contract: callers get a
``PiecePlacementError`` naming n and the axis extent instead of a shape
failure inside a launch.

Not ported here: ``make_production_mesh`` and ``dp_axes``, which shard a
model across chips (ROADMAP.md, Queue A).
"""
from __future__ import annotations

import dataclasses

__all__ = ["LocalMesh", "make_local_mesh", "validate_pieces", "MODEL_AXIS",
           "PIECE_LANES", "PiecePlacementError"]

MODEL_AXIS = "model"
# piece lanes of a default mesh: holds every coded n this repository serves
# (chip_smoke.py and the serving configs use n = 10)
PIECE_LANES = 16


class PiecePlacementError(ValueError):
    """Coded pieces cannot be placed on the mesh (n > axis extent, bad
    axis name, or an invalid requested axis split)."""


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """The (data, model) axes of one card: ``data`` is 1, ``model`` the
    number of piece lanes.  ``shape`` maps axis name to extent, as a JAX
    mesh's does.  On one card :data:`MODEL_AXIS` is the only axis that
    places more than one piece; ``data`` stays for the reference's axis
    vocabulary."""

    model: int

    @property
    def axis_names(self) -> tuple:
        return ("data", MODEL_AXIS)

    @property
    def shape(self) -> dict:
        return {"data": 1, MODEL_AXIS: self.model}


def make_local_mesh(*, model: int | None = None) -> LocalMesh:
    """The one-card mesh: ``model`` piece lanes (default
    :data:`PIECE_LANES`)."""
    if model is None:
        model = PIECE_LANES
    if int(model) < 1:
        raise PiecePlacementError(
            f"make_local_mesh: need 1 <= model piece lanes, got model={model}")
    return LocalMesh(int(model))


def validate_pieces(mesh: LocalMesh, n: int, axis: str = MODEL_AXIS) -> int:
    """Check n coded pieces fit the mesh's worker axis; return its extent."""
    if axis not in mesh.shape:
        raise PiecePlacementError(
            f"mesh has no {axis!r} axis (axes: {tuple(mesh.axis_names)})")
    extent = int(mesh.shape[axis])
    if not 1 <= n <= extent:
        raise PiecePlacementError(
            f"cannot place {n} coded pieces on the {axis!r} axis: extent "
            f"is {extent} (one piece per lane; shrink n or build the mesh "
            f"with a larger {axis!r} extent)")
    return extent
