"""Meshes: the production mesh of many cards, the piece lanes of one card,
and the typed front door for placing coded pieces on either (the port of
``repro.launch.mesh``).

:func:`make_production_mesh` builds the reference's production meshes as a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`:
``(data=16, model=16)``, 256 ranks, or ``(pod=2, data=16, model=16)``, 512.
It needs a default process group of that size, real or fake (the dry-run,
``launch/dryrun.py``, uses the fake backend); nothing here creates one, and
importing this module touches no device and no process group.

The coded path treats the ``model`` axis as the worker fleet: one coded
piece per axis slice (``core.coded_linear.coded_matmul_sharded``,
``core.coded_conv.coded_conv2d_sharded``).  One card has no device mesh.
Its counterpart of an axis slice is a *piece lane*: one piece's block of
rows in a stacked launch (``kernels.skinny_gemm.piece_gemm_stacked``,
``kernels.conv2d.conv2d_stacked``), which :class:`LocalMesh` names with the
reference's axis vocabulary for ``dist/mesh_exec.py::MeshExecutor``.

Every function here takes either kind of mesh, or a plain ``{axis:
extent}`` mapping in mesh order (:func:`axis_sizes`), so
``validate_pieces`` keeps its contract on both: callers get a
``PiecePlacementError`` naming n and the axis extent instead of a shape
failure inside a launch or a collective.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

__all__ = ["LocalMesh", "make_local_mesh", "make_production_mesh",
           "axis_sizes", "dp_axes", "validate_pieces", "MODEL_AXIS",
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


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod: (pod=2, data=16, model=16) = 512 ranks.

    A ``DeviceMesh`` over the default process group, which must already
    hold that many ranks (``torch.distributed.init_process_group``; the
    dry-run's is the fake backend)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_sizes(mesh) -> dict:
    """``{axis name: extent}`` in mesh order, for a ``DeviceMesh``, a
    :class:`LocalMesh` or such a mapping itself."""
    if isinstance(mesh, Mapping):
        return {str(a): int(e) for a, e in mesh.items()}
    if isinstance(mesh, LocalMesh):
        return dict(mesh.shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise PiecePlacementError(
            "a DeviceMesh needs mesh_dim_names to be addressed by axis")
    return dict(zip(names, (int(e) for e in mesh.shape)))


def validate_pieces(mesh, n: int, axis: str = MODEL_AXIS) -> int:
    """Check n coded pieces fit the mesh's worker axis; return its extent."""
    sizes = axis_sizes(mesh)
    if axis not in sizes:
        raise PiecePlacementError(
            f"mesh has no {axis!r} axis (axes: {tuple(sizes)})")
    extent = sizes[axis]
    if not 1 <= n <= extent:
        raise PiecePlacementError(
            f"cannot place {n} coded pieces on the {axis!r} axis: extent "
            f"is {extent} (one piece per lane or axis slice; shrink n or "
            f"build the mesh with a larger {axis!r} extent)")
    return extent


def dp_axes(mesh) -> tuple:
    """Every mesh axis except the model/worker axis — used for batch/seq."""
    return tuple(a for a in axis_sizes(mesh) if a != MODEL_AXIS)
