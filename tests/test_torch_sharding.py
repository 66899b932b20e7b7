"""The port's partitioning rules (``repro_torch.launch.sharding``) against
the reference's (``repro.launch.sharding``), entry for entry.

The reference builds ``PartitionSpec``s on a ``jax.sharding.AbstractMesh``
from ``jax.eval_shape`` of its init; the port builds its ``Spec``s from a
``{axis: extent}`` mapping and its ``meta``-device init (shapes only).
The reference stacks a uniform decoder's layers with a leading layer dim,
for which its rules prepend a ``None``; the port keeps per-layer lists,
so its spec of layer i's leaf is the reference's stacked spec without
that ``None``.  Everything is exact equality.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, INPUT_SHAPES
from repro.configs import for_shape as j_for_shape
from repro.configs import get_config as j_get_config
from repro.launch import sharding as jsh
from repro.models import model as jm
from repro_torch.configs import for_shape, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import model as tm

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _abstract(shape, axes):
    try:
        return jax.sharding.AbstractMesh(shape, axes)
    except TypeError:  # jax < 0.5 takes (name, size) pairs
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))


def _meshes(name):
    shape, axes = MESHES[name]
    return _abstract(shape, axes), dict(zip(axes, shape))


def _key(p) -> object:
    return p.key if hasattr(p, "key") else p.idx


def _ref_specs(specs) -> dict:
    """{path: spec entries} of a reference spec tree (paths as the port's:
    dict keys and list indices)."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(_key(p) for p in path): tuple(s) for path, s in flat}


def _port_specs(specs) -> dict:
    out = {}
    tsh.map_with_path(lambda path, s: out.__setitem__(path, tuple(s)), specs)
    return out


def _expected(ref: dict, path: tuple, stacked: bool) -> tuple:
    """The reference's spec for the port's leaf at ``path``."""
    if stacked and path[0] == "layers":
        return ref[("layers",) + path[2:]][1:]
    return ref[path]


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    cfg = j_get_config(arch)
    return jax.eval_shape(lambda k: jm.init_params(cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


@functools.lru_cache(maxsize=None)
def _port_param_shapes(arch):
    return tm.init_params(get_config(arch), torch.Generator(), device="meta")


def _leaves(tree) -> dict:
    out = {}
    tsh.map_with_path(lambda path, t: out.__setitem__(path, t), tree)
    return out


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    jmesh, tmesh_ = _meshes(mesh_name)
    for fsdp in (True, False):
        ref = _ref_specs(jsh.param_specs(_ref_param_shapes(arch), jmesh,
                                               fsdp=fsdp))
        port = _port_specs(tsh.param_specs(_port_param_shapes(arch), tmesh_,
                                           fsdp=fsdp))
        stacked = j_get_config(arch).stacked
        assert len(port) == sum(
            get_config(arch).n_layers if stacked and p[0] == "layers" else 1
            for p in ref)
        for path, spec in port.items():
            assert spec == _expected(ref, path, stacked), (path, fsdp)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, shape_name, mesh_name):
    jmesh, tmesh_ = _meshes(mesh_name)
    shape = INPUT_SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    jcfg = j_for_shape(j_get_config(arch), shape)
    jshapes = jax.eval_shape(lambda: jm.init_cache(jcfg, B, S))
    ref = _ref_specs(jax.tree.map(
        lambda s: s.spec, jsh.cache_shardings(jshapes, jmesh, B),
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)))
    cache = tm.init_cache(for_shape(get_config(arch), shape), B, S,
                          device="meta")
    port = _port_specs(tsh.cache_specs(cache, tmesh_, B))
    leaves = _leaves(cache)
    for path, spec in port.items():
        assert spec == _expected(ref, path, jcfg.stacked), path
        tsh.local_shape(leaves[path].shape, spec, tmesh_)  # divides


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divide(arch, mesh_name):
    """The reference's check on the port's own shapes: every spec entry
    tiles its dim evenly."""
    _, sizes = _meshes(mesh_name)
    params = _port_param_shapes(arch)
    specs = _port_specs(tsh.param_specs(params, sizes))
    for path, leaf in _leaves(params).items():
        local = tsh.local_shape(leaf.shape, specs[path], sizes)
        assert all(d >= 1 for d in local), (path, leaf.shape)


def test_model_axis_used_for_big_params():
    """Tensor parallelism engages: every >= 1M-element param of qwen3-32b
    is sharded over the model axis somewhere (the reference's check)."""
    params = _port_param_shapes("qwen3-32b")
    specs = _port_specs(tsh.param_specs(params, {"data": 16, "model": 16}))
    for path, leaf in _leaves(params).items():
        if leaf.numel() >= 1_000_000:
            assert "model" in tsh.Spec(*specs[path]).axes(), path


@pytest.mark.parametrize("mesh_name", MESHES)
def test_small_rules_equal_the_reference(mesh_name):
    jmesh, sizes = _meshes(mesh_name)
    for nd in range(1, 5):
        assert tuple(tsh.piece_spec(nd)) == tuple(jsh.piece_spec(nd))
        assert tuple(tsh.piece_spec(nd, "data")) == \
            tuple(jsh.piece_spec(nd, "data"))
    for nd in range(2, 5):
        assert tuple(tsh.decode_block_spec(nd)) == \
            tuple(jsh.decode_block_spec(nd))
    with pytest.raises(ValueError):
        tsh.piece_spec(0)
    with pytest.raises(ValueError):
        tsh.decode_block_spec(1)
    axes = tuple(sizes)
    entries = [None, "model", "data", axes[:-1], axes[:-1] + ("model",)]
    rng = np.random.default_rng(7)
    for _ in range(200):
        nd = int(rng.integers(1, 4))
        spec = [entries[int(i)] for i in rng.integers(0, len(entries), nd)]
        shape = tuple(int(d) for d in rng.choice(
            [1, 2, 3, 8, 16, 32, 48, 256, 512, 1000], nd))
        want = tuple(jsh.sanitize(jax.sharding.PartitionSpec(*spec), shape,
                                  jmesh))
        assert tuple(tsh.sanitize(tsh.Spec(*spec), shape, sizes)) == want, \
            (spec, shape)
    for batch in (1, 2, 8, 16, 32, 100, 128, 256, 512, 1024):
        assert tsh.batch_spec(sizes, batch) == jsh.batch_spec(jmesh, batch)
        for nd in (2, 3):
            want = tuple(jsh.input_sharding(jmesh, batch, nd).spec)
            assert tuple(tsh.input_spec(sizes, batch, nd)) == want
            assert tsh.input_sharding(sizes, batch, nd) == \
                tsh.to_placements(tsh.input_spec(sizes, batch, nd), sizes)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    pod = {"pod": 2, "data": 16, "model": 16}
    assert tsh.to_placements(tsh.Spec(("pod", "data"), "model"), pod) == \
        (Shard(0), Shard(0), Shard(1))
    assert tsh.to_placements(tsh.Spec(None, ("data", "model")), pod) == \
        (Replicate(), Shard(1), Shard(1))
    assert tsh.to_placements(tsh.Spec(), pod) == (Replicate(),) * 3
    assert tsh.to_placements(tsh.Spec("model", None), tmesh.LocalMesh(4)) \
        == (Replicate(), Shard(0))
    # an axis of extent 1 replicates
    assert tsh.to_placements(tsh.Spec("data", "model"),
                             {"data": 1, "model": 1}) == (Replicate(),) * 2
    with pytest.raises(ValueError, match="out of mesh order"):
        tsh.to_placements(tsh.Spec(("data", "pod")), pod)
    with pytest.raises(ValueError, match="not an axis"):
        tsh.to_placements(tsh.Spec("workers"), pod)
    with pytest.raises(ValueError, match="twice"):
        tsh.to_placements(tsh.Spec("data", "data"), pod)
    assert tsh.piece_sharding(pod, 3) == (Replicate(), Replicate(), Shard(0))
    assert tsh.local_shape((64, 48, 7), tsh.Spec(("pod", "data"), "model"),
                           pod) == (2, 3, 7)
    with pytest.raises(ValueError, match="does not divide"):
        tsh.local_shape((24,), tsh.Spec("model"), pod)


def test_axis_helpers_take_every_kind_of_mesh():
    local = tmesh.make_local_mesh(model=10)
    assert tmesh.axis_sizes(local) == {"data": 1, "model": 10}
    assert tmesh.dp_axes(local) == ("data",)
    pod = {"pod": 2, "data": 16, "model": 16}
    assert tmesh.dp_axes(pod) == ("pod", "data")
    assert tmesh.validate_pieces(pod, 10) == 16
    with pytest.raises(tmesh.PiecePlacementError, match="extent"):
        tmesh.validate_pieces(pod, 17)
    with pytest.raises(tmesh.PiecePlacementError, match="no 'x' axis"):
        tmesh.validate_pieces(local, 2, axis="x")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_world(multi_pod):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = MESHES["2x16x16" if multi_pod else "16x16"]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod,
                                          device_type="cpu")
        assert mesh.mesh_dim_names == axes
        assert tuple(mesh.shape) == shape
        assert tmesh.axis_sizes(mesh) == dict(zip(axes, shape))
        assert tmesh.dp_axes(mesh) == axes[:-1]
        assert tmesh.validate_pieces(mesh, 16) == 16
        specs = tsh.param_specs(_port_param_shapes("gemma-2b"), mesh)
        assert tsh.param_shardings(_port_param_shapes("gemma-2b"), mesh) == \
            tsh.map_with_path(lambda _, sp: tsh.to_placements(sp, mesh), specs)
    finally:
        dist.destroy_process_group()
