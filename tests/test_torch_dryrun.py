"""The port's dry-run (``repro_torch.launch.dryrun``, ``hlo_analysis``,
``steps``' stand-ins) against the reference's, on the CPU.

* ``model_flops_global`` equals the reference's exactly for all ten archs
  x four shapes (a count of parameters).
* ``_memory_floor_bytes`` equals the reference's for the same specs: the
  port's from DTensor stand-ins on a fake 256-rank world, the reference's
  from ``ShapeDtypeStruct``s on an ``AbstractMesh``.
* ``Roofline`` arithmetic and its ``row()`` keys; ``collective_bytes`` and
  ``LocalOpCounter`` on a small DTensor program whose bytes and FLOPs are
  known by hand.
* ``run_one`` completes for a dense, a hybrid and an MoE smoke config on a
  (2, 2) fake mesh at small shapes, ``useful_ratio`` in (0, 1].
* ``step_and_specs``' stand-ins hold no storage (fake local shards) and
  carry the rules' placements; the ``meta`` init (the shape-only path)
  equals the fake-tensor init.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to ask for 512 host
devices; jax's backend is made first and the variable restored, so
nothing else in this process changes.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, INPUT_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import hlo_analysis as jhlo
from repro.launch import steps as jsteps
from repro_torch.configs import InputShape, get_config, smoke_config
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import hlo_analysis as thlo
from repro_torch.launch import sharding as tsh
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tm

jax.devices()  # the backend exists before the reference's dry-run is imported
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdr  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

COMBOS = [(a, s) for a in ARCHS for s in INPUT_SHAPES]


@pytest.fixture
def fake_world():
    """A default process group of the given size on the fake backend."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    try:
        yield make
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_model_flops_global_equals_the_reference(arch, shape):
    s = INPUT_SHAPES[shape]
    assert tdr.model_flops_global(get_config(arch), s) == \
        jdr.model_flops_global(j_get_config(arch), s)


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_memory_floor_equals_the_reference(arch, shape, fake_world):
    from repro_torch.launch.mesh import make_production_mesh

    s = INPUT_SHAPES[shape]
    jmesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    _, jargs = jsteps.step_and_specs(j_get_config(arch), s, jmesh)
    fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    _, targs = tsteps.step_and_specs(get_config(arch), s, mesh)
    assert tdr._memory_floor_bytes(targs, s) == \
        jdr._memory_floor_bytes(jargs, s)


def test_roofline_arithmetic():
    rf = thlo.roofline_from({"flops": 989e12, "bytes accessed": 6.7e12},
                            {"all-gather": 450e9, "all-reduce": 450e9},
                            chips=4, model_flops=2 * 989e12,
                            per_device_mem=2 ** 31)
    assert rf.t_compute == pytest.approx(1.0)
    assert rf.t_memory == pytest.approx(2.0)
    assert rf.t_collective == pytest.approx(2.0)
    assert rf.bottleneck == "memory"
    assert rf.useful_ratio == pytest.approx(0.5)
    row = rf.row()
    assert row["per_device_mem_gb"] == pytest.approx(2.0)
    ref = jhlo.roofline_from({"flops": 1.0, "bytes accessed": 1.0}, {}, 1,
                             1.0, 1.0)
    assert set(row) == set(ref.row())
    assert [f.name for f in dataclasses.fields(thlo.Roofline)] == \
        [f.name for f in dataclasses.fields(jhlo.Roofline)]
    assert thlo.roofline_from({}, {}, 1, 1.0, 0.0).useful_ratio == 0.0
    assert (thlo.HW.peak_flops, thlo.HW.hbm_bw, thlo.HW.link_bw) == \
        (989e12, 3.35e12, 450e9)


def test_collective_bytes_and_local_counts(fake_world):
    """(8, 16) f32 on a (data=2, model=2) mesh: gathering a batch-sharded
    tensor moves one all-gather of 8 x 16 x 4 bytes; a product over a
    model-sharded contraction leaves a partial sum whose reduction is an
    all-reduce of the local (4, 6) f32 result."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(4, 16), mesh, [Shard(0),
                                                          Replicate()],
                               run_check=False, shape=torch.Size((8, 16)),
                               stride=(16, 1))
        x = DTensor.from_local(torch.empty(4, 8), mesh, [Shard(0), Shard(1)],
                               run_check=False, shape=torch.Size((8, 16)),
                               stride=(16, 1))
        w = DTensor.from_local(torch.empty(8, 6), mesh, [Replicate(),
                                                         Shard(0)],
                               run_check=False, shape=torch.Size((16, 6)),
                               stride=(6, 1))
        with thlo.LocalOpCounter() as c:
            a.redistribute(placements=[Replicate(), Replicate()])
            y = (x @ w).redistribute(placements=[Shard(0), Replicate()])
    assert tuple(y.to_local().shape) == (4, 6)
    colls = thlo.collective_bytes(c.collectives)
    assert colls == {"all-gather": 8 * 16 * 4, "all-reduce": 4 * 6 * 4,
                     "reduce-scatter": 0, "all-to-all": 0,
                     "collective-permute": 0}
    # rank 0's local product: (4, 8) @ (8, 6)
    assert c.flops == 2 * 4 * 8 * 6
    assert c.bytes >= (4 * 8 + 8 * 6 + 4 * 6) * 4
    with pytest.raises(ValueError, match="none of the kinds"):
        thlo.LocalOpCounter.kind_of("broadcast")


SMALL = {"train": InputShape("train_small", 64, 8, "train"),
         "decode": InputShape("decode_small", 128, 8, "decode")}


@pytest.mark.parametrize("kind", SMALL)
@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-1.2b", "dbrx-132b"])
def test_run_one_on_a_small_fake_mesh(arch, kind):
    rec = tdr.run_one(arch, SMALL[kind], cfg_override=smoke_config(arch),
                      mesh_shape=(2, 2), verbose=False)
    assert rec["mesh"] == "2x2" and rec["chips"] == 4
    assert 0.0 < rec["useful_ratio"] <= 1.0
    assert rec["hlo_flops"] > 0 and rec["hbm_bytes"] > 0
    assert rec["per_device_mem_gb"] > 0
    assert set(rec["collectives"]) == {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute"}
    assert rec["bottleneck"] in ("compute", "memory", "collective")


def test_main_counts_a_failure(monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("no sharding rule")

    monkeypatch.setattr(tdr, "run_one", boom)
    assert tdr.main(["--arch", "gemma-2b", "--shape", "decode_32k"]) == 1
    assert "FAIL gemma-2b x decode_32k" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-1.2b", "dbrx-132b",
                                  "musicgen-medium"])
def test_stand_ins_hold_no_storage_and_carry_the_rules(arch, fake_world):
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.device_mesh import init_device_mesh

    fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = smoke_config(arch)
    shape = InputShape("train_small", 64, 8, "train")
    step_fn, (params, opt, batch, step) = tsteps.step_and_specs(cfg, shape,
                                                                mesh)
    meta = tm.init_params(cfg, torch.Generator(), device="meta")
    want = tsh.param_shardings(meta, mesh)
    got = tsh.map_with_path(lambda _, t: tuple(t.placements), params)
    assert got == want
    assert tsh.map_with_path(lambda _, t: tuple(t.placements), opt.mu) == want
    leaves = []
    tsh.map_with_path(lambda _, t: leaves.append(t),
                      (params, opt.mu, opt.nu, batch))
    for t in leaves + [step, opt.step]:
        assert isinstance(t.to_local(), FakeTensor)
    assert tsh.map_with_path(lambda _, t: (tuple(t.shape), t.dtype),
                             params) == \
        tsh.map_with_path(lambda _, t: (tuple(t.shape), t.dtype), meta)
    key = "embeds" if cfg.frontend != "none" else "tokens"
    assert set(batch) == {key, "labels"}
    assert tuple(batch[key].shape[:2]) == (8, 64)
    assert batch["labels"].dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_equals_the_fake_init(arch):
    """The shape-only path (``init_params`` on ``meta``, nothing drawn)
    gives the fake-tensor init's tree, shapes and dtypes; a real init is
    unchanged by it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = smoke_config(arch)
    meta = tm.init_params(cfg, torch.Generator(), device="meta")
    with FakeTensorMode():
        fake = tm.init_params(cfg, torch.Generator(), device="cpu")
    desc = lambda tree: tsh.map_with_path(
        lambda _, t: (tuple(t.shape), t.dtype), tree)
    assert desc(meta) == desc(fake)
    gen = torch.Generator().manual_seed(3)
    a = tm.init_params(cfg, gen, device="cpu")
    b = tm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    flat_a, flat_b = [], []
    tsh.map_with_path(lambda _, t: flat_a.append(t), a)
    tsh.map_with_path(lambda _, t: flat_b.append(t), b)
    assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))
    assert np.isfinite(sum(float(x.float().abs().sum()) for x in flat_a))


def test_layout_helpers_leave_plain_tensors_alone():
    """The model reaches DTensors only through these helpers; a plain
    tensor (every real run) comes back as the same object, or as the
    indexing it always did."""
    from repro_torch.models import common

    t = torch.randn(4, 6)
    tree = {"w": t, "b": torch.zeros(6)}
    assert common.settle(t) is t
    assert common.settle_grad(t) is t
    assert common.unshard(t, 1) is t
    assert common.gather_fsdp(tree) is tree
    assert common.gather_fsdp(t) is t
    idx = torch.tensor([[3, 0], [1, 1]])
    assert torch.equal(common.lookup(t, idx), t[idx])
