"""``models.attention.decode_attention``, which gathers a cache's sharded
KV-head dim and the query's head dim at its entry, so that the dry-run's
DTensors never reach its einsums with a sharded KV-head dim (torch 2.11
refuses to flatten it).

* On plain tensors it is bit for bit the einsum form it had before (kept
  verbatim below as ``_einsum_form``): f32 and bf16, a scalar and a
  per-lane position, grouped-query (K = 2 of H = 4) and multi-query
  (K = 1) caches.
* The same calls agree with the reference's ``decode_attention`` within
  1e-5 of the largest output in f32 (the existing parity tolerance) and
  2^-7 in bf16 (one bf16 rounding of the output).
* On a fake (2, 2) mesh, under the dry-run's implicit replication, a cache
  sharded over ``model`` on its KV-head dim goes through and gives an
  output sharded on the batch only; with an MQA cache the query keeps its
  head sharding.  (The first case fails on torch 2.11 without the gather;
  this machine's torch has the rule, so the card's dry-run phase is the
  check.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np, to_j, to_t
from repro.models import attention as jattn
from repro_torch.models import attention as tattn

NEG_INF = -1e30


def _einsum_form(q, k_cache, v_cache, pos):
    """decode_attention as it was written before its operands were
    settled."""
    B, S, K, P = k_cache.shape
    H = q.shape[2]
    G = H // K
    scale = P ** -0.5
    qr = q.reshape(B, 1, K, G, P)
    s = torch.einsum("bqkgp,bskp->bkgqs", qr.float(), k_cache.float()) * scale
    pos = torch.as_tensor(pos, device=q.device)
    slots = torch.arange(S, device=q.device)
    if pos.dim():
        valid = (slots[None] <= pos[:, None]) | (pos[:, None] >= S)
        valid = valid[:, None, None, None, :]
    else:
        valid = ((slots <= pos) | (pos >= S))[None, None, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskp->bqkgp", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, P).to(q.dtype)


DTYPES = ["float32", "bfloat16"]
POS = ["scalar", "lanes"]
KV = {"gqa": 2, "mqa": 1}


def _inputs(dtype, pos, kv, seed=5):
    rng = np.random.default_rng(seed)
    K = KV[kv]
    q = rng.normal(size=(3, 1, 4, 8)).astype(np.float32)
    kc = rng.normal(size=(3, 12, K, 8)).astype(np.float32)
    vc = rng.normal(size=(3, 12, K, 8)).astype(np.float32)
    p = (np.asarray([2, 11, 30], np.int32) if pos == "lanes"
         else np.int32(7))
    return q, kc, vc, p


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("pos", POS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_is_bit_for_bit_the_einsum_form(dtype, pos, kv):
    q, kc, vc, p = _inputs(dtype, pos, kv)
    args = (to_t(q, dtype), to_t(kc, dtype), to_t(vc, dtype),
            torch.as_tensor(p))
    got = tattn.decode_attention(*args)
    want = _einsum_form(*args)
    assert got.dtype == want.dtype == args[0].dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("pos", POS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_matches_the_reference(dtype, pos, kv):
    q, kc, vc, p = _inputs(dtype, pos, kv, seed=6)
    got = tattn.decode_attention(to_t(q, dtype), to_t(kc, dtype),
                                 to_t(vc, dtype), torch.as_tensor(p))
    want = jattn.decode_attention(to_j(q, dtype), to_j(kc, dtype),
                                  to_j(vc, dtype), jnp.asarray(p))
    got, want = as_np(got), as_np(want)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# K, whether the cache's KV-head dim is sharded: with it the head dims of
# the cache and q are gathered; an MQA cache is not, and q keeps its head
# sharding
@pytest.mark.parametrize("K,sharded", [(4, True), (1, False)])
def test_decode_attention_takes_a_cache_sharded_over_model(K, sharded):
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        B, S, H, P = 4, 16, 8, 8
        kv = [Shard(0), Shard(2) if sharded else Replicate()]

        def dt(local, shape, placements):
            stride = torch.empty(shape).stride()
            return DTensor.from_local(local, mesh, placements,
                                      run_check=False,
                                      shape=torch.Size(shape), stride=stride)

        # as the dry-run runs its steps: plain masks replicate implicitly
        with FakeTensorMode(), implicit_replication():
            q = dt(torch.empty(B // 2, 1, H // 2, P), (B, 1, H, P),
                   [Shard(0), Shard(2)])
            kl = K // 2 if sharded else K
            kc = dt(torch.empty(B // 2, S, kl, P), (B, S, K, P), kv)
            vc = dt(torch.empty(B // 2, S, kl, P), (B, S, K, P), kv)
            out = tattn.decode_attention(q, kc, vc, 5)
        assert tuple(out.shape) == (B, 1, H, P)
        assert tuple(out.placements) == (
            Shard(0), Replicate() if sharded else Shard(2))
    finally:
        dist.destroy_process_group()
