"""The port's autoscaler (``dist/autoscale.py``, a copy of the reference's
over the port's ``WorkerPool``).

Mirrors tests/test_elastic.py::TestAutoscaler, pins the decisions of one
scripted queue-depth series on an elastic ten-worker executor (the series
``chip_smoke.py``'s ``adaptive`` phase replays on the card, with a coded
GEMM after every step), and holds the port's decisions to the reference's
on the same series and speeds.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_max_err, coded_tol, plain
from repro import dist as jdist
from repro_torch import dist as tdist
from repro_torch.core import coded_matmul
from repro_torch.core.schemes import get_scheme
from repro_torch.dist import (Autoscaler, CodedExecutor, CostModel,
                              DeterministicDelay, FakeClock, WorkerPool)

PIECE = 1.0


class TestAutoscaler:
    def _pool(self, n=2):
        return WorkerPool(n, clock=FakeClock(),
                          delay_model=DeterministicDelay(PIECE))

    def test_validation(self):
        with self._pool() as pool:
            with pytest.raises(ValueError, match="min_workers"):
                Autoscaler(pool, min_workers=4, max_workers=2)
            with pytest.raises(ValueError, match="alpha"):
                Autoscaler(pool, alpha=0.0)
        with pytest.raises(ValueError, match="positive"):
            CostModel(worker_cost=0.0)

    def test_scales_up_on_backlog(self):
        with self._pool(2) as pool:
            auto = Autoscaler(pool, target_queue=1.0, max_workers=8)
            dec = auto.step(6, t=0.0)
        assert dec.joined == (2, 3) and dec.drained == ()
        assert dec.n_alive == 4 and dec.reason.startswith("backlog")
        assert auto.decisions == [dec]

    def test_cooldown_separates_actions(self):
        with self._pool(2) as pool:
            auto = Autoscaler(pool, target_queue=1.0, cooldown_steps=2)
            assert auto.step(6, t=0.0).joined != ()
            held = auto.step(8, t=1.0)
            assert held.joined == () and held.reason == "hold"

    def test_cost_model_gates_scale_up(self):
        with self._pool(2) as pool:
            auto = Autoscaler(pool, target_queue=1.0,
                              cost=CostModel(worker_cost=100.0,
                                             queue_cost=0.1))
            assert auto.step(6, t=0.0).joined == ()

    def test_drains_slowest_when_idle(self):
        speeds = {0: 1.0, 1: 0.2, 2: 1.0}
        with self._pool(3) as pool:
            auto = Autoscaler(pool, min_workers=1, cooldown_steps=0,
                              speeds_fn=lambda n: [speeds[w]
                                                   for w in range(n)])
            dec = auto.step(0, t=0.0)
            assert dec.drained == (1,)
            assert pool.worker_status(1) == "draining"

    def test_drains_highest_id_without_speeds_and_respects_min(self):
        with self._pool(2) as pool:
            auto = Autoscaler(pool, min_workers=1, cooldown_steps=0)
            assert auto.step(0, t=0.0).drained == (1,)
            assert auto.step(0, t=1.0).drained == ()

    def test_recommend_redundancy(self):
        with self._pool() as pool:
            auto = Autoscaler(pool)
            assert auto.recommend_redundancy([]) == 1
            assert auto.recommend_redundancy([1.0, 1.0]) == 1
            assert auto.recommend_redundancy([1.0, 1.0, 1.0, 0.2]) == 2


# the scripted series of chip_smoke.py's autoscaler part, and the decisions
# it must give: (t, joined, drained, n_alive)
SERIES = (0, 8, 16, 16, 4, 0, 0, 0, 0, 0)
PINNED = [(0.0, (), (9,), 9), (1.0, (), (), 9), (2.0, (), (), 9),
          (3.0, (10, 11, 12), (), 12), (4.0, (), (), 12), (5.0, (), (), 12),
          (6.0, (), (), 12), (7.0, (), (), 12), (8.0, (), (), 12),
          (9.0, (), (12,), 11)]


def test_pinned_series_with_a_coded_gemm_after_each_step():
    """An elastic executor's n follows the fleet the autoscaler sizes: the
    decode-step GEMM after each step runs on every live member, with the
    MDS k its ``plan_matmul`` asks for (clamped to the step's tokens),
    and decodes to the product."""
    rng = np.random.default_rng(0)
    T, d_in, d_out = 8, 32, 48
    x = torch.from_numpy(rng.standard_normal((T, d_in)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((d_in, d_out))
                         .astype(np.float32)) * d_in ** -0.5
    want = (x.double() @ w.double()).numpy()
    base = get_scheme("mds").make(10, 6)
    ex = CodedExecutor(10, clock=FakeClock(),
                       delay_model=DeterministicDelay(PIECE), elastic=True)
    got = []
    try:
        auto = Autoscaler(ex.pool, min_workers=6, max_workers=12)
        for i, q in enumerate(SERIES):
            dec = auto.step(q, float(i))
            got.append((dec.t, dec.joined, dec.drained, dec.n_alive))
            n_new, k_new, _ = ex.plan_matmul(base, "mds", T, d_in, d_out)
            n = n_new if n_new is not None else base.n
            k = min(k_new if k_new is not None else base.k, T)
            code = get_scheme("mds").make(n, k)
            y = coded_matmul(x, w, code, executor=ex)
            rep = ex.last_report
            assert n == dec.n_alive
            assert sorted(set(rep.assignment.values())) == \
                ex.pool.dispatch_preview()
            assert_max_err(y, want, coded_tol(code, rep.subset, d_in, want),
                           f"step {i}, (n, k) = ({n}, {k})")
    finally:
        ex.close()
    assert got == PINNED


def _decisions(dist, speeds_fn):
    out = []
    with dist.CodedExecutor(10, clock=dist.FakeClock(),
                            delay_model=dist.DeterministicDelay(PIECE),
                            elastic=True) as ex:
        auto = dist.Autoscaler(ex.pool, min_workers=3, max_workers=14,
                               target_queue=1.5, alpha=0.4,
                               cooldown_steps=1, speeds_fn=speeds_fn,
                               cost=dist.CostModel(1.0, 3.0))
        depths = (0, 0, 5, 12, 30, 30, 2, 0, 0, 0, 9, 0, 0, 0, 0, 0)
        for i, q in enumerate(depths):
            out.append(plain(auto.step(q, 0.5 * i)))
            out.append(ex.pool.dispatch_preview())
        out.append(auto.q_hat)
    return out


@pytest.mark.parametrize("slow", [None, 3, 7])
def test_decisions_equal_the_reference(slow):
    if slow is None:
        speeds_fn = None
    else:
        def speeds_fn(n):
            return [0.2 if w == slow else 1.0 + 0.01 * w for w in range(n)]
    assert _decisions(tdist, speeds_fn) == \
        _decisions(jdist, speeds_fn)


@pytest.mark.parametrize("speeds", [[], [1.0], [1.0, 1.0, 0.2],
                                    [1.0, 0.4, 0.45, 0.2, 2.0],
                                    [0.1] * 6 + [1.0] * 3])
def test_recommend_redundancy_equal(speeds):
    with WorkerPool(2, clock=FakeClock()) as tp, \
            jdist.WorkerPool(2, clock=jdist.FakeClock()) as jp:
        assert Autoscaler(tp).recommend_redundancy(speeds) == \
            jdist.Autoscaler(jp).recommend_redundancy(speeds)
