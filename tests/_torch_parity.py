"""Helpers shared by the tests/test_torch_*.py parity tests.

Every parity test makes its inputs from a seed with numpy, hands the same
values to the JAX reference (``repro``, on the CPU) and to the PyTorch port
(``repro_torch``, ``device="cpu"``: the kernels' plain versions), and
compares the results through numpy with a stated tolerance.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)  # the suite runs several xdist workers

U32 = 2.0 ** -24   # f32 unit roundoff
U16 = 2.0 ** -8    # bf16 unit roundoff

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rounded(a: np.ndarray, dtype: str) -> np.ndarray:
    """``a`` as f32 numpy holding values exactly representable in
    ``dtype``, so that both frameworks start from identical numbers."""
    t = torch.from_numpy(np.array(a, dtype=np.float32)).to(TDT[dtype])
    return t.float().numpy()


def to_t(a, dtype: str = "float32") -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(TDT[dtype])


def to_j(a, dtype: str = "float32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JDT[dtype])


def as_np(x) -> np.ndarray:
    """A torch tensor or a jax array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_scaled_close(got, want, scale, coef: float, what: str = ""):
    """|got - want| <= coef * scale elementwise (scale >= 0, broadcastable):
    the tolerance follows the magnitude of the terms that were summed."""
    got, want = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    lim = coef * np.asarray(scale, np.float64) + 1e-30
    bad = np.abs(got - want) > lim
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} beyond tolerance; worst "
        f"err/tol = {float((np.abs(got - want) / lim).max()):.3g}")


def sum_coef(terms: int, dtype: str = "float32") -> float:
    """Two f32 summation orders of ``terms`` products differ by at most
    ~2 (terms + 2) u times the sum of magnitudes; a bf16 result adds one
    rounding on each side."""
    return 2.0 * (terms + 2) * U32 + (2 * U16 if dtype == "bfloat16" else 0.0)


def make_scheme(schemes_mod, name: str, n: int, k: int):
    """The (n, k) instance of a registered scheme from either package;
    replication and uncoded fix k structurally and take n only."""
    cls = schemes_mod.get_scheme(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if name in ("replication", "uncoded"):
            return cls.make(n)
        return cls.make(n, k)


def decode_amp(scheme, subset) -> float:
    """How much a decode from ``subset`` amplifies roundoff in the coded
    pieces relative to the sources: |D|_inf |G_S|_inf for linear mixes,
    1 for selection schemes (a gather)."""
    subset = [int(i) for i in subset]
    if hasattr(scheme, "decode_matrix"):      # MDS
        keep = list(dict.fromkeys(subset))[: scheme.k]
        D = scheme.decode_matrix(keep)
        G = scheme.generator[keep]
    elif hasattr(scheme, "rows"):             # LT
        G = scheme.rows[subset]
        D = np.linalg.pinv(G)
    else:
        return 1.0
    return float(np.abs(D).sum(1).max() * np.abs(G).sum(1).max())


def coded_tol(scheme, subset, R: int, ref_out) -> float:
    """Tolerance of a coded result against the uncoded one: the pieces carry
    the f32 roundoff of a length-R contraction (~sqrt(R) u), the decode of
    ``subset`` amplifies it by :func:`decode_amp`; relative to the largest
    output, with a factor 4 of slack."""
    amp = decode_amp(scheme, subset)
    return 4.0 * amp * R ** 0.5 * U32 * float(np.abs(ref_out).max()) + 1e-30


def assert_max_err(got, want, tol: float, what: str = ""):
    got, want = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: err {err:.3g} > tol {tol:.3g}"


def plain(obj):
    """Dataclasses (of either package) as plain nested python, for exact
    comparison across the two packages' distinct classes."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [plain(o) for o in obj]
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (set, frozenset)):
        return sorted(plain(o) for o in obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj
