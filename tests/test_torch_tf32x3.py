"""The arithmetic that the port's tensor-core kernels (B2, B3) rely on.

B2 and B3 multiply on the tensor cores in 3xTF32: every float32 operand
is split into TF32 planes ``hi = tf32_round(x)`` and ``lo = tf32_round(x -
hi)``, and a product is summed as ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` in
float32. The split's plain version (``cuda_kernels.tf32_split_plain``) is
the card's ``mfgp::tf32_round`` bit for bit; here it is held against an
independent float64 rounding, and the emulated 3xTF32 products of the
unit's own operands (Linv of a ``bench.build_problem`` Gram, and its
cross-covariance) are held against float64.
"""

import numpy as np
import pytest
import torch

from bench import _theta, build_problem
from mfgp_tpu_torch.ops import cuda_kernels as ck
from mfgp_tpu_torch.ops import kernels as tk
from mfgp_tpu_torch.ops import linalg as tla

F32_MAX = float(np.finfo(np.float32).max)
TINY = 2.0 ** -126  # smallest normal float32


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _tf32_ref(a: np.ndarray) -> np.ndarray:
    """Round float32 values to 11 significant bits (TF32), to nearest with
    ties away from zero, in float64 arithmetic: the quantum is 2^(e - 10)
    for 2^e <= |a| < 2^(e+1), and 2^-136 below the smallest normal. A value
    that would round past the largest finite TF32 is cut instead (the
    split's rule, so that hi + lo stays finite)."""
    a = a.astype(np.float64)
    mag = np.abs(a)
    e = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    q = np.exp2(np.maximum(e, -126.0) - 10.0)
    r = np.floor(mag / q + 0.5) * q
    r = np.where(r > F32_MAX, np.floor(mag / q) * q, r)
    return np.sign(a) * r


def _edge_values() -> np.ndarray:
    sub = np.array([1, 2, 0x0FFF, 0x1000, 0x1001, 0x3000, 0x7FFFFF],
                   np.uint32).view(np.float32)  # subnormals
    return np.concatenate([
        np.array([0.0, -0.0, TINY, -TINY, F32_MAX, -F32_MAX,
                  np.nextafter(np.float32(F32_MAX), np.float32(0)),
                  1.0, -1.0, 3.0], np.float32),
        sub, -sub])


def _tie_values() -> np.ndarray:
    """Values exactly halfway between two TF32 neighbours, both signs,
    over many binades: 13 dropped bits equal to 0x1000."""
    rng = np.random.default_rng(3)
    keep = rng.integers(0, 1 << 10, 64, dtype=np.uint32) << 13
    exp = rng.integers(1, 254, 64, dtype=np.uint32) << 23
    b = exp | keep | np.uint32(0x1000)
    b = np.concatenate([b, b | np.uint32(1 << 31)])
    return b.view(np.float32)


def _random_values() -> np.ndarray:
    rng = np.random.default_rng(4)
    return (rng.standard_normal(4096)
            * np.exp2(rng.integers(-120, 120, 4096))).astype(np.float32)


VALUE_SETS = {"edges": _edge_values, "ties": _tie_values,
              "random": _random_values}


@pytest.mark.parametrize("values", sorted(VALUE_SETS))
def test_split_planes_are_tf32_and_reconstruct(values):
    a = VALUE_SETS[values]()
    hi, lo = ck.tf32_split_plain(torch.from_numpy(a))
    # both planes carry at most 10 explicit mantissa bits
    assert not (_bits(hi) & 0x1FFF).any()
    assert not (_bits(lo) & 0x1FFF).any()
    # hi is the round-to-nearest-away TF32 value of a
    np.testing.assert_array_equal(hi.numpy().astype(np.float64),
                                  _tf32_ref(a))
    # hi + lo is a to 2^-21 relative (plus half the TF32 quantum below the
    # smallest normal, where TF32 keeps fewer bits than float32)
    err = np.abs(a.astype(np.float64) - hi.numpy().astype(np.float64)
                 - lo.numpy().astype(np.float64))
    bound = 2.0 ** -21 * np.abs(a.astype(np.float64)) + 2.0 ** -137
    assert (err <= bound).all(), (a[err > bound], err[err > bound])


def test_split_ties_round_away_from_zero():
    one = np.float32(1.0)
    q = 2.0 ** -10  # TF32 quantum at 1
    a = np.array([1 + q / 2, -(1 + q / 2), 1 + 3 * q / 2, -(1 + 3 * q / 2),
                  1 + q / 2 - 2.0 ** -23], np.float32)
    hi, _ = ck.tf32_split_plain(torch.from_numpy(a))
    np.testing.assert_array_equal(
        hi.numpy(), np.array([1 + q, -(1 + q), 1 + 2 * q, -(1 + 2 * q), one],
                             np.float32))


def test_split_special_values_pass_through():
    a = torch.tensor([float("inf"), float("-inf"), float("nan")])
    hi, _ = ck.tf32_split_plain(a)
    assert torch.isinf(hi[:2]).all() and (hi[:2] == a[:2]).all()
    assert torch.isnan(hi[2])
    np.testing.assert_array_equal(_bits(hi), _bits(a))


def test_split_transpose_and_wrapper_on_cpu():
    x = torch.from_numpy(_random_values()[:60].reshape(6, 10))
    hi_t, lo_t = ck.tf32_split_plain(x, transpose=True)
    hi, lo = ck.tf32_split(x)  # a CPU tensor takes the plain version
    assert hi_t.shape == (10, 6)
    np.testing.assert_array_equal(hi_t.numpy(), hi.numpy().T)
    np.testing.assert_array_equal(lo_t.numpy(), lo.numpy().T)


def _unit_operands(N=512, M=200):
    """Linv (float32, from the port's tri_inv_recursive of the unit's rbf
    Gram at N points) and the cross-covariance S = K(train, grid)."""
    X, fid, _, grid, gfid = build_problem(N, M, seed=2)
    v, ls, rho, nz = (torch.as_tensor(a) for a in _theta())
    X, grid = torch.as_tensor(X, dtype=torch.float64), torch.as_tensor(
        grid, dtype=torch.float64)
    fid, gfid = torch.as_tensor(fid).long(), torch.as_tensor(gfid).long()
    K = tk.ar1_cov(X, fid, X, fid, v, ls, rho, "rbf")
    K = K + torch.diag(nz[fid] + 1e-6)
    Linv = tla.tri_inv_recursive(tla.chol(K), base=128).float()
    S = tk.ar1_cov(X, fid, grid, gfid, v, ls, rho, "rbf").float()
    return Linv, S


def _products(A: torch.Tensor, B: torch.Tensor):
    """(float64 reference, 3xTF32, 1xTF32, plain float32) of A @ B on the
    same float32 inputs; the emulations sum their float32 products in
    float32, as the tensor cores do."""
    a_hi, a_lo = ck.tf32_split_plain(A)
    b_hi, b_lo = ck.tf32_split_plain(B)
    ref = A.double() @ B.double()
    x3 = (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
    return ref, x3, a_hi @ b_hi, A @ B


@pytest.mark.parametrize("product", ["LinvT_Linv", "Linv_S"])
def test_3xtf32_products_reach_float32_accuracy(product):
    Linv, S = _unit_operands()
    A, B = (Linv.T.contiguous(), Linv) if product == "LinvT_Linv" else (
        Linv, S)
    ref, x3, x1, f32 = _products(A, B)

    def normwise(c):
        return float((c.double() - ref).abs().max() / ref.abs().max())

    e3, e1, e32 = normwise(x3), normwise(x1), normwise(f32)
    # 3xTF32 is float32-level: within a few times the plain float32
    # product's own error, and 1xTF32 is at least 100x worse
    assert e3 <= max(4 * e32, 2.0 ** -22), (e3, e32)
    assert e1 >= 100 * e3, (e1, e3)

