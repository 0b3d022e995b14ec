"""Operations, bytes and peaks: the yardstick of the per-layer shares.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, 700 W): TF32 on the
tensor cores 495 TFLOP/s, so 495/3 for a product accurate to float32 made
of three TF32 products (3xTF32, what B2 and B3 run); HBM3 3.35 TB/s. A
multiply-add counts as two operations.

The work of a step is what its mathematics needs, computed from the shapes,
whatever implements it:

* a fit evaluation at N: the Cholesky factor (N^3/3), the inverse factor
  (N^3/3) and K^-1 = Linv^T Linv (N^3/3): N^3;
* the unit: the evaluation, plus the grid posterior's triangular product
  Linv S^T over M grid points (N^2 M): N^3 + N^2 M;
* B2 (``syrk_grad_kernel``): the symmetric half of Linv^T Linv from a
  triangular Linv, N^3/3; it reads Linv and its two TF32 planes;
* B3 (``posterior_kernel``): Linv S^T from a triangular Linv, N^2 M; it
  reads Linv's two TF32 planes and S^T's, and writes M means and M
  variances.
"""

from __future__ import annotations

PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_HBM_BYTES_S = 3.35e12
F32 = 4


def eval_ops(N: int) -> float:
    return float(N) ** 3


def unit_ops(N: int, M: int) -> float:
    return float(N) ** 3 + float(N) ** 2 * M


def b2_ops(N: int) -> float:
    return float(N) ** 3 / 3


def b2_bytes(N: int) -> float:
    return 3.0 * F32 * float(N) ** 2


def b3_ops(N: int, M: int) -> float:
    return float(N) ** 2 * M


def b3_bytes(N: int, M: int) -> float:
    return 2.0 * F32 * (float(N) ** 2 + float(N) * M) + 2.0 * F32 * M


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the 3xTF32 peak and the bytes over the memory bandwidth."""
    return max(ops / PEAK_TF32X3_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def share_pct(bound_seconds: float, seconds: float) -> float | None:
    """``bound / time`` in percent; None where nothing was timed."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * bound_seconds / seconds


def mfu_pct(ops: float, seconds: float) -> float | None:
    """Share of the 3xTF32 peak of ``ops`` done in ``seconds``, percent."""
    return share_pct(ops / PEAK_TF32X3_FLOPS, seconds)
