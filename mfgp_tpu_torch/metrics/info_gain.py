"""Information-gain path scores in closed form (counterpart of
``mfgp_tpu/metrics/info_gain.py``).

SURVEY C13: the reference scores candidate paths by sequentially
re-conditioning a GP on each trajectory point with a dummy observation and
accumulating ``log(1 + sigma^2(x)/sigma_n^2)``
(reference/GraceRIGV3.py:443-503 single-fidelity,
reference/GraceRIGV3.py:525-562 multi-fidelity) — an O(P) loop of O(N^3)
GP refits.

The closed form collapses that loop exactly: the sequential conditional
predictive variances are the squared diagonal of one Cholesky factor of
the path points' joint *noisy* posterior covariance

    C = Sigma_latent(path | train) + sigma_n I,   v_k = chol(C)[k, k]^2

because the product of sequential conditional variances factorizes the
determinant. One posterior-covariance evaluation + one O(P^3) Cholesky per
candidate path replaces P full GP refits. Every function takes a leading
lane axis (one candidate path per lane) on its matrix arguments and its
mask, and scores all lanes with batched Cholesky factors and solves; a
lane whose Cholesky fails scores NaN alone (``ops.linalg.chol``).

Divergence note: for paths >100 points the reference prunes the
conditioning set with an *absolute-coordinate* box filter
(``allX[:, 0] < 3*lx`` — reference/GraceRIGV3.py:481,494,553); that filter
discards points by their absolute position rather than their distance to
the query, so it is not reproduced. The closed form here matches the
reference's un-pruned scorers (``calcPathInfoSF2``,
``calculatePathInfoEmu`` for <=100 points) exactly.
"""

from __future__ import annotations

import torch

from mfgp_tpu_torch.ops import linalg as _la


def _eye(P: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(P, dtype=like.dtype, device=like.device)


def _pair_mask(mask: torch.Tensor) -> torch.Tensor:
    return mask[..., :, None] & mask[..., None, :]


def sequential_gain_from_cov(Sigma_latent, sig_n,
                             first_self_conditioned: bool = True,
                             factor: float = 1.0, mask=None):
    """Sequential entropy gain over a path from its latent posterior cov.

    Sigma_latent: (..., P, P) posterior covariance of the path points given
    the training data, *without* observation noise. sig_n: scalar noise
    variance. Returns (...).

    first_self_conditioned=True replicates the reference's off-by-one in
    ``calcPathInfoSF2`` (reference/GraceRIGV3.py:454-456): the first point
    is scored *after* being added to the conditioning set, i.e. its
    predictive variance is computed conditioned on a noisy observation of
    itself.

    mask: optional (..., P) boolean for padded batches — masked points
    contribute no gain and do not condition later points (their rows/cols
    are replaced by identity).
    """
    P = Sigma_latent.shape[-1]
    eye = _eye(P, Sigma_latent)
    C = Sigma_latent + sig_n * eye
    if mask is not None:
        C = torch.where(_pair_mask(mask), C, eye * sig_n)
    L = _la.chol(C)
    v = torch.diagonal(L, dim1=-2, dim2=-1) ** 2  # var(y_k | y_<k, train)
    terms = torch.log(1.0 + v / sig_n)
    if first_self_conditioned:
        a = Sigma_latent[..., 0, 0]
        v0 = a - a * a / (a + sig_n) + sig_n
        terms = torch.cat([torch.log(1.0 + v0 / sig_n)[..., None],
                           terms[..., 1:]], dim=-1)
    if mask is not None:
        terms = torch.where(mask, terms, 0.0)
    return factor * torch.sum(terms, dim=-1)


def sequential_gain_cross(sigma_pp_diag, Sigma_pc, C_cond, pred_noise,
                          sig_n, factor: float = 1.0, mask=None):
    """Sequential gain when prediction and conditioning points differ.

    The multi-fidelity scorer predicts each path point at fidelity 0 while
    conditioning on the points carrying their binned fidelity labels
    (reference/GraceRIGV3.py:547-559). With

      sigma_pp_diag: (..., P) latent posterior variances of the *predicted*
          points given training data,
      Sigma_pc: (..., P, P) latent posterior cross-covariance between
          predicted point k and conditioning point j (given training data),
      C_cond: (..., P, P) noisy posterior covariance of the conditioning
          points (latent + their per-point noise diag),
      pred_noise: noise variance added to the prediction (fidelity-0
          likelihood noise),

    the k-th sequential variance is
      v_k = sigma_pp_diag[k] - sum_{j<k} B[j,k]^2 + pred_noise,
      B = chol(C_cond)^-1 Sigma_pc^T  — one triangular solve + a masked
    sum, replacing P GP refits.
    """
    L = _la.chol(C_cond)
    B = _la.tri_solve(L, Sigma_pc.mT)  # (..., P_cond, P_pred)
    P = B.shape[-1]
    # exclusive prefix: sum over conditioning points j < k for predicted k
    before = torch.triu(torch.ones((P, P), dtype=torch.bool,
                                   device=B.device), diagonal=1)  # [j, k]
    w = torch.sum(torch.where(before, B ** 2, 0.0), dim=-2)
    v = sigma_pp_diag - w + pred_noise
    terms = torch.log(1.0 + v / sig_n)
    if mask is not None:
        terms = torch.where(mask, terms, 0.0)
    return factor * torch.sum(terms, dim=-1)


def logdet(K):
    """``log |K|`` of each lane from its Cholesky factor."""
    return _la.logdet_from_chol(_la.chol(K))


def batch_logdet_gain(K_prior, Sigma_post):
    """Batch mutual-information score ``0.5 (log|K_prior| - log|Sigma_post|)``
    over a fixed evaluation grid (reference/PhysicalExperimentCode/
    GraceRIGV3.py:571-598 ``calcPathInfoSFBatch`` and :599-617
    ``calculatePathInfoEmuBatch``). Cache ``logdet_prior`` across candidates
    with :func:`logdet` — the reference caches it per plan
    (reference/PhysicalExperimentCode/GraceRIGV3.py:583-589,1314)."""
    return 0.5 * (logdet(K_prior) - logdet(Sigma_post))


def exact_mutual_information(K_latent, sig_n):
    """Exact MI between noisy observations at X and the latent field:
    ``I(y_X; f) = 0.5 log|I + K/sig_n| = 0.5 sum log(u_k/sig_n + 1)`` with
    ``u_k`` the *latent* sequential conditional variances.

    The reference's sequential scorers instead accumulate
    ``log(1 + v_k/sig_n)`` with v_k the *predictive* variance (latent +
    noise, GPy's default), which overshoots each exact term by
    ``log(1 + sig_n/(u_k + sig_n)) <= log 2`` — the approximation its own
    check prints as approximately equal (reference/informationGainTest.py).
    Both are provided; planners rank nearly identically under either.
    """
    P = K_latent.shape[-1]
    C = K_latent + sig_n * _eye(P, K_latent)
    sig = torch.as_tensor(sig_n, dtype=K_latent.dtype,
                          device=K_latent.device)
    return 0.5 * (logdet(C) - P * torch.log(sig))
