"""The three hand-written CUDA kernels of the port, each beside its plain
PyTorch version (counterparts of ``mfgp_tpu/ops/pallas_kernels.py``).

=====================  =================================  ===================
wrapper                CUDA source (ops/csrc/)            replaces (Pallas)
=====================  =================================  ===================
``ar1_cov_fused``      ``ar1_cov.cu``                     ``ar1_cov_fused``
``ar1_cov_split``      ``ar1_cov.cu`` (hi/lo output)      (B3's staging)
``syrk_grad_fused``    ``syrk_grad.cu`` + ``tf32x3.cuh``  ``syrk_grad_fused``
``posterior_fused``    ``posterior.cu`` + ``tf32x3.cuh``  ``posterior_fused``
                       (+ ``ar1_cov_split`` staging)
``tf32_split``         ``tf32_split.cu``                  (B2/B3 operands)
=====================  =================================  ===================

B2 and B3 run their contractions on the tensor cores in 3xTF32 from
operands split into TF32 hi/lo planes: ``tf32_split`` (``tf32_split.cu``)
splits Linv or its transpose, and ``ar1_cov_split`` has B1 write the
posterior's staged cross-covariance as hi/lo planes itself.
``tf32_split_plain`` is the same split in integer operations on the float32
pattern, bit for bit.

Each wrapper keeps its JAX counterpart's name and argument order (without
``interpret`` and the Pallas tile sizes). For a tensor on the CPU it returns
its plain version, ``<name>_plain``, built from ``ops.kernels`` and
``ops.linalg``; for a CUDA tensor it launches the kernel on the current
stream or raises. It never falls back. ``LAUNCHES`` counts kernel launches
per kernel, so a run can show that it went through the kernels.

The sources' header comments say what bounds each kernel on the H100 and
how its design handles that.
"""

from __future__ import annotations

import torch

from mfgp_tpu_torch.ops import build
from mfgp_tpu_torch.ops import kernels as _k
from mfgp_tpu_torch.ops import linalg as _la

LAUNCHES = {"ar1_cov_fused": 0, "syrk_grad_fused": 0, "posterior_fused": 0,
            "tf32_split": 0}
_KERN_IDS = {"rbf": 0, "matern32": 1}
_MAX_D = 8  # mfgp::kMaxD in csrc/common.cuh
_TILE = 128  # mfgp::tc::kTile in csrc/tf32x3.cuh: B3's bands are whole tiles
# posterior_fused stages S^T = K(grid band, train) in device memory as two
# TF32 planes (hi, lo); each plane of a band holds at most this many floats
# (1 GiB, so 2 GiB for the band), a whole grid at the unit's shape
_BAND_ELEMS = 1 << 28


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def ar1_cov_fused_plain(X1, fid1, X2, fid2, variances, lengthscales, rhos,
                        noise_diag=None, kern: str = "rbf") -> torch.Tensor:
    """Plain B1: the AR1 composition plus the optional noise diagonal."""
    K = _k.ar1_cov(X1, fid1, X2, fid2, variances, lengthscales, rhos, kern)
    return K if noise_diag is None else _la.diag_add(K, noise_diag)


def _grad_from_sums(sv, sv2, diagW, X, fid, lengthscales, noises, kern):
    """(g_logvar, g_logls, g_lognoise) from the (F, 1+D, N) sums of B2 or
    of its plain version, and diag(W) (pallas_kernels.py:622-644)."""
    s = sv[:, 0, :]
    g_logvar = 0.5 * torch.sum(s, dim=1)
    s2, Ax2 = (s, sv[:, 1:, :]) if kern == "rbf" else (sv2[:, 0, :],
                                                        sv2[:, 1:, :])
    inv_ls = 1.0 / lengthscales
    g_logls = (torch.einsum("nd,mn->md", X ** 2, s2)
               - torch.einsum("nd,mdn->md", X, Ax2)) * inv_ls ** 2
    g_lognoise = torch.stack([
        0.5 * noises[f] * torch.sum(torch.where(fid == f, diagW, 0.0))
        for f in range(noises.shape[0])])
    return g_logvar, g_logls, g_lognoise


def grad_from_kinv(Kinv, alpha, X, fid, variances, lengthscales, rhos,
                   noises, kern: str = "rbf"):
    """(g_logvar, g_logls, g_lognoise) of the AR1 NLML from an explicit
    ``K^-1`` by the trace identities (``mfgp_tpu/models/mfgp.py:271-302``).
    With W = K^-1 - alpha alpha^T and T_m = var_m (w_m w_m^T) o k_m, it
    forms the sums that the B2 kernel forms: ``(W o T_m) [1, X]`` per
    fidelity and, for matern32 (whose lengthscale derivative 3 var_m w w^T
    e^{-sqrt3 r} r_d^2 is not proportional to the covariance), the same
    for ``W o (3 var_m w w^T e^{-sqrt3 r})``, then ``_grad_from_sums``."""
    N = X.shape[0]
    F = variances.shape[0]
    w = _k.ar1_fidelity_weights(rhos, F)[:, fid]
    kfn = _k.KERNELS[kern]
    Wm = Kinv - alpha[:, None] * alpha[None, :]
    ones_x = torch.cat([X.new_ones((N, 1)), X], dim=1)
    sv, sv2 = [], []
    for m in range(F):  # one N x N term alive at a time
        ww = w[m][:, None] * w[m][None, :]
        T = variances[m] * ww * kfn(X, X, 1.0, lengthscales[m])
        sv.append(((Wm * T) @ ones_x).T)
        del T
        if kern == "matern32":
            r = torch.sqrt(_k.sqdist(X, X, 1.0 / lengthscales[m]) + 1e-36)
            E = variances[m] * ww * (3.0 * torch.exp(-_k._SQRT3 * r))
            del r
            sv2.append(((Wm * E) @ ones_x).T)
            del E
        del ww
    return _grad_from_sums(torch.stack(sv),
                           torch.stack(sv2) if sv2 else None,
                           torch.diagonal(Wm), X, fid, lengthscales, noises,
                           kern)


def syrk_grad_fused_plain(Linv, alpha, X, fid, variances, lengthscales,
                          rhos, noises, kern: str = "rbf"):
    """Plain B2: ``K^-1 = Linv^T Linv`` by the structure-aware syrk, then
    the trace-identity contractions."""
    return grad_from_kinv(_la.syrk_tri_lower(Linv), alpha, X, fid,
                          variances, lengthscales, rhos, noises, kern)


def posterior_fused_plain(Linv, alpha, X, fid, Xs, fid_s, variances,
                          lengthscales, rhos, kern: str = "rbf"):
    """Plain B3: ``mu = Kxs alpha`` and ``quad = colsum((Linv Kxs^T)^2)``
    through the cross-covariance and a triangular product."""
    S = _k.ar1_cov(X, fid, Xs, fid_s, variances, lengthscales, rhos, kern)
    V = _la.tri_lower_matmul(Linv, S)
    return S.T @ alpha, torch.sum(V * V, dim=0)


def tf32_round_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits), to
    nearest with ties away from zero, by integer operations on the float32
    pattern: ``cvt.rna.tf32.f32``'s rounding, except that a finite value
    never rounds up to infinity (the low bits are cut instead at the top of
    the range). Infinities and NaNs pass unchanged. ``mfgp::tf32_round``
    (csrc/common.cuh) does the same on the card."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    special = (b & 0x7F800000) == 0x7F800000
    r = (b + 0x1000) & ~0x1FFF
    r = torch.where((r & 0x7F800000) == 0x7F800000, b & ~0x1FFF, r)
    r = torch.where(special, b, r)
    r = torch.where(r >= 1 << 31, r - (1 << 32), r)
    return r.to(torch.int32).view(torch.float32)


def tf32_split_plain(x: torch.Tensor, transpose: bool = False):
    """(hi, lo) with ``hi = tf32_round(x)`` and ``lo = tf32_round(x -
    hi)`` (of ``x.T`` when ``transpose``): the 3xTF32 operand planes."""
    if transpose:
        x = x.T
    hi = tf32_round_plain(x)
    return hi, tf32_round_plain(x - hi)


def ar1_cov_split_plain(X1, fid1, X2, fid2, variances, lengthscales, rhos,
                        kern: str = "rbf"):
    """Plain ``ar1_cov_split``: the TF32 split of the plain covariance."""
    return tf32_split_plain(ar1_cov_fused_plain(
        X1, fid1, X2, fid2, variances, lengthscales, rhos, None, kern))


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------
def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _require_f32(name: str, **tensors) -> torch.device:
    """Every tensor on one CUDA device, float32 and contiguous."""
    device = None
    for arg, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}, not CUDA")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes "
                            "float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if device is not None and t.device != device:
            raise ValueError(f"{name}: tensors on {device} and {t.device}")
        device = t.device
    return device


def _kern_id(name: str, kern: str, D: int) -> int:
    if kern not in _KERN_IDS:
        raise ValueError(f"{name}: no CUDA kernel for base '{kern}'")
    if not 1 <= D <= _MAX_D:
        raise ValueError(f"{name}: D={D}; the kernel takes 1 <= D <= "
                         f"{_MAX_D}")
    return _KERN_IDS[kern]


def _launch(entry: str, device: torch.device, *args) -> None:
    """Call a C entry point on the current stream of ``device``; raise on
    the cudaError_t it returns (a refused launch never runs)."""
    lib = build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} "
                           f"({lib.mfgp_error_string(rc).decode()})")


def _prep(X, fid, variances, lengthscales, rhos):
    """Scaled inputs (F, N, D) and folded weights (F, N): the Pallas
    kernels' ``_prep`` (``w = W[:, fid] sqrt(var)``), in float32."""
    f32 = dict(dtype=torch.float32, device=X.device)
    variances = torch.as_tensor(variances, **f32)
    lengthscales = torch.as_tensor(lengthscales, **f32)
    rhos = torch.as_tensor(rhos, **f32)
    A = X[None, :, :] * (1.0 / lengthscales)[:, None, :]
    W = _k.ar1_fidelity_weights(rhos, variances.shape[0])
    w = W[:, fid] * torch.sqrt(variances)[:, None]
    return A.contiguous(), w.contiguous()


def _ar1_check(name, X1, X2, noise_diag, kern):
    """(device, kernel id) of a B1 launch on X1 x X2, after checking the
    inputs."""
    device = _require_f32(name, X1=X1, X2=X2, noise_diag=noise_diag)
    N, D = X1.shape
    kid = _kern_id(name, kern, D)
    if X2.shape[1] != D:
        raise ValueError(f"{name}: X1 {tuple(X1.shape)} and X2 "
                         f"{tuple(X2.shape)} differ in D")
    if noise_diag is not None and (N != X2.shape[0]
                                   or noise_diag.shape != (N,)):
        raise ValueError(f"{name}: noise_diag needs a square Gram and shape "
                         f"({N},), got {tuple(noise_diag.shape)}")
    return device, kid


def _launch_ar1_cov(A, wA, B, wB, noise, out, kern_id: int,
                    lo=None) -> None:
    """B1 on prepped inputs, into ``out`` (any row stride) or, with ``lo``,
    into the TF32 planes (out, lo) of the result. Every launch of B1's
    kernel goes through here and counts under ``ar1_cov_fused``,
    posterior_fused's staging too."""
    F, N, D = A.shape
    M = B.shape[1]
    _launch("mfgp_ar1_cov_f32", A.device, _ptr(A), _ptr(wA), _ptr(B),
            _ptr(wB), _ptr(noise), _ptr(out), _ptr(lo), out.stride(0), N, M,
            F, D, kern_id)
    LAUNCHES["ar1_cov_fused"] += 1


def _planes(rows: int, cols: int, device):
    """Two (rows, cols) float32 views of row stride ``cols`` rounded up to
    32 floats: TMA needs a multiple of 16 bytes, and 128 starts every row
    on a swizzle row of the engine's boxes."""
    ld = -(-cols // 32) * 32
    return tuple(torch.empty((rows, ld), dtype=torch.float32,
                             device=device)[:, :cols] for _ in range(2))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def ar1_cov_fused(X1, fid1, X2, fid2, variances, lengthscales, rhos,
                  noise_diag=None, kern: str = "rbf") -> torch.Tensor:
    """Fused AR1 covariance (N, M) between labelled point sets (``kern``:
    rbf or matern32), plus ``noise_diag`` on the global diagonal when
    given (the training Gram, X1 aligned with X2)."""
    if not X1.is_cuda:
        return ar1_cov_fused_plain(X1, fid1, X2, fid2, variances,
                                   lengthscales, rhos, noise_diag, kern)
    device, kid = _ar1_check("ar1_cov_fused", X1, X2, noise_diag, kern)
    out = torch.empty((X1.shape[0], X2.shape[0]), dtype=torch.float32,
                      device=device)
    _launch_ar1_cov(*_prep(X1, fid1, variances, lengthscales, rhos),
                    *_prep(X2, fid2, variances, lengthscales, rhos),
                    noise_diag, out, kid)
    return out


def ar1_cov_split(X1, fid1, X2, fid2, variances, lengthscales, rhos,
                  kern: str = "rbf"):
    """(hi, lo) TF32 planes of the fused AR1 covariance (N, M), written by
    the B1 kernel in one pass: the staged operand of ``posterior_fused``.
    On the card both are views of row stride a multiple of 32 floats (see
    ``_planes``)."""
    if not X1.is_cuda:
        return ar1_cov_split_plain(X1, fid1, X2, fid2, variances,
                                   lengthscales, rhos, kern)
    device, kid = _ar1_check("ar1_cov_split", X1, X2, None, kern)
    hi, lo = _planes(X1.shape[0], X2.shape[0], device)
    _launch_ar1_cov(*_prep(X1, fid1, variances, lengthscales, rhos),
                    *_prep(X2, fid2, variances, lengthscales, rhos),
                    None, hi, kid, lo=lo)
    return hi, lo


def rbf_cov_fused(X1, X2, variance, lengthscales, noise_diag=None,
                  kern: str = "rbf") -> torch.Tensor:
    """Single-fidelity fused covariance: the F = 1 case of ar1_cov_fused
    (the name predates matern32; ``kern`` selects the base)."""
    D = X1.shape[1]
    f32 = dict(dtype=torch.float32, device=X1.device)
    ls = torch.broadcast_to(torch.as_tensor(lengthscales, **f32).reshape(-1),
                            (D,)).reshape(1, D)
    v = torch.as_tensor(variance, **f32).reshape(1)
    z1 = torch.zeros(X1.shape[0], dtype=torch.long, device=X1.device)
    z2 = torch.zeros(X2.shape[0], dtype=torch.long, device=X1.device)
    return ar1_cov_fused(X1, z1, X2, z2, v, ls, v[:0], noise_diag=noise_diag,
                         kern=kern)


def tf32_split(x: torch.Tensor, transpose: bool = False):
    """(hi, lo) TF32 planes of ``x`` (of ``x.T`` when ``transpose``), the
    3xTF32 operands of B2/B3. On the card both are views of row stride a
    multiple of 32 floats (see ``_planes``)."""
    if not x.is_cuda:
        return tf32_split_plain(x, transpose)
    device = _require_f32("tf32_split", x=x)
    if x.dim() != 2:
        raise ValueError(f"tf32_split: x is {tuple(x.shape)}, not a matrix")
    rows, cols = x.shape
    hi, lo = _planes(*((cols, rows) if transpose else (rows, cols)), device)
    _launch("mfgp_tf32_split_f32", device, _ptr(x), rows, cols, x.stride(0),
            int(transpose), _ptr(hi), _ptr(lo), hi.stride(0))
    LAUNCHES["tf32_split"] += 1
    return hi, lo


def syrk_grad_fused(Linv, alpha, X, fid, variances, lengthscales, rhos,
                    noises, kern: str = "rbf"):
    """(g_logvar, g_logls, g_lognoise) of the AR1 NLML from the inverse
    factor, without materialising K^-1 (see csrc/syrk_grad.cu)."""
    if not Linv.is_cuda:
        return syrk_grad_fused_plain(Linv, alpha, X, fid, variances,
                                     lengthscales, rhos, noises, kern)
    device = _require_f32("syrk_grad_fused", Linv=Linv, alpha=alpha, X=X)
    N, D = X.shape
    kid = _kern_id("syrk_grad_fused", kern, D)
    if Linv.shape != (N, N) or alpha.shape != (N,):
        raise ValueError(f"syrk_grad_fused: Linv {tuple(Linv.shape)}, alpha "
                         f"{tuple(alpha.shape)} for N={N}")
    A, w = _prep(X, fid, variances, lengthscales, rhos)
    F = A.shape[0]
    # the kernel's cross-block sums are float64 (see csrc/syrk_grad.cu), and
    # so is their assembly, which cancels; the gradient is returned float32
    f64 = dict(dtype=torch.float64, device=device)
    sv = torch.zeros((F, 1 + D, N), **f64)
    sv2 = torch.zeros_like(sv) if kern == "matern32" else None
    diagW = torch.empty(N, dtype=torch.float32, device=device)
    t_hi, t_lo = tf32_split(Linv, transpose=True)
    kdiag = torch.empty(N, dtype=torch.float32, device=device)
    _launch("mfgp_syrk_grad_f32", device, _ptr(Linv), _ptr(t_hi), _ptr(t_lo),
            t_hi.stride(0), _ptr(alpha), _ptr(A), _ptr(w), _ptr(X), N, F, D,
            kid, _ptr(kdiag), _ptr(sv), _ptr(sv2), _ptr(diagW))
    LAUNCHES["syrk_grad_fused"] += 1
    del t_hi, t_lo
    g = _grad_from_sums(sv, sv2, diagW.double(), X.double(), fid,
                        torch.as_tensor(lengthscales, **f64),
                        torch.as_tensor(noises, **f64), kern)
    return tuple(x.float() for x in g)


def posterior_fused(Linv, alpha, X, fid, Xs, fid_s, variances,
                    lengthscales, rhos, kern: str = "rbf"):
    """(mu, quad) of the AR1 posterior over test points ``Xs``:
    ``mu = Kxs alpha`` and ``quad[s] = ||Linv Kxs[s]^T||^2`` (so ``var =
    kss - quad``). The cross-covariance of each band of grid columns is
    staged by ``ar1_cov_split`` as the TF32 planes of K(grid band, train),
    then reduced by the tensor-core walk (see csrc/posterior.cu)."""
    if not Linv.is_cuda:
        return posterior_fused_plain(Linv, alpha, X, fid, Xs, fid_s,
                                     variances, lengthscales, rhos, kern)
    device = _require_f32("posterior_fused", Linv=Linv, alpha=alpha, X=X,
                          Xs=Xs)
    N, D = X.shape
    M = Xs.shape[0]
    _kern_id("posterior_fused", kern, D)
    if Linv.shape != (N, N) or alpha.shape != (N,) or Xs.shape[1] != D:
        raise ValueError(f"posterior_fused: Linv {tuple(Linv.shape)}, alpha "
                         f"{tuple(alpha.shape)}, Xs {tuple(Xs.shape)} for "
                         f"X {tuple(X.shape)}")
    mu = torch.zeros(M, dtype=torch.float32, device=device)
    quad = torch.zeros(M, dtype=torch.float32, device=device)
    l_hi, l_lo = tf32_split(Linv)
    band = max(_TILE, _BAND_ELEMS // max(N, 1) // _TILE * _TILE)
    for lo in range(0, M, band):
        hi = min(M, lo + band)
        s_hi, s_lo = ar1_cov_split(Xs[lo:hi], fid_s[lo:hi], X, fid,
                                   variances, lengthscales, rhos, kern)
        _launch("mfgp_posterior_f32", device, _ptr(l_hi), _ptr(l_lo),
                l_hi.stride(0), _ptr(s_hi), _ptr(s_lo), s_hi.stride(0),
                _ptr(alpha), N, hi - lo, _ptr(mu[lo:hi]), _ptr(quad[lo:hi]))
        LAUNCHES["posterior_fused"] += 1
        del s_hi, s_lo
    return mu, quad
