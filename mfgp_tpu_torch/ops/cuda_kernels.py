"""The three hand-written CUDA kernels of the port, each beside its plain
PyTorch version (counterparts of ``mfgp_tpu/ops/pallas_kernels.py``).

=====================  =================================  ===================
wrapper                CUDA source (ops/csrc/)            replaces (Pallas)
=====================  =================================  ===================
``ar1_cov_fused``      ``ar1_cov.cu``                     ``ar1_cov_fused``
``ar1_cov_fused_lanes`` ``ar1_cov.cu`` (lane axis)        ``ar1_cov_fused``
                                                          under ``vmap``
``ar1_cov_split``      ``ar1_cov.cu`` (hi/lo output)      (B3's staging)
``syrk_grad_fused``    ``syrk_grad.cu`` + ``tf32x3.cuh``  ``syrk_grad_fused``
``posterior_fused``    ``posterior.cu`` + ``tf32x3.cuh``  ``posterior_fused``
                       (+ ``ar1_cov_split`` staging)
``tf32_split``         ``tf32_split.cu``                  (B2/B3 operands)
``tri_gemm``           ``tri_gemm.cu`` + ``tf32x3.cuh``   (none: Linv's strip
                                                          products, XLA's)
=====================  =================================  ===================

B2 and B3 run their contractions on the tensor cores in 3xTF32 from
operands split into TF32 hi/lo planes: ``tf32_split`` (``tf32_split.cu``)
splits Linv or its transpose, and ``ar1_cov_split`` has B1 write the
posterior's staged cross-covariance as hi/lo planes itself.
``tf32_split_plain`` is the same split in integer operations on the float32
pattern, bit for bit. ``tri_gemm`` is the triangular tile product of
``linalg.tri_inv_recursive``'s two per-level products on the same engine,
for every node of one size of a level in one launch.
``ar1_cov_fused_lanes`` is B1 over a leading lane
axis, one covariance per lane in one launch: what ``jax.vmap`` makes of the
Pallas kernel, for the batched study's datasets x restarts.

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

import ctypes

import torch

from mfgp_tpu_torch.ops import build
from mfgp_tpu_torch.ops import kernels as _k
from mfgp_tpu_torch.ops import linalg as _la

LAUNCHES = {"ar1_cov_fused": 0, "syrk_grad_fused": 0, "posterior_fused": 0,
            "tf32_split": 0, "tri_gemm": 0}
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


def ar1_cov_fused_lanes_plain(X1, fid1, X2, fid2, variances, lengthscales,
                              rhos, noise_diag=None,
                              kern: str = "rbf") -> torch.Tensor:
    """Plain lane-axis B1: the plain B1 of each lane, stacked (L, N, M)."""
    return torch.stack([ar1_cov_fused_plain(
        X1[l], fid1[l], X2[l], fid2[l], variances[l], lengthscales[l],
        rhos[l], None if noise_diag is None else noise_diag[l], kern)
        for l in range(X1.shape[0])])


def _grad_from_sums(sv, sv2, diagW, X, fid, lengthscales, noises, kern):
    """(g_logvar, g_logls, g_lognoise) from the (F, 1+D, N) sums of B2
    and diag(W) (pallas_kernels.py:622-644)."""
    s = sv[..., 0, :]
    g_logvar = 0.5 * torch.sum(s, dim=-1)
    s2, Ax2 = (s, sv[..., 1:, :]) if kern == "rbf" else (sv2[..., 0, :],
                                                          sv2[..., 1:, :])
    inv_ls = 1.0 / lengthscales
    g_logls = (torch.einsum("...nd,...mn->...md", X ** 2, s2)
               - torch.einsum("...nd,...mdn->...md", X, Ax2)) * inv_ls ** 2
    return g_logvar, g_logls, _g_lognoise(diagW, fid, noises)


def _g_lognoise(diagW, fid, noises):
    """The noise gradients ``0.5 noise_f sum_{fid_i = f} W_ii``."""
    return torch.stack([
        0.5 * noises[..., f] * torch.sum(torch.where(fid == f, diagW, 0.0),
                                         dim=-1)
        for f in range(noises.shape[-1])], dim=-1)


# elements of one row block of grad_from_kinv's N x N terms (256 MB in
# float32): each block's few temporaries stay well under one N x N matrix
_GRAD_BLOCK_ELEMS = 1 << 26


def grad_from_kinv(Kinv, alpha, X, fid, variances, lengthscales, rhos,
                   noises, kern: str = "rbf"):
    """(g_logvar, g_logls, g_lognoise) of the AR1 NLML from an explicit
    ``K^-1`` by the trace identities (``mfgp_tpu/models/mfgp.py:271-302``).
    With W = K^-1 - alpha alpha^T, T_m = var_m (w_m w_m^T) o k_m and
    S_d = (x_d 1^T - 1 x_d^T)^2:

      g_logvar_m     = sum(W o T_m) / 2
      g_logls_{m,d}  = sum(W o T_m o S_d) / (2 l_{m,d}^2),
                       with T_m replaced for matern32 by var_m (w w^T)
                       3 e^{-sqrt3 r} (its lengthscale derivative is not
                       proportional to the covariance)
      g_lognoise_f   = noise_f sum_{fid_i = f} W_ii / 2

    The distances and S_d are summed from differences, as B1 takes them:
    the norm expansion |x|^2 + |y|^2 - 2 x.y and the contraction x^2 s -
    x (A x) cancel in float32 for close points far from the origin
    (ROADMAP C5). The N x N terms are formed a block of rows at a time.

    Every argument may carry one leading lane axis, each lane its own
    problem (Kinv (L, N, N), alpha (L, N), X (L, N, D), fid (L, N),
    variances (L, F), lengthscales (L, F, D), rhos (L, F-1), noises
    (L, F)): the batched fits' gradient, whose sums never mix lanes."""
    N, D = X.shape[-2:]
    F = variances.shape[-1]
    lead = X.shape[:-2]
    W = _k.ar1_fidelity_weights(rhos, F)
    w = torch.gather(W, -1, fid[..., None, :].expand(*W.shape[:-1], N))
    inv_ls2 = (1.0 / lengthscales) ** 2
    rows = max(1, _GRAD_BLOCK_ELEMS // (N * max(1, lead.numel())))
    g_logvar = X.new_zeros(lead + (F,))
    quad = X.new_zeros(lead + (F, D))
    for i0 in range(0, N, rows):
        i1 = min(N, i0 + rows)
        Wb = (Kinv[..., i0:i1, :]
              - alpha[..., i0:i1, None] * alpha[..., None, :])
        # S_d = (x_id - x_jd)^2 over the block's rows i, (..., D, b, N):
        # every fidelity's distances and lengthscale sums read them
        S = torch.stack([(X[..., i0:i1, None, d] - X[..., None, :, d]) ** 2
                         for d in range(D)], dim=-3)
        for m in range(F):
            # elementwise sums, not a contraction over d: a lane's result
            # does not depend on how many lanes are evaluated with it
            il2 = inv_ls2[..., m, :, None, None]
            r2 = S[..., 0, :, :] * il2[..., 0, :, :]
            for d in range(1, D):
                r2.addcmul_(S[..., d, :, :], il2[..., d, :, :])
            wm = w[..., m, :]
            A = Wb * (variances[..., m, None, None] * wm[..., i0:i1, None]
                      * wm[..., None, :])
            if kern == "rbf":
                A.mul_(torch.exp(r2.mul_(-0.5)))
                E = A
            else:
                r = torch.sqrt(r2.add_(1e-36))
                e3 = torch.exp(-_k._SQRT3 * r)
                E = (A * 3.0).mul_(e3)
                A.mul_(e3.mul_(r.mul_(_k._SQRT3).add_(1.0)))
                del r, e3
            del r2
            g_logvar[..., m] += torch.sum(A, dim=(-2, -1))
            del A
            for d in range(D):
                quad[..., m, d] += torch.sum(E * S[..., d, :, :],
                                             dim=(-2, -1))
            del E
        del S, Wb
    diagW = torch.diagonal(Kinv, dim1=-2, dim2=-1) - alpha * alpha
    return (0.5 * g_logvar, 0.5 * quad * inv_ls2,
            _g_lognoise(diagW, fid, noises))


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


_TRI = ("left", "right")


def _check_tri(tri: str) -> None:
    if tri not in _TRI:
        raise ValueError(f"tri_gemm: tri must be 'left' or 'right', got "
                         f"{tri!r}")


def tri_gemm_plain(A, B, tri: str, alpha: float = 1.0, out=None):
    """Plain ``tri_gemm``: Z products ``alpha A_z B_z^T`` for A_z (M, K)
    and B_z (N, K), each 128 x 128 output tile (i, j) summing only the k
    range that a triangular operand leaves nonzero: ``tri="left"`` (A lower
    triangular) k < min(K, 128 (i + 1)), ``tri="right"`` (B^T lower
    triangular) k >= 128 j. A and B are lists of Z matrices of one shape,
    or (hi, lo) TF32 planes with the Z matrices' rows stacked, taken as hi
    + lo. The products go into the Z (M, N) views of ``out``; without it
    the (hi, lo) TF32 planes of their transposes, stacked (Z N, M), are
    returned."""
    _check_tri(tri)
    Z = len(next(x for x in (A, B) if isinstance(x, list)))
    As, Bs = ([*torch.chunk(x[0] + x[1], Z)] if isinstance(x, tuple) else x
              for x in (A, B))
    Cs = []
    for z, (A, B) in enumerate(zip(As, Bs)):
        M, K = A.shape
        N = B.shape[0]
        C = A.new_empty((M, N)) if out is None else out[z]
        if tri == "left":
            for i0 in range(0, M, _TILE):
                k1 = min(K, i0 + _TILE)
                torch.mul(A[i0:i0 + _TILE, :k1] @ B[:, :k1].T, alpha,
                          out=C[i0:i0 + _TILE])
        else:
            for j0 in range(0, N, _TILE):
                torch.mul(A[:, j0:] @ B[j0:j0 + _TILE, j0:].T, alpha,
                          out=C[:, j0:j0 + _TILE])
        Cs.append(C)
    if out is not None:
        return out
    planes = [tf32_split_plain(C, transpose=True) for C in Cs]
    return tuple(torch.cat(p) for p in zip(*planes))


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


def _weights(fid, variances, rhos, device):
    """The folded weights (F, N) ``w = W[:, fid] sqrt(var)`` of the Pallas
    kernels' ``_prep``, in float32 (lane axis: (L, F, N))."""
    f32 = dict(dtype=torch.float32, device=device)
    variances = torch.as_tensor(variances, **f32)
    W = _k.ar1_fidelity_weights(torch.as_tensor(rhos, **f32),
                                variances.shape[-1])
    idx = fid[..., None, :].expand(*W.shape[:-1], fid.shape[-1])
    return (torch.gather(W, -1, idx)
            * torch.sqrt(variances)[..., None]).contiguous()


def _prep(X, fid, variances, lengthscales, rhos):
    """Scaled inputs (F, N, D) and folded weights (F, N): the Pallas
    kernels' ``_prep``, in float32 (B2's inputs). With a leading lane axis
    on every argument (X (L, N, D), fid (L, N), variances (L, F),
    lengthscales (L, F, D), rhos (L, F-1)) it preps all lanes at once:
    (L, F, N, D) and (L, F, N)."""
    lengthscales = torch.as_tensor(lengthscales, dtype=torch.float32,
                                   device=X.device)
    A = X[..., None, :, :] * (1.0 / lengthscales)[..., :, None, :]
    return A.contiguous(), _weights(fid, variances, rhos, X.device)


def _prep_b1(X, fid, variances, lengthscales, rhos):
    """B1's inputs: the points unscaled, one copy per fidelity (F, N, D),
    the folded weights (F, N), and the inverse lengthscales (F, D); B1
    scales each difference itself (see csrc/ar1_cov.cu). With a leading
    lane axis on every argument, (L, F, N, D), (L, F, N) and (L, F, D)."""
    lengthscales = torch.as_tensor(lengthscales, dtype=torch.float32,
                                   device=X.device)
    A = torch.broadcast_to(X.to(torch.float32)[..., None, :, :],
                           lengthscales.shape[:-1] + X.shape[-2:])
    return (A.contiguous(), _weights(fid, variances, rhos, X.device),
            (1.0 / lengthscales).contiguous())


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


def same_points(X1, fid1, X2, fid2) -> bool:
    """Whether (X1, fid1) and (X2, fid2) are the same labelled points by
    identity: each pair one memory, shape, strides and dtype, as when a
    caller passes the same tensors twice. Then their covariance is a
    symmetric Gram and B1 computes only half of it. Equal values elsewhere
    (a clone) do not count: finding those would cost a comparison."""
    def same(a, b):
        return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                and a.stride() == b.stride() and a.dtype == b.dtype
                and a.device == b.device)

    return same(X1, X2) and same(fid1, fid2)


def _launch_ar1_cov(A, wA, B, wB, ils, noise, out, kern_id: int,
                    lo=None) -> None:
    """B1 on prepped inputs (A (F, N, D), wA (F, N), B, wB likewise, ils
    (F, D): ``_prep_b1``), into
    ``out`` (any row stride) or, with ``lo``, into the TF32 planes (out,
    lo) of the result; ``B is A`` (with ``wB is wA``) takes the symmetric
    Gram's half grid. With a leading lane axis on every argument (A
    (L, F, N, D), noise (L, N), out (L, N, M), ...) one launch computes
    every lane. Every launch of B1's kernel goes through here and counts
    once under ``ar1_cov_fused``, posterior_fused's staging too."""
    lanes = A.dim() == 4
    F, N, D = A.shape[-3:]
    M = B.shape[-2]
    sym = B is A and wB is wA

    def lane_stride(t):
        return t.stride(0) if lanes and t is not None else 0

    _launch("mfgp_ar1_cov_f32", A.device, _ptr(A), _ptr(wA), _ptr(B),
            _ptr(wB), _ptr(ils), _ptr(noise), _ptr(out), _ptr(lo),
            out.stride(-2), A.shape[0] if lanes else 1, N, M, F, D, kern_id,
            int(sym),
            *(lane_stride(t) for t in (A, wA, B, wB, ils, noise, out)))
    LAUNCHES["ar1_cov_fused"] += 1


def _prep_pair(X1, fid1, X2, fid2, variances, lengthscales, rhos):
    """(A, wA, B, wB, ils) of a B1 launch; prepped once, ``B is A``, when
    the two point sets are the same (``same_points``)."""
    A, wA, ils = _prep_b1(X1, fid1, variances, lengthscales, rhos)
    if same_points(X1, fid1, X2, fid2):
        return A, wA, A, wA, ils
    B, wB, _ = _prep_b1(X2, fid2, variances, lengthscales, rhos)
    return A, wA, B, wB, ils


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
    given (the training Gram, X1 aligned with X2). Handed the same tensors
    twice (``same_points``), the kernel computes the tiles on and below the
    diagonal and mirrors them, bit for bit the full grid's result."""
    if not X1.is_cuda:
        return ar1_cov_fused_plain(X1, fid1, X2, fid2, variances,
                                   lengthscales, rhos, noise_diag, kern)
    device, kid = _ar1_check("ar1_cov_fused", X1, X2, noise_diag, kern)
    out = torch.empty((X1.shape[0], X2.shape[0]), dtype=torch.float32,
                      device=device)
    _launch_ar1_cov(*_prep_pair(X1, fid1, X2, fid2, variances, lengthscales,
                                rhos), noise_diag, out, kid)
    return out


def ar1_cov_fused_lanes(X1, fid1, X2, fid2, variances, lengthscales, rhos,
                        noise_diag=None, kern: str = "rbf") -> torch.Tensor:
    """B1 over a leading lane axis: lane l of the (L, N, M) result is
    ``ar1_cov_fused`` of lane l's arguments (X1 (L, N, D), fid1 (L, N), X2
    (L, M, D), fid2 (L, M), variances (L, F), lengthscales (L, F, D), rhos
    (L, F-1), noise_diag (L, N)), bit for bit, in one launch. The points
    may be broadcast views (one grid for every lane): only their prepped,
    per-lane scaled copies reach the kernel. Handed the same tensors twice
    (``same_points``), every lane takes its symmetric half grid."""
    if not X1.is_cuda:
        return ar1_cov_fused_lanes_plain(X1, fid1, X2, fid2, variances,
                                         lengthscales, rhos, noise_diag, kern)
    L, N, D = X1.shape
    M = X2.shape[1]
    kid = _kern_id("ar1_cov_fused_lanes", kern, D)
    if (X2.shape[0], X2.shape[2]) != (L, D) or fid1.shape != (L, N) or \
            fid2.shape != (L, M):
        raise ValueError(f"ar1_cov_fused_lanes: X1 {tuple(X1.shape)}, X2 "
                         f"{tuple(X2.shape)}, fid1 {tuple(fid1.shape)}, fid2 "
                         f"{tuple(fid2.shape)}")
    if noise_diag is not None and (N != M or noise_diag.shape != (L, N)):
        raise ValueError(f"ar1_cov_fused_lanes: noise_diag needs square Grams "
                         f"and shape ({L}, {N}), got "
                         f"{tuple(noise_diag.shape)}")
    A, wA, B, wB, ils = _prep_pair(X1, fid1, X2, fid2, variances,
                                   lengthscales, rhos)
    device = _require_f32("ar1_cov_fused_lanes", A=A, wA=wA, B=B, wB=wB,
                          noise_diag=noise_diag)
    out = torch.empty((L, N, M), dtype=torch.float32, device=device)
    _launch_ar1_cov(A, wA, B, wB, ils, noise_diag, out, kid)
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
    _launch_ar1_cov(*_prep_pair(X1, fid1, X2, fid2, variances, lengthscales,
                                rhos), None, hi, kid, lo=lo)
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
    # one label tensor for both sides when it can serve both, so that the
    # same points twice reach B1's symmetric Gram (same_points)
    z1 = torch.zeros(X1.shape[0], dtype=torch.long, device=X1.device)
    z2 = (z1 if X2.shape[0] == X1.shape[0] else
          torch.zeros(X2.shape[0], dtype=torch.long, device=X1.device))
    return ar1_cov_fused(X1, z1, X2, z2, v, ls, v[:0], noise_diag=noise_diag,
                         kern=kern)


def tf32_split(x: torch.Tensor, transpose: bool = False):
    """(hi, lo) TF32 planes of ``x`` (of ``x.T`` when ``transpose``), the
    3xTF32 operands of B2/B3. On the card both are views of row stride a
    multiple of 32 floats (see ``_planes``)."""
    if not x.is_cuda:
        return tf32_split_plain(x, transpose)
    _require_f32("tf32_split", x=x)
    if x.dim() != 2:
        raise ValueError(f"tf32_split: x is {tuple(x.shape)}, not a matrix")
    return _split_view(x, transpose)


def _split_view(x: torch.Tensor, transpose: bool, into=None):
    """``tf32_split`` of a float32 CUDA matrix view whose rows or columns
    are contiguous (a block of a larger matrix, or its transpose), into new
    planes or the views ``into`` (hi, lo) with contiguous rows."""
    if x.stride(1) != 1:  # columns contiguous: split the row-major x.T
        x, transpose = x.T, not transpose
    rows, cols = x.shape
    if x.stride(1) != 1 or (rows > 1 and x.stride(0) < cols):
        raise ValueError(f"tf32_split: strides {x.stride()} of "
                         f"{tuple(x.shape)} have no contiguous rows")
    hi, lo = into or _planes(*((cols, rows) if transpose else (rows, cols)),
                             x.device)
    _launch("mfgp_tf32_split_f32", x.device, _ptr(x), rows, cols,
            max(x.stride(0), cols), int(transpose), _ptr(hi), _ptr(lo),
            hi.stride(0))
    LAUNCHES["tf32_split"] += 1
    return hi, lo


# products per launch (kMaxZ in csrc/tri_gemm.cu): the nodes of one size of
# one level of tri_inv_recursive, of which there are 64 only past N = 65,536
_TRI_GEMM_MAX_Z = 64


def tri_gemm(A, B, tri: str, alpha: float = 1.0, out=None):
    """Z products ``alpha A_z B_z^T`` (A_z (M, K), B_z (N, K)) in one
    launch, each 128 x 128 output tile summing only the k range that the
    triangular operand leaves nonzero (``tri``: see ``tri_gemm_plain``), on
    the 3xTF32 tensor-core engine (see csrc/tri_gemm.cu). A and B are lists
    of Z float32 matrix views of one shape with contiguous rows or columns,
    split here into TF32 planes, or (hi, lo) planes with the Z matrices'
    rows stacked, as a ``tri_gemm`` without ``out`` returns them. The
    products are written into the Z (M, N) float32 views of ``out``
    (contiguous rows, one row stride); without it the TF32 planes of their
    transposes are returned, stacked (Z N, M): the K-major operand of a
    next product."""
    first = next(x for x in (A, B) if isinstance(x, list))[0]
    if not first.is_cuda:
        return tri_gemm_plain(A, B, tri, alpha, out)
    _check_tri(tri)
    device = first.device
    Z = len(next(x for x in (A, B) if isinstance(x, list)))
    if Z > _TRI_GEMM_MAX_Z:
        raise ValueError(f"tri_gemm: {Z} products; a launch takes at most "
                         f"{_TRI_GEMM_MAX_Z}")
    for name, x in (("A", A), ("B", B), ("out", out or [])):
        for t in x:
            if t.device != device or t.dtype != torch.float32:
                raise TypeError(f"tri_gemm: {name} is {t.dtype} on "
                                f"{t.device}; the kernel takes float32 on "
                                f"{device}")
    a_hi, a_lo = _stacked_planes(A, Z)
    b_hi, b_lo = _stacked_planes(B, Z)
    K = a_hi.shape[1]
    M, N = a_hi.shape[0] // Z, b_hi.shape[0] // Z
    if b_hi.shape[1] != K or a_hi.shape[0] != Z * M or \
            b_hi.shape[0] != Z * N:
        raise ValueError(f"tri_gemm: {Z} products of A {tuple(a_hi.shape)} "
                         f"and B {tuple(b_hi.shape)} (rows stacked)")
    if out is None:
        c_hi, c_lo = _planes(Z * N, M, device)
        dst = (None, 0, None, _ptr(c_hi), _ptr(c_lo), c_hi.stride(0))
    else:
        for o in out:
            if o.shape != (M, N) or o.stride() != out[0].stride() or \
                    o.stride(1) != 1:
                raise ValueError(f"tri_gemm: out {tuple(o.shape)} of strides "
                                 f"{o.stride()} for ({M}, {N}) results with "
                                 "contiguous rows and one row stride")
        off = (ctypes.c_longlong * Z)(*((o.data_ptr() - out[0].data_ptr()) // 4
                                        for o in out))
        dst = (_ptr(out[0]), out[0].stride(0), off, None, None, 0)
    _launch("mfgp_tri_gemm_f32", device, _ptr(a_hi), _ptr(a_lo),
            a_hi.stride(0), _ptr(b_hi), _ptr(b_lo), b_hi.stride(0), Z, M, N,
            K, int(tri == "left"), float(alpha), *dst)
    LAUNCHES["tri_gemm"] += 1
    return out if out is not None else (c_hi, c_lo)


def _stacked_planes(x, Z: int):
    """(hi, lo) planes of a ``tri_gemm`` operand with its Z matrices' rows
    stacked: as given, or split here (each matrix into its rows)."""
    if isinstance(x, tuple):
        return x
    rows, cols = x[0].shape
    hi, lo = _planes(Z * rows, cols, x[0].device)
    for z, m in enumerate(x):
        if m.shape != (rows, cols):
            raise ValueError(f"tri_gemm: operands {tuple(x[0].shape)} and "
                             f"{tuple(m.shape)} differ")
        _split_view(m, False, into=(hi[z * rows:(z + 1) * rows],
                                    lo[z * rows:(z + 1) * rows]))
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
    # the gradient depends on differences of points only: centred points
    # keep the assembly's x^2 s - x (A x) from cancelling for points far
    # from the origin (ROADMAP C5: 86x off at close points near 15, 5.6e-3
    # at lengthscale 0.3 over the simulator's box, against a 2e-3 bar)
    X = (X - X.mean(dim=0)).contiguous()
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
