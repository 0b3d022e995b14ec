#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``mfgp_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one H100

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for cuBLAS and cuDNN.
2. Build: nvcc compiles ``mfgp_tpu_torch/ops/csrc/*.cu`` for sm_90a.
3. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, both base kernels, at small shapes ragged against the tiles
   (B2/B3: N below one 128-wide tile, M of 1 and 130, F of 1 and 3), and
   the TF32 planes (``tf32_split`` and B1's) against the plain split bit
   for bit. B1 also: its symmetric half grid against the full grid bit for
   bit, and 420 ragged shapes per base against float64 (``b1_checks``).
   The build phase reports B1's registers and spills.
4. Unit: the benchmark unit of ``bench.py`` at full size (N=20,000
   training points, the M=10,571-point grid, F=3, D=3, float32) for rbf and
   matern32: ``nlml_value_grad_state_inv(inv_mode="highest")`` then
   ``predict_fused``. The NLML is held against the recorded float64 NumPy
   values, the gradient against the plain float64 path (every entry, and
   the rbf g_logvar normwise), and the launch counters show that all three
   kernels ran.
5. Times: the unit's wall time and phases, each kernel beside its plain
   version at the unit's shapes, B2's and B3's achieved TFLOP/s, and the
   TF32 split passes, on CUDA events; B1 at each of its main-path launch
   shapes (the unit's Gram, B3's S^T planes, the GP's F=1 Gram) with its
   bound and share of it; the unit's TF32 planes (Linv, Linv^T, B1's S^T)
   against the plain split bit for bit.
6. Fit: the fit paths. First two checks at a small size: the autodiff
   NLML gradient in float32 on the card (through B1's autograd Function,
   rhos included, N=2,000, both bases) against float64, and the Function's
   backward for an asymmetric cotangent (N=1,000). Where one analytic and
   one autodiff evaluation's time goes at N=20,000 (CUDA events). Then,
   with the launch counters from 0, the full-width fits (N=20,000):
   ``MFGP.optimize_restarts`` (rbf, matern32), ``MFGP.optimize`` (scipy on
   the autodiff NLML, rbf) and ``GP.optimize_restarts`` (rbf), each a few
   iterations, then ``predict`` on the grid; and the single-fidelity unit
   (``gp.nlml_value_grad_state_inv`` through B2 at F=1, then
   ``gp.predict_blocked_inv``). Each fit is held to: every lane finite, the
   best NLML no higher than at the start, finite params, a finite grid
   posterior with var > 0 on >= 99.9 % of points, B1 launched.

Every phase prints one JSON line (the fit phase one per part). A failed
build or launch raises; a failed check is reported and the script exits 1
after the last phase. The last line, on success only, is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs a CUDA device and the repository around it; without either it
exits non-zero and prints no result.

    python3 chip_smoke.py --b1-times ROOT

times only B1 at its main-path launch shapes (with its registers and
static SASS) and the unit's wall for the port package of the checkout at
ROOT, so that two commits can be timed in turns on one card. It prints
no result line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = (
    ("ar1_cov_fused", "mfgp_tpu_torch/ops/csrc/ar1_cov.cu",
     "mfgp_tpu/ops/pallas_kernels.py:121"),
    ("syrk_grad_fused", "mfgp_tpu_torch/ops/csrc/syrk_grad.cu",
     "mfgp_tpu/ops/pallas_kernels.py:486"),
    ("posterior_fused", "mfgp_tpu_torch/ops/csrc/posterior.cu",
     "mfgp_tpu/ops/pallas_kernels.py:300"),
)
BASES = ("rbf", "matern32")
FAILURES: list[str] = []
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): device
# memory bytes/s, float32 outside the tensor cores, and 3xTF32 (three TF32
# passes per float32-equivalent product)
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(name: str, ok: bool, detail: str) -> None:
    print(f"check {'ok  ' if ok else 'FAIL'} {name}: {detail}", flush=True)
    if not ok:
        FAILURES.append(f"{name}: {detail}")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def allclose(a, b, rtol: float, atol: float) -> bool:
    a, b = a.double(), b.double()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 3) -> float:
    """Mean milliseconds per call on CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def b3_check(torch, ck, dev, rng, kern, N, M, F):
    """B3 against its plain version evaluated in float64 on the same
    float32 inputs (random lower-triangular Linv); 2e-5 rtol/atol."""
    f32, f64 = torch.float32, torch.float64

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev)

    X = rng.random((N, 3)) * 5
    fid = rng.integers(0, F, N)
    Xs = rng.random((M, 3)) * 5
    fs = np.full(M, F - 1)
    var = np.array([1.5, 1.0, 0.5][:F])
    ls = rng.uniform(0.5, 2.0, (F, 3))
    rho = np.array([0.9, 0.8][:F - 1])
    fi, fsi = t(fid, torch.long), t(fs, torch.long)
    Lf = t(np.tril(rng.random((N, N))), f32)
    af, Xf, Xsf = t(rng.random(N), f32), t(X, f32), t(Xs, f32)
    mu, quad = ck.posterior_fused(Lf, af, Xf, fi, Xsf, fsi, t(var, f32),
                                  t(ls, f32), t(rho, f32), kern=kern)
    mu_r, quad_r = ck.posterior_fused_plain(
        Lf.double(), af.double(), Xf.double(), fi, Xsf.double(), fsi,
        t(var, f64), t(ls, f64), t(rho, f64), kern=kern)
    torch.cuda.synchronize()
    e = max(max_err(mu, mu_r), max_err(quad, quad_r))
    ok = (allclose(mu, mu_r, 2e-5, 2e-5)
          and allclose(quad, quad_r, 2e-5, 2e-5))
    rel = max(max_err(mu, mu_r) / float(mu_r.abs().max()),
              max_err(quad, quad_r) / float(quad_r.abs().max()))
    check(f"B3 {kern} N={N} M={M} F={F}", ok,
          f"max abs err {e:.3e}, max err / max |ref| {rel:.3e} "
          "(rtol 2e-5, atol 2e-5)")
    return e


def b2_check(torch, ck, mf, dev, kern, N, F):
    """B2 on the Linv/alpha of the benchmark's problem at N points and F
    fidelities (conditioned in float64), against its plain version on the
    same float32 Linv/alpha evaluated in float64; 2e-3 rtol/atol."""
    from bench import _theta, build_problem

    f32, f64 = torch.float32, torch.float64

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev)

    Xn, fidn, yn, _, _ = build_problem(N, 16, seed=1)
    fidn = fidn % F
    v, l, r, nz = _theta()
    v, l, r, nz = v[:F], l[:F], r[:F - 1], nz[:F]
    p64 = mf.params_from_numpy(np.log(v), np.log(l), r, np.log(nz), dev, f64)
    Xd, fd, yd = t(Xn, f64), t(fidn, torch.long), t(yn, f64)
    _, _, st = mf.nlml_value_grad_state_inv(p64, Xd, fd, yd, kernel=kern,
                                            jitter=1e-6)
    L32, a32 = st.Linv.float(), st.alpha.float()
    got = ck.syrk_grad_fused(L32, a32, Xd.float(), fd, t(v, f32), t(l, f32),
                             t(r, f32), t(nz, f32), kern=kern)
    ref = ck.syrk_grad_fused_plain(L32.double(), a32.double(), Xd, fd,
                                   t(v, f64), t(l, f64), t(r, f64),
                                   t(nz, f64), kern=kern)
    torch.cuda.synchronize()
    e = max(max_err(g, h) for g, h in zip(got, ref))
    ok = all(allclose(g, h, 2e-3, 2e-3) for g, h in zip(got, ref))
    check(f"B2 {kern} N={N} F={F}", ok,
          f"max abs err {e:.3e} (rtol 2e-3, atol 2e-3)")
    return e


def kernel_checks(torch, ck, mf, dev):
    """Phase 3: each kernel against its plain version (float64 reference
    on the same inputs) at small ragged shapes; returns the max abs error
    per kernel over both bases."""
    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(0)
    errs = {name: 0.0 for name, _, _ in KERNELS}
    for kern in BASES:
        # B1: N=1000 x M=1537 (neither a multiple of the 32-wide tile), F=3,
        # noise on the diagonal of the square Gram; 1e-5 atol
        N, M, D, F = 1000, 1537, 3, 3
        X1 = rng.normal(size=(N, D))
        X2 = rng.normal(size=(M, D))
        f1 = rng.integers(0, F, N)
        f2 = rng.integers(0, F, M)
        var = np.array([2.0, 1.5, 0.7])
        ls = rng.uniform(0.5, 2.0, (F, D))
        rho = np.array([1.1, 0.9])
        noise = rng.uniform(0.1, 0.5, N)

        def t(a, dt):
            return torch.as_tensor(a, dtype=dt, device=dev)

        fi1, fi2 = t(f1, torch.long), t(f2, torch.long)
        for X2_, fi2_, nz, label in ((X2, fi2, None, "cross"),
                                     (X1, fi1, noise, "gram+noise")):
            args32 = (t(X1, f32), fi1, t(X2_, f32), fi2_, t(var, f32),
                      t(ls, f32), t(rho, f32))
            args64 = (t(X1, f64), fi1, t(X2_, f64), fi2_, t(var, f64),
                      t(ls, f64), t(rho, f64))
            got = ck.ar1_cov_fused(*args32, noise_diag=None if nz is None
                                   else t(nz, f32), kern=kern)
            ref = ck.ar1_cov_fused_plain(*args64, noise_diag=None if nz is None
                                         else t(nz, f64), kern=kern)
            torch.cuda.synchronize()
            e = max_err(got, ref)
            errs["ar1_cov_fused"] = max(errs["ar1_cov_fused"], e)
            check(f"B1 {kern} {label} {tuple(got.shape)}", e <= 1e-5,
                  f"max abs err {e:.3e} (atol 1e-5)")

        # B3 (2e-5 rtol/atol) and B2 (2e-3 rtol/atol) at shapes ragged
        # against the engine's 128-wide tiles and 32-deep stages: N below
        # one tile, M of 1 and 130, F of 1 and 3
        for N, M, F_ in ((2000, 1500, 3), (50, 130, 1), (333, 1, 3),
                         (1000, 130, 1)):
            e = b3_check(torch, ck, dev, rng, kern, N, M, F_)
            errs["posterior_fused"] = max(errs["posterior_fused"], e)
        for N, F_ in ((1500, 3), (50, 1), (333, 3), (1031, 1)):
            e = b2_check(torch, ck, mf, dev, kern, N, F_)
            errs["syrk_grad_fused"] = max(errs["syrk_grad_fused"], e)

    # the TF32 planes against the plain split, bit for bit: tf32_split in
    # both layouts, and B1's planes (B3's staged S^T) against the plain
    # split of B1's own output, at shapes ragged against the 32-wide tiles
    x = rng.standard_normal((333, 1031)) * 10.0 ** rng.integers(-30, 30,
                                                                 (333, 1031))
    x = torch.as_tensor(x, dtype=f32, device=dev)
    for transpose in (False, True):
        same = planes_match(torch, ck.tf32_split(x, transpose=transpose),
                            lambda r0, r1, tr=transpose: ck.tf32_split_plain(
                                x[:, r0:r1] if tr else x[r0:r1], tr))
        check(f"tf32_split transpose={transpose} (333, 1031)", same,
              "bit-identical to tf32_split_plain")
    for kern in BASES:
        args = (t(X2, f32), fi2, t(X1, f32), fi1, t(var, f32), t(ls, f32),
                t(rho, f32))
        K = ck.ar1_cov_fused(*args, kern=kern)
        same = planes_match(torch, ck.ar1_cov_split(*args, kern=kern),
                            lambda r0, r1: ck.tf32_split_plain(K[r0:r1]))
        check(f"B1 {kern} TF32 planes {tuple(K.shape)}", same,
              "bit-identical to tf32_split_plain of B1's output")
    emit("kernels", max_abs_err=errs)
    return errs


def b1_checks(torch, ck, dev):
    """Phase 3, B1's redesign: the symmetric half grid (the same tensors
    twice) against the full grid (the same points as two distinct
    tensors) bit for bit, at N of 1, 31, 33, 1000 and 1031, F of 1 and 3,
    noise on and off; then B1 against its plain version in float64 at
    ragged shapes (N in 1, 33, 127, 129, 1537; M also 128 and 1536, so
    that both the 16-byte and the scalar stores run; D of 1, 3, 8; F of 1,
    2, 3, 5), atol 1e-5. Returns the max abs error."""
    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(4)

    def t(a, dt=f32):
        return torch.as_tensor(a, dtype=dt if a.dtype.kind == "f" else None,
                               device=dev)

    def problem(N, M, D, F):
        return (rng.normal(size=(N, D)), rng.integers(0, F, N),
                rng.normal(size=(M, D)), rng.integers(0, F, M),
                rng.uniform(0.5, 2.0, F), rng.uniform(0.5, 2.0, (F, D)),
                rng.uniform(0.7, 1.2, F - 1))

    for kern in BASES:
        for F in (1, 3):
            differ = []
            for N in (1, 31, 33, 1000, 1031):
                X, fid, _, _, v, ls, rho = (t(a) for a in problem(N, 1, 3, F))
                nz = t(rng.uniform(0.1, 0.5, N))
                for noise in (None, nz):
                    sym = ck.ar1_cov_fused(X, fid, X, fid, v, ls, rho, noise,
                                           kern)
                    full = ck.ar1_cov_fused(X, fid, X.clone(), fid.clone(), v,
                                            ls, rho, noise, kern)
                    if not torch.equal(sym.view(torch.int32),
                                       full.view(torch.int32)):
                        differ.append((N, noise is not None))
            check(f"B1 {kern} F={F} symmetric = general", not differ,
                  f"bit-identical at N in (1, 31, 33, 1000, 1031), noise on "
                  f"and off; differing (N, noise): {differ}")
    worst = {}
    sizes = (1, 33, 127, 129, 1537)
    for kern in BASES:
        e_max, at, n = 0.0, None, 0
        for N in sizes:
            for M in sizes + (128, 1536):
                for D in (1, 3, 8):
                    for F in (1, 2, 3, 5):
                        a = problem(N, M, D, F)
                        got = ck.ar1_cov_fused(*(t(x) for x in a), kern=kern)
                        ref = ck.ar1_cov_fused_plain(*(t(x, f64) for x in a),
                                                     kern=kern)
                        e = max_err(got, ref)
                        n += 1
                        if e > e_max or at is None:
                            e_max, at = e, (N, M, D, F)
        torch.cuda.synchronize()
        worst[kern] = e_max
        check(f"B1 {kern} ragged vs plain f64", e_max <= 1e-5,
              f"{n} shapes; max abs err {e_max:.3e} at (N, M, D, F) = {at} "
              "(atol 1e-5)")
    emit("b1_checks", max_abs_err=worst)
    return max(worst.values())


def b1_launches(torch, ck, problem, kern: str):
    """B1's launch shapes on the main path, each as (name, kernel call,
    plain call, bytes, flop): the unit's Gram with noise (N^2, F=3), B3's
    S^T staged as TF32 planes (M x N, two planes) and the GP's Gram (F=1).
    Bytes: each input read once, each output written once. Flop: per
    evaluation of one fidelity's term 3D + 5 for rbf (D differences and
    FMAs, the scale, the exponential, the weight product and the sum),
    3D + 8 for matern32 (and its guard, sqrt and polynomial); a symmetric
    Gram needs N(N+1)/2 evaluations per fidelity."""
    Xt, ft, _, gt, gft, p = problem
    v, ls, rho, nz = p.variances, p.lengthscales, p.rhos, p.noises
    N, D = Xt.shape
    M = gt.shape[0]
    F = v.shape[0]
    noise = nz[ft] + 1e-6
    per = 3 * D + (5 if kern == "rbf" else 8)
    z = torch.zeros(N, dtype=torch.long, device=Xt.device)
    sym = N * (N + 1) / 2
    pts = (N * D + N) * 4 + N * 8  # X, noise and labels, float32 / int64
    return (
        ("gram", lambda: ck.ar1_cov_fused(Xt, ft, Xt, ft, v, ls, rho, noise,
                                          kern),
         lambda: ck.ar1_cov_fused_plain(Xt, ft, Xt, ft, v, ls, rho, noise,
                                        kern),
         4 * N * N + pts, sym * F * per),
        ("st_planes", lambda: ck.ar1_cov_split(gt, gft, Xt, ft, v, ls, rho,
                                               kern),
         lambda: ck.ar1_cov_split_plain(gt, gft, Xt, ft, v, ls, rho, kern),
         2 * 4 * M * N + pts + (M * D) * 4 + M * 8, M * N * F * per),
        ("gp_gram", lambda: ck.rbf_cov_fused(Xt, Xt, v[2], ls[2], noise,
                                             kern),
         lambda: ck.ar1_cov_fused_plain(Xt, z, Xt, z, v[2:], ls[2:], rho[:0],
                                        noise, kern),
         4 * N * N + pts, sym * per),
    )


def b1_times(torch, ck, problem, kern: str, plain: bool = True) -> dict:
    """B1 at each main-path launch shape (``b1_launches``), on CUDA events:
    min of two runs of ten launches, with ``plain`` its plain version in
    turns (plain, kernel, kernel, plain); beside each its bound (the larger
    of bytes over 3.35 TB/s and flop over 67 TFLOP/s), which of the two
    sets it, the share of the bound reached, and the write rate achieved."""
    out = {}
    for name, fused, ref, nbytes, flop in b1_launches(torch, ck, problem,
                                                      kern):
        p1 = cuda_ms(torch, ref, reps=1) if plain else None
        k1 = cuda_ms(torch, fused, reps=10)
        k2 = cuda_ms(torch, fused, reps=10)
        p2 = cuda_ms(torch, ref, reps=1) if plain else None
        ms = min(k1, k2)
        t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flop / FP32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        out[name] = {"ms": ms, "ms_runs": [k1, k2],
                     "plain_ms": min(p1, p2) if plain else None,
                     "plain_ms_runs": [p1, p2] if plain else None,
                     "bytes": nbytes, "flop": flop, "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "share_of_bound": bound / ms,
                     "write_tb_per_s": nbytes / ms / 1e9}
    return out


def ptxas_report(log_lines, part: str) -> dict:
    """Registers, spills and shared memory per kernel whose mangled name
    holds ``part``, from the ``-Xptxas -v`` lines of build.log."""
    out, name = {}, None
    for ln in log_lines:
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", ln)
        if m:
            name = m.group(1) if part in m.group(1) else None
            continue
        if name is None:
            continue
        rec = out.setdefault(short_name(name), {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            rec["spill_stores"], rec["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", ln)
        if m:
            rec["registers"], rec["smem"] = map(int, m.groups())
    return out


def short_name(mangled: str) -> str:
    """B1's instantiation as 'base D' (D padded: 3 or 8); other names as
    they are."""
    m = re.search(r"ar1_cov_kernelILi(\d+)ELi(\d+)E", mangled)
    if not m:
        return mangled
    k, d = map(int, m.groups())
    return f"{BASES[k]} D{d}"


def sass_report(lib_path, part: str, keep) -> dict:
    """Static SASS of the kernels whose mangled name holds ``part``
    (``cuobjdump -sass`` on the built library), for the names ``keep``
    accepts: instructions in all, and the inner loop, taken as the loop
    (a backward branch) with the most ``MUFU.EX2``: its instructions, its
    exponentials, its instructions per exponential (each output costs one
    exponential per fidelity, so this is the instruction cost of one
    output's term), and its opcodes."""
    import collections

    from mfgp_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1) if part in m.group(1) else None
            if name is not None:
                funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][\w.]*)([^;]*)", ln)
        if m and name is not None:
            funcs[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for mangled, ins in funcs.items():
        short = short_name(mangled)
        if not keep(short):
            continue
        at = {a: i for i, (a, _, _) in enumerate(ins)}
        loop = []
        for i, (a, op, rest) in enumerate(ins):
            m = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if m and int(m.group(1), 16) in at and int(m.group(1), 16) < a:
                body = ins[at[int(m.group(1), 16)]:i + 1]
                if (sum(o == "MUFU.EX2" for _, o, _ in body)
                        > sum(o == "MUFU.EX2" for _, o, _ in loop)):
                    loop = body
        ops = collections.Counter(o if o.startswith("MUFU") else
                                  o.split(".")[0] for _, o, _ in loop)
        n, ex2 = sum(ops.values()) - ops["NOP"], ops["MUFU.EX2"]
        out[short] = {"instructions": len(ins), "loop_instructions": n,
                      "loop_mufu_ex2": ex2,
                      "loop_per_exp": n / ex2 if ex2 else None,
                      "loop_ops": dict(ops.most_common(12))}
    return out


def main_path_b1(short: str) -> bool:
    """The instantiations of B1 the main path runs (D=3), and a kernel
    without template arguments (an earlier version's)."""
    return short.endswith(" D3") or "ar1_cov_kernel" in short


def make_problem(torch, mf, dev):
    """The benchmark unit's problem on the card: (X, fid, y, grid, grid
    fid, params), float32."""
    from bench import M_GRID, N_TRAIN, _theta, build_problem

    X, fid, y, grid, gfid = build_problem(N_TRAIN, M_GRID)
    v, l, r, nz = _theta()
    params = mf.params_from_numpy(np.log(v), np.log(l), r, np.log(nz), dev,
                                  torch.float32)

    def t(a, dt=torch.float32):
        return torch.as_tensor(a, dtype=dt, device=dev)

    return (t(X), t(fid, torch.long), t(y), t(grid), t(gfid, torch.long),
            params)


def b1_times_only(root: str) -> int:
    """``--b1-times ROOT``: B1's kernel times at the main path's launch
    shapes for the port package of the checkout at ROOT (another commit's,
    so that two versions can be timed in turns on one card), with its
    registers and static SASS, and the unit's wall (``unit_walls``); no
    checks, no result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from mfgp_tpu_torch.models import mfgp as mf
    from mfgp_tpu_torch.ops import build
    from mfgp_tpu_torch.ops import cuda_kernels as ck

    if not os.path.abspath(ck.__file__).startswith(root + os.sep):
        print(f"chip_smoke: imported {ck.__file__}, not from {root}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    log = (lib_path.parent / "build.log").read_text().splitlines()
    emit("b1_build", root=root, nvidia_smi=nvidia_smi(),
         seconds=time.perf_counter() - t0,
         ptxas=ptxas_report(log, "ar1_cov_kernel"),
         sass=sass_report(lib_path, "ar1_cov_kernel", main_path_b1))
    problem = make_problem(torch, mf, dev)
    for kern in BASES:
        emit("b1_times", root=root, base=kern,
             times=b1_times(torch, ck, problem, kern, plain=False),
             unit_wall_s=unit_walls(torch, mf, problem, kern, reps=4))
    return 0


def planes_match(torch, planes, plain_rows, step: int = 2048) -> bool:
    """Whether the (hi, lo) planes equal, bit for bit, the plain planes of
    their rows, which ``plain_rows(r0, r1)`` returns, taken ``step`` rows
    at a time."""
    torch.cuda.synchronize()
    rows = planes[0].shape[0]
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        for got, ref in zip(planes, plain_rows(r0, r1)):
            if not torch.equal(got[r0:r1].contiguous().view(torch.int32),
                               ref.contiguous().view(torch.int32)):
                return False
    return True


def run_unit(torch, ck, mf, problem, kern: str, nlml_ref: float):
    """Phase 4: the benchmark unit at full size, checked."""
    Xt, ft, yt, gt, gft, params = problem
    before = dict(ck.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val, grad, state = mf.nlml_value_grad_state_inv(
        params, Xt, ft, yt, kernel=kern, jitter=1e-6, inv_mode="highest")
    mu, var = mf.predict_fused(params, state, gt, gft, kernel=kern)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    nlml = float(val)
    rel = abs(nlml - nlml_ref) / abs(nlml_ref)
    check(f"unit {kern} nlml", rel <= 1e-3,
          f"{nlml:.4f} vs recorded f64 {nlml_ref}: rel err {rel:.3e} "
          "(<= 1e-3)")
    finite = all(bool(torch.isfinite(g).all()) for g in grad) and bool(
        torch.isfinite(mu).all()) and bool(torch.isfinite(var).all())
    check(f"unit {kern} finite", finite, "gradient, mu and var finite")
    pos = float((var > 0).double().mean())
    check(f"unit {kern} var>0", pos >= 0.999,
          f"share of grid with var > 0: {pos:.6f} (>= 0.999)")
    check(f"unit {kern} launches", all(n > 0 for n in launched.values()),
          f"kernel launches in this unit: {launched}")

    # gradient against the plain path (structure-aware syrk + contractions)
    # at the same N, on the same float32 Linv/alpha evaluated in float64:
    # every entry within 2e-3 relative. The plain float32 path's own errors
    # are printed beside the kernel's (at this N its sequential float32
    # K^-1 sums lose the rbf g_logvar to a few per cent).
    args = (state.Linv, state.alpha, Xt, ft, params.variances,
            params.lengthscales, params.rhos, params.noises)
    ref = ck.syrk_grad_fused_plain(*(a.double() if a.is_floating_point()
                                     else a for a in args), kern=kern)
    plain32 = ck.syrk_grad_fused_plain(*args, kern=kern)
    got = (grad.log_variances, grad.log_lengthscales, grad.log_noises)

    def errs(gs):
        norms = [max_err(g, h) / float(h.abs().max()) for g, h in zip(gs, ref)]
        comp = max(float(((g.double() - h).abs() / h.abs()).max())
                   for g, h in zip(gs, ref))
        return norms, comp

    gnorms, gcomp = errs(got)
    pnorms, pcomp = errs(plain32)
    gnorm, pnorm = max(gnorms), max(pnorms)
    check(f"unit {kern} gradient", gcomp <= 2e-3,
          f"max rel err vs plain f64 {gcomp:.3e} (rtol 2e-3; plain f32 "
          f"path {pcomp:.3e}); max |err| / max |ref| per field {gnorm:.3e} "
          f"(plain f32 {pnorm:.3e})")
    # g_logvar sums ~N^2 entries of W o T that cancel, so a bias in K^-1 of
    # 1e-7 shows here first; cuBLAS' float32 path sits at ~3e-2
    if kern == "rbf":
        check(f"unit {kern} g_logvar normwise", gnorms[0] <= 1e-4,
              f"max |err| / max |ref| {gnorms[0]:.3e} (<= 1e-4; plain f32 "
              f"{pnorms[0]:.3e})")
    emit("unit", base=kern, N=int(Xt.shape[0]), M=int(gt.shape[0]),
         nlml=nlml, nlml_rel_err=rel, grad_normwise_err=gnorm,
         g_logvar_normwise_err=gnorms[0], grad_normwise_errs=gnorms,
         grad_componentwise_err=gcomp, plain_f32_grad_normwise_err=pnorm,
         plain_f32_grad_componentwise_err=pcomp, var_pos_share=pos,
         launches=launched, first_call_s=first_s, peak_mem_gb=peak_gb,
         grad=[g.double().cpu().numpy().round(6).tolist() for g in got],
         grad_ref=[h.cpu().numpy().round(6).tolist() for h in ref])
    del ref, plain32
    return state


def unit_walls(torch, mf, problem, kern: str, reps: int = 3) -> list:
    """Seconds of each of ``reps`` units (NLML, gradient, conditioning,
    grid posterior), host clock; the first carries any one-time set-up
    the caller has not paid yet."""
    Xt, ft, yt, gt, gft, p = problem
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, st = mf.nlml_value_grad_state_inv(p, Xt, ft, yt, kernel=kern,
                                                jitter=1e-6)
        mf.predict_fused(p, st, gt, gft, kernel=kern)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del st
    return walls


def unit_times(torch, ck, mf, la, cov, problem, kern: str, state):
    """Phase 5: wall time of the unit, its phases, and each kernel beside
    its plain version at the unit's shapes (CUDA events)."""
    Xt, ft, yt, gt, gft, p = problem
    walls = unit_walls(torch, mf, problem, kern)

    # the unit's steps one by one, as _nlml_vg_core + predict_fused run them
    v, ls, rho, nz = p.variances, p.lengthscales, p.rhos, p.noises
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    torch.cuda.synchronize()
    ev[0].record()
    Kn = cov.mf_train_cov(v, ls, rho, nz, Xt, ft, 1e-6, kern)
    ev[1].record()
    L = la.chol(Kn)
    del Kn
    ev[2].record()
    Linv = la.tri_inv_recursive(L)
    ev[3].record()
    z = la.tri_lower_matmul(Linv, yt[:, None])
    alpha = la.tri_lower_matmul_right(z.reshape(1, -1), Linv).reshape(-1)
    la.logdet_from_chol(L)
    del L
    ev[4].record()
    ck.syrk_grad_fused(Linv, alpha, Xt, ft, v, ls, rho, nz, kern=kern)
    ev[5].record()
    mf.predict_fused(p, state, gt, gft, kernel=kern)
    ev[6].record()
    torch.cuda.synchronize()
    names = ("assembly", "chol", "tri_inv", "alpha_logdet", "gradient",
             "posterior")
    phases = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    del Linv, alpha, z

    noise = nz[ft] + 1e-6
    S, a = state.Linv, state.alpha
    runs = {
        "syrk_grad_fused": (
            lambda: ck.syrk_grad_fused(S, a, Xt, ft, v, ls, rho, nz, kern),
            lambda: ck.syrk_grad_fused_plain(S, a, Xt, ft, v, ls, rho, nz,
                                             kern)),
        "posterior_fused": (
            lambda: ck.posterior_fused(S, a, Xt, ft, gt, gft, v, ls, rho,
                                       kern),
            lambda: ck.posterior_fused_plain(S, a, Xt, ft, gt, gft, v, ls,
                                             rho, kern)),
    }
    # B1 at each of its launch shapes (the unit's Gram is its row)
    b1 = b1_times(torch, ck, problem, kern)
    kernel_ms = {"ar1_cov_fused": dict(b1["gram"])}
    for name, (fused, plain) in runs.items():
        # plain, kernel, kernel, plain: compare within one card, in turns
        p1 = cuda_ms(torch, plain, reps=1)
        k1 = cuda_ms(torch, fused)
        k2 = cuda_ms(torch, fused)
        p2 = cuda_ms(torch, plain, reps=1)
        kernel_ms[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                           "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2]}
    # achieved rate of the contractions in float32-equivalent flop (2 per
    # multiply-add the algorithm needs: N^3/6 for B2's K^-1 tiles, N^2 M / 2
    # for B3's V), wrapper passes included
    N, M = Xt.shape[0], gt.shape[0]
    for name, flop in (("syrk_grad_fused", N ** 3 / 3),
                       ("posterior_fused", N * N * M)):
        kernel_ms[name]["tflops"] = flop / kernel_ms[name]["ms"] / 1e9
    # the TF32 split passes inside B3 (Linv) and B2 (Linv^T), and B1's
    # staging of S^T = K(grid, train) as planes inside B3
    split_ms = {f"transpose={tr}": cuda_ms(
        torch, lambda tr=tr: ck.tf32_split(S, transpose=tr))
        for tr in (False, True)}
    split_ms["b1_st_planes"] = b1["st_planes"]["ms"]
    # the same planes at the unit's shapes against the plain split, bit for
    # bit (a wrong plane fails here by name, not only as B2/B3 error)
    for tr in (False, True):
        same = planes_match(torch, ck.tf32_split(S, transpose=tr),
                            lambda r0, r1, tr=tr: ck.tf32_split_plain(
                                S[:, r0:r1] if tr else S[r0:r1], tr))
        check(f"unit {kern} tf32_split transpose={tr} {tuple(S.shape)}",
              same, "bit-identical to tf32_split_plain")
    Kst = ck.ar1_cov_fused(gt, gft, Xt, ft, v, ls, rho, None, kern)
    same = planes_match(torch, ck.ar1_cov_split(gt, gft, Xt, ft, v, ls, rho,
                                                kern),
                        lambda r0, r1: ck.tf32_split_plain(Kst[r0:r1]))
    check(f"unit {kern} B1 S^T planes {tuple(Kst.shape)}", same,
          "bit-identical to tf32_split_plain of B1's output")
    del Kst
    # the unit's B1 and B3 outputs against their plain versions in float64
    K = ck.ar1_cov_fused(Xt, ft, Xt, ft, v, ls, rho, noise, kern)
    Kr = ck.ar1_cov_fused_plain(Xt.double(), ft, Xt.double(), ft, v.double(),
                                ls.double(), rho.double(), noise.double(),
                                kern)
    b1_err = max_err(K, Kr)
    check(f"unit {kern} B1 Gram vs plain f64", allclose(K, Kr, 1e-5, 1e-5),
          f"max abs err {b1_err:.3e}, max |K| {float(Kr.abs().max()):.3e} "
          "(rtol 1e-5, atol 1e-5)")
    del K, Kr
    mu, quad = ck.posterior_fused(S, a, Xt, ft, gt, gft, v, ls, rho, kern)
    mu_r, quad_r = ck.posterior_fused_plain(
        S.double(), a.double(), Xt.double(), ft, gt.double(), gft,
        v.double(), ls.double(), rho.double(), kern)
    mu_p, quad_p = ck.posterior_fused_plain(S, a, Xt, ft, gt, gft, v, ls,
                                            rho, kern)

    def normwise(m, q):
        return max(max_err(m, mu_r) / float(mu_r.abs().max()),
                   max_err(q, quad_r) / float(quad_r.abs().max()))

    # at N=20,000 each V entry is a float32 sum of ~1e4 signed terms; the
    # plain float32 version's own error is printed beside the kernel's
    b3_err, b3_plain_err = normwise(mu, quad), normwise(mu_p, quad_p)
    check(f"unit {kern} B3 grid vs plain f64", b3_err <= 1e-4,
          f"max |err| / max |ref| {b3_err:.3e} (<= 1e-4); plain f32 "
          f"{b3_plain_err:.3e}")
    emit("times", base=kern, unit_wall_s=walls, phases_ms=phases,
         kernel_ms=kernel_ms, b1_ms=b1, split_ms=split_ms, b1_unit_err=b1_err,
         b3_unit_err=b3_err, b3_plain_f32_err=b3_plain_err)
    return kernel_ms


def field_errs(got, ref) -> list[float]:
    """max |err| / max |ref| of each non-empty field."""
    return [max_err(g, h) / float(h.double().abs().max())
            for g, h in zip(got, ref) if h.numel()]


def autodiff_checks(torch, mf, cov, dev):
    """Phase 6, checks: the autodiff NLML gradient in float32 on the card
    (B1's Function forward, closed-form backward) at the benchmark's
    problem cut to N=2,000, against the float64 plain path (all four
    fields, rhos included) and the float64 analytic gradient (the other
    three); then the Function's backward alone for an asymmetric cotangent
    at N=1,000 against float64 autograd of the plain composition. Bar:
    max |err| / max |ref| <= 2e-3 per field."""
    from bench import _theta, build_problem

    f32, f64 = torch.float32, torch.float64
    Xn, fidn, yn, _, _ = build_problem(2000, 16, seed=1)
    v, l, r, nz = _theta()
    raw = (np.log(v), np.log(l), r, np.log(nz))
    errs = {}
    for kern in BASES:
        out = {}
        for dt in (f32, f64):
            p = mf.MFGPParams(*(torch.tensor(a, dtype=dt, device=dev,
                                             requires_grad=True)
                                for a in raw))
            data = (torch.as_tensor(Xn, dtype=dt, device=dev),
                    torch.as_tensor(fidn, dtype=torch.long, device=dev),
                    torch.as_tensor(yn, dtype=dt, device=dev))
            val = mf.nlml(p, *data, kernel=kern, jitter=1e-6)
            out[dt] = torch.autograd.grad(val, list(p))
        _, g_an = mf.nlml_value_and_grad(
            mf.params_from_numpy(*raw, dev, f64),
            *(torch.as_tensor(a, device=dev) for a in (Xn.astype(np.float64),
                                                       fidn.astype(np.int64),
                                                       yn.astype(np.float64))),
            kernel=kern, jitter=1e-6)
        e_ad = field_errs(out[f32], out[f64])
        e_an = field_errs((out[f32][0], out[f32][1], out[f32][3]),
                          (g_an.log_variances, g_an.log_lengthscales,
                           g_an.log_noises))
        check(f"fit autodiff gradient {kern} N=2000",
              max(e_ad + e_an) <= 2e-3,
              f"per field (var, ls, rho, noise) vs f64 autodiff {e_ad}, "
              f"(var, ls, noise) vs f64 analytic {e_an} (<= 2e-3)")
        errs[kern] = {"vs_f64_autodiff": e_ad, "vs_f64_analytic": e_an}

        rng = np.random.default_rng(3)
        N = 1000
        X, fid = rng.random((N, 3)) * 6, rng.integers(0, 3, N)
        Ct = rng.normal(size=(N, N))
        back = {}
        for dt in (f32, f64):
            args = [torch.tensor(a, dtype=dt, device=dev, requires_grad=True)
                    for a in (v / 10, l / 4, np.array([0.9, 0.8]))]
            K = cov.ar1_cov_diff(*args, torch.as_tensor(X, dtype=dt,
                                                        device=dev),
                                 torch.as_tensor(fid, device=dev), kern)
            back[dt] = torch.autograd.grad(
                K, args, torch.as_tensor(Ct, dtype=dt, device=dev))
        e_bw = field_errs(back[f32], back[f64])
        check(f"fit Function backward {kern} N={N}", max(e_bw) <= 2e-3,
              f"per field (var, ls, rho) vs f64 autograd {e_bw} (<= 2e-3)")
        errs[kern]["function_backward"] = e_bw
    emit("fit", part="autodiff_checks", errs=errs)


class FitProbe:
    """Counts and times (CUDA-synchronised, host clock) every NLML
    evaluation a fit makes, and keeps each restart lane's final NLML and
    iteration count, by wrapping the module-level functions the models'
    fit methods call; ``restore`` puts them back. The package is
    unchanged."""

    def __init__(self, torch, mods):
        self.torch = torch
        self.saved = []
        self.reset()
        for mod in mods:
            self._wrap(mod, "nlml_value_and_grad", self._analytic)
            self._wrap(mod, "autograd_value_and_grad", self._autodiff)
            self._wrap(mod, "batched_lbfgs", self._lanes)

    def reset(self):
        self.evals = {"analytic": [], "autodiff": []}  # (seconds, value)
        self.lanes = None  # (final NLML, iterations) per lane

    def restore(self):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)

    def _wrap(self, mod, name, make):
        orig = getattr(mod, name)
        self.saved.append((mod, name, orig))
        setattr(mod, name, make(orig))

    def _timed(self, kind, fn, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.torch.cuda.synchronize()
        self.evals[kind].append((time.perf_counter() - t0, float(out[0])))
        return out

    def _analytic(self, orig):
        return lambda *a, **kw: self._timed("analytic", orig, *a, **kw)

    def _autodiff(self, orig):
        def make(fun, dtype, device):
            vg = orig(fun, dtype, device)
            return lambda x: self._timed("autodiff", vg, x)
        return make

    def _lanes(self, orig):
        def run(*a, **kw):
            x, fs, ks = orig(*a, **kw)
            self.lanes = (fs.double().cpu().tolist(), ks.cpu().tolist())
            return x, fs, ks
        return run


def one_fit(torch, ck, probe, model, name, kern, fit, grid):
    """Phase 6: one full-width fit through the model's own entry point,
    then its grid posterior; checked and printed."""
    probe.reset()
    b1 = ck.LAUNCHES["ar1_cov_fused"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    best = fit(model)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    b1 = ck.LAUNCHES["ar1_cov_fused"] - b1
    kind = "autodiff" if probe.evals["autodiff"] else "analytic"
    evals = probe.evals[kind]
    # the first evaluation is at the initial params (lane 0's start)
    f0 = evals[0][1]
    lanes, iters = probe.lanes or ([best], None)
    label = f"fit {name} {kern}"
    check(f"{label} lanes finite", all(np.isfinite(lanes)),
          f"final NLML per lane {lanes}")
    check(f"{label} NLML", best <= f0,
          f"best {best:.6f} <= initial {f0:.6f}")
    check(f"{label} params finite",
          all(bool(torch.isfinite(p).all()) for p in model.params),
          "fitted params finite")
    check(f"{label} B1", b1 > 0, f"B1 launches in the fit: {b1}")
    check(f"{label} on the card", model.X.is_cuda,
          f"the model's data on {model.X.device}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mu, var = model.predict(grid)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t1
    finite = bool(torch.isfinite(mu).all()) and bool(
        torch.isfinite(var).all())
    pos = float((var > 0).double().mean())
    check(f"{label} predict", finite and pos >= 0.999,
          f"grid posterior finite: {finite}, share var > 0 {pos:.6f} "
          "(>= 0.999)")
    times = [e[0] for e in evals]
    emit("fit", part=name, base=kern, N=int(model.X.shape[0]),
         evaluations=len(evals), eval_kind=kind, iterations=iters,
         lane_nlml=lanes, nlml_initial=f0, nlml_best=best, seconds=seconds,
         eval_seconds_sum=sum(times), eval_seconds=times,
         **{f"s_per_{kind}_eval": float(np.median(times))},
         b1_launches=b1, peak_mem_gb=peak_gb, predict_s=predict_s,
         var_pos_share=pos,
         params=[p.double().cpu().numpy().round(6).tolist()
                 for p in model.params])


def gp_unit(torch, gp, problem, params):
    """Phase 6: the single-fidelity unit at full size, rbf: value, gradient
    (B2 at F=1) and inverse-factor state, then the blocked grid posterior.
    Returns what the float64 check needs."""
    Xt, _, yt, gt, _, _ = problem
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    val, grad, state = gp.nlml_value_grad_state_inv(params, Xt, yt,
                                                    kernel="rbf", jitter=1e-6)
    mu, var = gp.predict_blocked_inv(params, state, gt, kernel="rbf")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(t).all()) for t in (val, mu, var,
                                                          *grad))
    pos = float((var > 0).double().mean())
    check("fit gp unit rbf finite", finite and pos >= 0.999,
          f"value, gradient, mu, var finite: {finite}; share var > 0 "
          f"{pos:.6f} (>= 0.999)")
    info = dict(nlml=float(val), seconds=seconds, var_pos_share=pos,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return info, grad, state


def gp_unit_check(torch, ck, problem, params, grad, state, info):
    """Phase 6: the single-fidelity unit's gradient against the plain path
    evaluated in float64 on the same Linv: componentwise <= 2e-3."""
    Xt = problem[0]
    N = Xt.shape[0]
    f64 = torch.float64
    fid0 = torch.zeros(N, dtype=torch.long, device=Xt.device)
    ref = ck.syrk_grad_fused_plain(
        state.Linv.double(), state.alpha.double(), Xt.double(), fid0,
        params.variance.double().reshape(1),
        params.lengthscales.double().reshape(1, -1),
        Xt.new_zeros(0, dtype=f64), params.noise.double().reshape(1),
        kern="rbf")
    got = (grad.log_variance, grad.log_lengthscales, grad.log_noise)
    ref = (ref[0][0], ref[1][0], ref[2][0])
    comp = max(float(((g.double() - h).abs() / h.abs()).max())
               for g, h in zip(got, ref))
    g_logvar = field_errs(got[:1], ref[:1])[0]
    check("fit gp unit rbf gradient", comp <= 2e-3,
          f"max rel err vs plain f64 {comp:.3e} (rtol 2e-3); g_logvar "
          f"normwise {g_logvar:.3e}")
    emit("fit", part="gp_unit", base="rbf", N=N, M=int(problem[3].shape[0]),
         grad_componentwise_err=comp, g_logvar_normwise_err=g_logvar,
         grad=[g.double().cpu().numpy().round(6).tolist() for g in got],
         **info)


def eval_phases(torch, ck, mf, la, cov, problem):
    """Phase 6: where one fit evaluation's time goes at full size (rbf, the
    problem's params), on CUDA events: the analytic evaluation's steps as
    ``_nlml_vg_core(inv_mode=None)`` runs them, and the autodiff
    evaluation's forward and backward."""
    Xt, ft, yt, _, _, p = problem
    v, ls, rho, nz = p.variances, p.lengthscales, p.rhos, p.noises
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
    torch.cuda.synchronize()
    ev[0].record()
    Kn = cov.mf_train_cov(v, ls, rho, nz, Xt, ft, 1e-6, "rbf")
    ev[1].record()
    L = la.chol(Kn)
    del Kn
    ev[2].record()
    alpha = la.solve_posterior(L, yt)
    la.logdet_from_chol(L)
    ev[3].record()
    Kinv = la.chol_solve_blocked(L, torch.eye(Xt.shape[0], device=Xt.device))
    del L
    ev[4].record()
    ck.grad_from_kinv(Kinv, alpha, Xt, ft, v, ls, rho, nz, "rbf")
    ev[5].record()
    del Kinv
    q = mf.MFGPParams(*(t.detach().clone().requires_grad_(True) for t in p))
    ev[6].record()
    val = mf.nlml(q, Xt, ft, yt, kernel="rbf", jitter=1e-6)
    ev[7].record()
    torch.autograd.grad(val, list(q))
    ev[8].record()
    torch.cuda.synchronize()
    names = ("assembly", "chol", "alpha_logdet", "kinv_solves",
             "contractions")
    analytic = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    autodiff = {"forward": ev[6].elapsed_time(ev[7]),
                "backward": ev[7].elapsed_time(ev[8])}
    emit("fit", part="eval_phases", base="rbf", N=int(Xt.shape[0]),
         analytic_ms=analytic, analytic_sum_ms=sum(analytic.values()),
         autodiff_ms=autodiff, autodiff_sum_ms=sum(autodiff.values()))


def fit_phase(torch, ck, mf, gp, la, cov, dev, problem):
    """Phase 6 (see the module docstring); returns the launches of the fit
    paths, counted from 0 over the fits and the single-fidelity unit."""
    from bench import _theta

    autodiff_checks(torch, mf, cov, dev)
    eval_phases(torch, ck, mf, la, cov, problem)
    Xt, ft, yt, gt, _, params = problem
    v, l, _, nz = _theta()
    f32 = torch.float32

    def sf_params():
        return gp.gp_params_from_numpy(np.log(v[2]), np.log(l[2]),
                                       np.log(nz[2]), dev, f32)

    restarts = dict(n_restarts=2, maxiter=3, tol=1e-3)
    fits = (
        ("mfgp_optimize_restarts", "rbf",
         lambda k: mf.MFGP(Xt, ft, yt, kernel=k, params=params, jitter=1e-6),
         lambda m: m.optimize_restarts(**restarts)),
        ("mfgp_optimize_restarts", "matern32",
         lambda k: mf.MFGP(Xt, ft, yt, kernel=k, params=params, jitter=1e-6),
         lambda m: m.optimize_restarts(**restarts)),
        ("mfgp_optimize", "rbf",
         lambda k: mf.MFGP(Xt, ft, yt, kernel=k, params=params, jitter=1e-6),
         lambda m: m.optimize(maxiter=3)),
        # from numpy arrays, which go to the classes' default device, the
        # card
        ("gp_optimize_restarts", "rbf",
         lambda k: gp.GP(Xt.cpu().numpy(), yt.cpu().numpy(), kernel=k,
                         params=sf_params(), jitter=1e-6),
         lambda m: m.optimize_restarts(**restarts)),
    )
    probe = FitProbe(torch, (mf, gp))
    ck.reset_launches()
    try:
        for name, kern, make, fit in fits:
            one_fit(torch, ck, probe, make(kern), name, kern, fit, gt)
    finally:
        probe.restore()
    info, grad, state = gp_unit(torch, gp, problem, sf_params())
    launches = dict(ck.LAUNCHES)
    check("fit paths launches", launches["ar1_cov_fused"] > 0
          and launches["syrk_grad_fused"] > 0,
          f"B1 and B2 launched over the fits and the GP unit: {launches}")
    gp_unit_check(torch, ck, problem, sf_params(), grad, state,
                  dict(info, launches=launches))
    return launches


def main(argv) -> int:
    if argv[:1] == ["--b1-times"] and len(argv) == 2:
        return b1_times_only(argv[1])
    if argv:
        print("usage: chip_smoke.py [--b1-times ROOT]", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from bench import BASELINE_CPU_NLML, BASELINE_CPU_NLML_MATERN32
    from mfgp_tpu_torch.models import gp
    from mfgp_tpu_torch.models import mfgp as mf
    from mfgp_tpu_torch.ops import build
    from mfgp_tpu_torch.ops import covariance as cov
    from mfgp_tpu_torch.ops import cuda_kernels as ck
    from mfgp_tpu_torch.ops import linalg as la

    # the port's precision policy (set by mfgp_tpu_torch.ops), stated here
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    log = (lib_path.parent / "build.log").read_text().splitlines()
    emit("build", seconds=time.perf_counter() - t0, library=str(lib_path),
         ptxas=[ln.strip() for ln in log
                if "registers" in ln or "spill" in ln or "Compiling" in ln],
         b1_ptxas=ptxas_report(log, "ar1_cov_kernel"))

    errs = kernel_checks(torch, ck, mf, dev)
    errs["ar1_cov_fused"] = max(errs["ar1_cov_fused"],
                                b1_checks(torch, ck, dev))

    problem = make_problem(torch, mf, dev)
    refs = {"rbf": BASELINE_CPU_NLML, "matern32": BASELINE_CPU_NLML_MATERN32}

    # the main path: both units, launch counters from 0
    ck.reset_launches()
    states = {kern: run_unit(torch, ck, mf, problem, kern, refs[kern])
              for kern in BASES}
    main_launches = dict(ck.LAUNCHES)
    check("main path launches", all(n > 0 for n in main_launches.values()),
          f"{main_launches}")

    times = {kern: unit_times(torch, ck, mf, la, cov, problem, kern,
                              states[kern]) for kern in BASES}
    del states
    fit_launches = fit_phase(torch, ck, mf, gp, la, cov, dev, problem)
    if "jax" in sys.modules:
        FAILURES.append("jax was imported")

    # bounds at the unit's shapes (rbf): B1 from its Gram's bytes and flop
    # (b1_launches); B2's N^3/3 and B3's N^2 M float32-equivalent flop at
    # the 3xTF32 rate (each reads its N x N float32 operand in far less)
    N, M = problem[0].shape[0], problem[3].shape[0]
    bounds = {"ar1_cov_fused": (times["rbf"]["ar1_cov_fused"]["bound_ms"],
                                times["rbf"]["ar1_cov_fused"]["bound_by"]),
              "syrk_grad_fused": (N ** 3 / 3 / TF32X3_FLOPS * 1e3,
                                  "operations"),
              "posterior_fused": (N * N * M / TF32X3_FLOPS * 1e3,
                                  "operations")}
    print(nvidia_smi(), flush=True)
    # no single PyTorch call computes any of the three functions, so no
    # library time (library_ms null)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_launches[name],
         "fit_launches": fit_launches[name], "max_abs_err": errs[name],
         "ms": times["rbf"][name]["ms"],
         "plain_ms": times["rbf"][name]["plain_ms"],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, src, rep in KERNELS]}), flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:",
              file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
