#!/usr/bin/env python3
"""Drive the PyTorch port's SMC path, HMC included, once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero, nothing falls
back to the CPU):

  1. device  -- a CUDA card, its name and power limit from nvidia-smi;
     the port imported, with neither jax nor autogp_tpu in sys.modules;
  2. build   -- the hand-written kernels from autogp_tpu_torch/csrc;
  3. kernel 1 (covariance assembly) against its plain PyTorch version at
     [64, 1024, 1024] f32 on 64 prior trees (ChangePoints on), lower_only
     on and off, on a masked bucket; gate: per-particle normwise relative
     error max|K - K_plain| / max|K_plain| <= 1e-5;
  4. kernel 2 (panel Cholesky + inverse, in the blocked driver) against
     the f64 factor of well-conditioned SPD batches at N = 1024 and 32
     (relative error of diag, alpha, L <= 1e-4), NaN on a non-PD input,
     and the batched LML of the 64 prior particles at N = 1024 against the
     plain f64 path (relative error <= 1e-3 where the f64 value is finite);
  5. kinv (kernels 3-4) at [64, 1024, 1024] on the phase-4 SPD batches:
     kinv_beta_strips and linv_stats_wd against the plain version in f64
     on the same f32 factor; gates: normwise relative <= 1e-4 for the
     lower K^-1 and beta, <= 1e-5 for ||L^-1||_F^2, strictly-upper blocks
     exactly 0;
  6. bwd (kernel 5) at [64, 1024, 1024] on the 64 prior trees of phase 3,
     K^-1 and beta from the kinv kernel, g = 1: against its plain version
     in f64 on the same inputs, per particle max|err| / max|ref| <= 1e-3
     for the parameter and the noise gradients; two runs bitwise equal;
  7. grad -- LmlTapeFused on the 64 prior particles at N = 1024: the value
     under grad torch.equal to the value-only LML; the z-space gradient
     against float64 CPU autograd through the plain dense path, normwise
     relative <= 1e-2 on particles whose f64 gram has condition number
     < 1e5 (the rest reported); a step along the gradient raises every
     particle's LML that stays finite; the K0 noise gradient likewise;
  8. end to end: config 4 -- GPModel(n_particles=64) on a synthetic
     N = 1024 series, fit_smc(linear_schedule(1024, .25), n_mcmc=10,
     n_hmc=10), predict at 32 future points with quantiles -- after an
     n_hmc=0 warm-up fit, with launch counters reset just before; every
     kernel entry must launch (kinv's two entries, linv_stats_wd and
     kinv_beta_strips, counted apart); finiteness, validate_particles with
     round trips,
     and a float64 CPU re-evaluation of the top particles' LMLs and
     predictions.

Before the last line it prints the card line and one JSON object with each
kernel's launches on the main path, its error, its time beside its plain
version's and a library call's (CUDA events), and its bound (the larger of
the bytes it must move over 3.35 TB/s and its operations over the card's
peak for their type); the last line is the device JSON.
"""

import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
N_MAIN, P_MAIN = 1024, 64

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores and
# HBM3 bandwidth. Special functions (exp, log, sin, reciprocal): 16
# results per clock per SM on sm_90 (NVIDIA's CUDA C++ documentation,
# arithmetic instruction throughput table) x 132 SMs x 1.98 GHz.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_SFU = 16 * 132 * 1.98e9

# FP32 operations and special-function calls per matrix element for one
# tape instruction of each node type (1..9), forward and backward, read
# off the formulas of csrc/cov_tape.cu and csrc/cov_tape_bwd.cu.
FWD_COST = {1: (0, 0), 2: (4, 0), 3: (5, 1), 4: (4, 3), 5: (6, 2),
            6: (1, 0), 7: (1, 0), 8: (10, 4), 9: (1, 0)}
BWD_COST = {1: (1, 0), 2: (10, 0), 3: (8, 0), 4: (12, 2), 5: (16, 2),
            6: (0, 0), 7: (2, 0), 8: (22, 4), 9: (1, 0)}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def bound(flops, sfu, nbytes):
    """(bound_ms, bound_by): the larger of the operation time (FP32 and
    special-function pipes, whichever is slower) and the byte time."""
    op_ms = max(flops / PEAK_F32, sfu / PEAK_SFU) * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    return ((op_ms, "operations") if op_ms >= byte_ms
            else (byte_ms, "bytes"))


def tape_cost(node_type, depth_cap, table):
    """Per-particle (flops, sfu) per element of running its tape once."""
    from autogp_tpu_torch.ops import cov
    _, ttype, _, _, tlen = cov.build_tape(node_type, depth_cap)
    out = []
    for types, n in zip(ttype.tolist(), tlen.tolist()):
        out.append(tuple(sum(table[t][k] for t in types[:n])
                         for k in (0, 1)))
    return out


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call of fn over `reps` calls (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, names, reps):
    """Mean device milliseconds per call of fn spent in the CUDA kernels
    whose names contain one of `names`, over `reps` calls
    (torch.profiler/CUPTI): the kernels alone, without their wrapper's
    host work and glue ops."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if any(n in e.key for n in names)]
    if not evs:
        fail(f"profiler saw no launches of {names}")
    return sum(e.self_device_time_total for e in evs) / reps / 1e3


def normwise_rel(a, b):
    """Per-particle max|a - b| / max|b|, then the max over particles."""
    return float(per_particle_rel(a, b).max())


def per_particle_rel(a, b):
    num = (a.double() - b.double()).abs().flatten(1).amax(1)
    den = b.double().abs().flatten(1).amax(1)
    return num / den


def main():
    if not os.path.isdir(os.path.join(ROOT, "autogp_tpu_torch")):
        fail("autogp_tpu_torch/ not found beside chip_smoke.py")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    phase("device", f"{torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    warnings.simplefilter("ignore")
    import autogp_tpu_torch as A
    from autogp_tpu_torch import config as C
    from autogp_tpu_torch import model as M
    from autogp_tpu_torch.inference import smc
    from autogp_tpu_torch.ops import _build, chol, cov, cov_vjp, kinv
    foreign = sorted(m for m in sys.modules
                     if m in ("jax", "autogp_tpu")
                     or m.startswith(("jax.", "autogp_tpu.")))
    if foreign:
        fail(f"the port imported {foreign[:5]}")

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    phase("build", f"kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s from {_build.CSRC_DIR}")

    f32, f64 = torch.float32, torch.float64
    cfg = C.GPConfig()
    tab = M.prior_tables(cfg, dev, f32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    D = cfg.depth_cap
    rng = np.random.default_rng(0)

    def grid(N, n_active):
        ts = torch.zeros(N, device=dev)
        ts[:n_active] = torch.linspace(0, 1, n_active, device=dev)
        mask = torch.zeros(N, device=dev)
        mask[:n_active] = 1.0
        return ts, mask

    # ---- 3. kernel 1 --------------------------------------------------
    nt, pz = M.sample_tree(gen, P_MAIN, tab, f32, dev)
    if not (nt == C.CHANGEPOINT).any():
        fail("no ChangePoint among the 64 prior trees")
    noise_z = torch.randn(P_MAIN, generator=gen, device=dev)
    pt = M.transform_params(nt, pz, tab)
    noise = M.transform_noise(noise_z, cfg)
    n_act = 768
    ts, mask = grid(N_MAIN, n_act)
    cov_err = 0.0
    for lower in (False, True):
        K = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, D, gram=True,
                         lower_only=lower)
        Kp = cov.cov_tape_plain(nt, pt, noise, ts, ts, mask, mask, D, True,
                                lower)
        torch.cuda.synchronize()
        err = normwise_rel(K, Kp)
        abs_err = float((K - Kp).abs().max())
        if not err <= 1e-5:
            fail(f"kernel 1 vs plain: rel {err:.3e} (lower_only={lower})")
        cov_err = max(cov_err, abs_err)
        del K, Kp
    times = {}
    for N in (32, 256, 512, 1024):
        tsn, mkn = grid(N, N * 3 // 4)

        def run():
            return cov.cov_tape(nt, pt, noise, tsn, tsn, mkn, mkn, D, True,
                                True)
        times[N] = (
            cuda_ms(torch, run, 20),
            device_ms(torch, run, ("cov_tape_kernel",), 10),
            cuda_ms(torch, lambda: cov.cov_tape_plain(
                nt, pt, noise, tsn, tsn, mkn, mkn, D, True, True), 3))
    cov_ms, cov_dev_ms, cov_plain_ms = times[N_MAIN]
    # Needed work: the tape on every active lower element; every element
    # of the [P, N, N] output written once.
    n_low = n_act * (n_act + 1) // 2
    fwd = tape_cost(nt, D, FWD_COST)
    cov_bound = bound(sum(c[0] for c in fwd) * n_low,
                      sum(c[1] for c in fwd) * n_low,
                      P_MAIN * N_MAIN * N_MAIN * 4)
    phase("kernel1", f"cov_tape ok: max normwise rel err <= 1e-5, max abs "
          f"err {cov_err:.3e}; ms (wrapper, kernel alone, plain) at "
          f"[64, N, N] lower_only by N: " + ", ".join(
              f"{N}: ({a:.4f}, {b:.4f}, {c:.4f})"
              for N, (a, b, c) in times.items())
          + f"; bound at N=1024 {cov_bound[0]:.4f} ms ({cov_bound[1]})")

    # ---- 4. kernel 2 --------------------------------------------------
    def spd(P, N):
        X = torch.randn(P, N, N, generator=gen, device=dev, dtype=f64)
        K64 = X @ X.mT / N + torch.eye(N, device=dev, dtype=f64)
        x64 = torch.randn(P, N, generator=gen, device=dev, dtype=f64)
        return K64, x64

    chol_err = 0.0
    for N in (N_MAIN, 32):
        K64, x64 = spd(P_MAIN, N)
        L, a = chol.chol_solve(torch.tril(K64).float(), x64.float())
        d, a2 = chol.chol_solve_diag(torch.tril(K64).float(), x64.float())
        torch.cuda.synchronize()
        Lr = torch.linalg.cholesky(K64)
        ar = torch.linalg.solve_triangular(Lr, x64[..., None],
                                           upper=False)[..., 0]
        dr = torch.diagonal(Lr, dim1=1, dim2=2)
        errs = (normwise_rel(L, Lr), normwise_rel(a, ar),
                normwise_rel(d, dr))
        if not max(errs) <= 1e-4:
            fail(f"kernel 2 driver vs f64 factor at N={N}: {errs}")
        chol_err = max(chol_err, float((L.double() - Lr).abs().max()))
        Kbad = torch.tril(K64).float()
        Kbad[3, N // 2, N // 2] = -1.0
        db, ab = chol.chol_solve_diag(Kbad, x64.float())
        if not (torch.isnan(db[3]).any() and torch.isnan(ab[3]).any()
                and torch.isfinite(db[:3]).all()):
            fail(f"non-PD input at N={N} did not give NaN")
    xs_main = torch.as_tensor(rng.standard_normal(N_MAIN), dtype=f32,
                              device=dev) * mask
    lml_k = M.lml(nt, pz, noise_z, ts, xs_main, mask, cfg, tab)
    Kr = cov.cov_tape_plain(nt, pt.double(), noise.double(), ts.double(),
                            ts.double(), mask.double(), mask.double(), D,
                            True, False)
    Lr, info = torch.linalg.cholesky_ex(Kr)
    ar = torch.linalg.solve_triangular(
        Lr, (xs_main.double() * mask.double()).expand(P_MAIN, -1)[..., None],
        upper=False)[..., 0]
    lml_r = -0.5 * (mask.sum().double() * math.log(2 * math.pi)
                    + 2 * torch.log(torch.diagonal(Lr, dim1=1, dim2=2)).sum(1)
                    + (ar * ar).sum(1))
    lml_r = torch.where(info > 0, float("nan"), lml_r)
    del Kr, Lr
    fin = torch.isfinite(lml_r)
    both = fin & torch.isfinite(lml_k)
    rel = ((lml_k.double() - lml_r).abs() / lml_r.abs())[both]
    worst = int(torch.nonzero(both)[rel.argmax()]) if rel.numel() else -1
    if not (rel.numel() and float(rel.max()) <= 1e-3):
        fail(f"batched LML vs f64: worst rel {float(rel.max()):.3e} "
             f"(particle {worst})")
    n_nan = int((fin & ~torch.isfinite(lml_k)).sum())
    panel_in = torch.tril(spd(P_MAIN, 128)[0]).float()
    p_ms = cuda_ms(torch, lambda: chol.panel_factor(panel_in), 20)
    p_dev_ms = device_ms(torch, lambda: chol.panel_factor(panel_in),
                         ("chol_panel_kernel",), 10)
    p_plain_ms = cuda_ms(torch, lambda: chol.panel_factor_plain(panel_in),
                         20)
    p_lib_ms = cuda_ms(torch, lambda: torch.linalg.cholesky_ex(panel_in), 20)
    B = chol.BLOCK
    # Cholesky and triangular inverse: B^3 / 3 flops each; B square roots
    # and B reciprocals; read A, write L and L^-1.
    chol_bound = bound(P_MAIN * 2 * B ** 3 / 3, P_MAIN * 2 * B,
                       3 * P_MAIN * B * B * 4)
    drv = {}
    for N in (32, 256, 512, 1024):
        K64, x64 = spd(P_MAIN, N)
        Kf, xf = torch.tril(K64).float(), x64.float()

        def lib_chol():
            Lx, _ = torch.linalg.cholesky_ex(Kf)
            return torch.linalg.solve_triangular(Lx, xf[..., None],
                                                 upper=False)
        drv[N] = (cuda_ms(torch, lambda: chol.chol_solve_diag(Kf, xf), 10),
                  cuda_ms(torch, lib_chol, 10))
    phase("kernel2", f"chol_panel ok: driver vs f64 rel <= 1e-4 at N=1024 "
          f"and 32, NaN on non-PD; prior-particle LML at N=1024 worst rel "
          f"{float(rel.max()):.3e} (particle {worst}, {int(both.sum())} "
          f"compared, {n_nan} NaN in f32 where f64 finite, "
          f"{int((~fin).sum())} not PD in f64); panel [64,128,128] ms "
          f"(wrapper, kernel alone, plain, cholesky_ex alone) ({p_ms:.4f},"
          f" {p_dev_ms:.4f}, {p_plain_ms:.4f}, {p_lib_ms:.4f}), bound "
          f"{chol_bound[0]:.4f} ms ({chol_bound[1]}); driver diag+alpha"
          f" vs cholesky_ex+solve_triangular ms by N: " + ", ".join(
              f"{N}: ({a:.4f}, {b:.4f})" for N, (a, b) in drv.items()))

    # ---- 5. kinv (kernels 3-4) ----------------------------------------
    K64, x64 = spd(P_MAIN, N_MAIN)
    Kf, xf = torch.tril(K64).float(), x64.float()
    del K64
    d_s, a_s, wd_s, L_s = chol.chol_solve_strips(Kf, xf)
    d_v, a_v = chol.chol_solve_diag(Kf, xf)
    if not (torch.equal(d_s, d_v) and torch.equal(a_s, a_v)):
        fail("chol_solve_strips and chol_solve_diag disagree bitwise")
    Ki, beta_k, fro_k = kinv.kinv_beta_strips(a_s, wd_s, L_s)
    beta_s, fro_s = kinv.linv_stats_wd(L_s, a_s, wd_s)
    torch.cuda.synchronize()
    Kir, beta_r, fro_r = kinv.kinv_beta_plain(L_s.double(), a_s.double())
    kinv_errs = (normwise_rel(torch.tril(Ki), torch.tril(Kir)),
                 normwise_rel(beta_k, beta_r),
                 float(((fro_k.double() - fro_r) / fro_r).abs().max()))
    stats_abs = max(float((beta_s.double() - beta_r).abs().max()),
                    float((fro_s.double() - fro_r).abs().max()))
    kinv_abs = max(stats_abs, float(
        (torch.tril(Ki).double() - torch.tril(Kir)).abs().max()))
    del Kir
    Bk = min(N_MAIN, chol.BLOCK)
    blk = torch.arange(N_MAIN, device=dev) // Bk
    upper_blocks = blk[None, :] > blk[:, None]
    if not (kinv_errs[0] <= 1e-4 and kinv_errs[1] <= 1e-4
            and kinv_errs[2] <= 1e-5):
        fail(f"kinv vs f64 plain (K^-1, beta, fro): {kinv_errs}")
    if bool((Ki[:, upper_blocks] != 0).any()):
        fail("kinv: a strictly-upper block of K^-1 is not 0")
    if not (torch.equal(beta_s, beta_k) and torch.equal(fro_s, fro_k)):
        fail("linv_stats_wd and kinv_beta_strips disagree on beta / fro")
    kinv_names = ("linv_kernel", "kinv_lower_kernel", "fro_sum_kernel")
    kv_ms = cuda_ms(torch, lambda: kinv.kinv_beta_strips(a_s, wd_s, L_s), 10)
    kv_dev_ms = device_ms(torch, lambda: kinv.kinv_beta_strips(
        a_s, wd_s, L_s), kinv_names, 5)
    st_ms = cuda_ms(torch, lambda: kinv.linv_stats_wd(L_s, a_s, wd_s), 10)
    st_dev_ms = device_ms(torch, lambda: kinv.linv_stats_wd(
        L_s, a_s, wd_s), kinv_names, 5)
    kv_plain_ms = cuda_ms(torch, lambda: kinv.kinv_beta_plain(L_s, a_s), 3)
    st_plain_ms = cuda_ms(torch, lambda: kinv.linv_stats_plain(L_s, a_s), 3)

    def lib_kinv():
        Kx = torch.cholesky_inverse(L_s)
        return Kx, torch.matmul(Kx, xf[..., None])
    kv_lib_ms = cuda_ms(torch, lib_kinv, 5)
    NN = P_MAIN * N_MAIN * N_MAIN
    # Triangular inverse and L^-T L^-1: N^3 / 3 flops each (LAPACK trtri,
    # lauum); read L, Wd, alpha once, write K^-1, beta, fro once.
    kinv_bound = bound(2 * P_MAIN * N_MAIN ** 3 / 3, 0,
                       4 * (2 * NN + P_MAIN * N_MAIN * Bk + 3 * P_MAIN
                            * N_MAIN))
    stats_bound = bound(P_MAIN * N_MAIN ** 3 / 3, 0,
                        4 * (NN + P_MAIN * N_MAIN * Bk + 2 * P_MAIN * N_MAIN))
    phase("kinv", f"kinv_beta_strips and linv_stats_wd ok at [64, 1024, "
          f"1024]: vs f64 plain on the same f32 factor, normwise rel K^-1 "
          f"{kinv_errs[0]:.3e}, beta {kinv_errs[1]:.3e}, fro rel "
          f"{kinv_errs[2]:.3e} (gates 1e-4, 1e-4, 1e-5), max abs K^-1 err "
          f"{kinv_abs:.3e} (beta and fro {stats_abs:.3e}); strictly-upper "
          f"blocks 0; stats bitwise equal "
          f"across the two entries; ms kinv_beta_strips (wrapper, kernels "
          f"alone, plain, cholesky_inverse+matvec) ({kv_ms:.4f}, "
          f"{kv_dev_ms:.4f}, {kv_plain_ms:.4f}, {kv_lib_ms:.4f}), bound "
          f"{kinv_bound[0]:.4f} ms ({kinv_bound[1]}); linv_stats_wd "
          f"(wrapper, kernels alone, plain) ({st_ms:.4f}, {st_dev_ms:.4f}, "
          f"{st_plain_ms:.4f}), bound "
          f"{stats_bound[0]:.4f} ms ({stats_bound[1]})")
    del Ki, L_s, wd_s, Kf

    # ---- 6. bwd (kernel 5) --------------------------------------------
    Kc = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, D, True, True)
    _, a_c, wd_c, L_c = chol.chol_solve_strips(Kc, xs_main.expand(P_MAIN,
                                                                  -1))
    del Kc
    Ki_c, beta_c, _ = kinv.kinv_beta_strips(a_c, wd_c, L_c)
    del L_c, wd_c
    g1 = torch.ones(P_MAIN, device=dev)
    pb, nb = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, Ki_c, beta_c, g1, D)
    pb2, nb2 = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, Ki_c, beta_c, g1, D)
    torch.cuda.synchronize()
    if not (torch.equal(pb, pb2) and torch.equal(nb, nb2)):
        fail("kernel 5: two runs on the same inputs differ")

    def plain_bwd(dtype, chunk):
        outs = []
        for s in range(0, P_MAIN, chunk):
            sl = slice(s, s + chunk)
            outs.append(cov_vjp.cov_tape_bwd_plain(
                nt[sl], pt[sl].to(dtype), ts.to(dtype), mask.to(dtype),
                Ki_c[sl].to(dtype), beta_c[sl].to(dtype), g1[sl].to(dtype),
                D))
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))
    pr, nr = plain_bwd(f64, 4)
    ok_b = torch.isfinite(pr.flatten(1)).all(1) & torch.isfinite(nr)
    if int(ok_b.sum()) < P_MAIN // 2:
        fail(f"kernel 5: only {int(ok_b.sum())} particles with a finite "
             f"f64 reference")
    e_p = per_particle_rel(pb, pr)[ok_b]
    e_n = ((nb.double() - nr).abs() / nr.abs())[ok_b]
    bwd_abs = float((pb.double() - pr).abs()[ok_b].max())
    if not (float(e_p.max()) <= 1e-3 and float(e_n.max()) <= 1e-3):
        fail(f"kernel 5 vs f64 plain: worst pbar {float(e_p.max()):.3e}, "
             f"nbar {float(e_n.max()):.3e}")
    bw_ms = cuda_ms(torch, lambda: cov_vjp.cov_tape_bwd(
        nt, pt, ts, mask, Ki_c, beta_c, g1, D), 5)
    bw_dev_ms = device_ms(torch, lambda: cov_vjp.cov_tape_bwd(
        nt, pt, ts, mask, Ki_c, beta_c, g1, D),
        ("cov_tape_bwd_kernel", "cov_tape_bwd_reduce"), 3)
    t0 = time.perf_counter()
    plain_bwd(f32, 8)
    torch.cuda.synchronize()
    bw_plain_ms = (time.perf_counter() - t0) * 1e3
    # Needed work: forward and backward tape plus the cotangent (6 flops)
    # on every active lower element; read K^-1 on the active lower
    # triangle and the active beta once (padded elements are masked out).
    bwd_c = [(f[0] + b[0] + 6, f[1] + b[1]) for f, b in zip(
        fwd, tape_cost(nt, D, BWD_COST))]
    bwd_bound = bound(sum(c[0] for c in bwd_c) * n_low,
                      sum(c[1] for c in bwd_c) * n_low,
                      4 * P_MAIN * (n_low + n_act))
    phase("bwd", f"cov_tape_bwd ok at [64, 1024, 1024] ({int(ok_b.sum())} "
          f"particles with a finite f64 reference): per-particle max|err| "
          f"/ max|ref| worst pbar {float(e_p.max()):.3e} (median "
          f"{float(e_p.median()):.3e}), nbar {float(e_n.max()):.3e} (gate "
          f"1e-3), max abs pbar err {bwd_abs:.3e}; two runs bitwise equal;"
          f" ms (wrapper, kernels alone, plain f32 in chunks of 8) "
          f"({bw_ms:.4f}, {bw_dev_ms:.4f}, {bw_plain_ms:.4f}), bound "
          f"{bwd_bound[0]:.4f} ms ({bwd_bound[1]})")
    del Ki_c, pr

    # ---- 7. grad: LmlTapeFused and the K0 noise gradient ----------------
    pzg = pz.clone().requires_grad_(True)
    nzg = noise_z.clone().requires_grad_(True)
    v_g = M.lml(nt, pzg, nzg, ts, xs_main, mask, cfg, tab)
    gp, gn = torch.autograd.grad(v_g.sum(), (pzg, nzg))
    torch.cuda.synchronize()
    if not torch.equal(v_g.detach(), lml_k):
        fail("LmlTapeFused value under grad differs from the value path")
    torch.set_num_threads(os.cpu_count() or 1)
    tab64 = M.prior_tables(cfg, "cpu", f64)
    ts64, m64 = ts.double().cpu(), mask.double().cpu()
    xm64 = (xs_main.double().cpu() * m64)
    vr, gpr, gnr, conds = [], [], [], []
    for s in range(0, P_MAIN, 2):
        sl = slice(s, s + 2)
        ntc = nt[sl].cpu()
        pzc = pz[sl].double().cpu().requires_grad_(True)
        nzc = noise_z[sl].double().cpu().requires_grad_(True)
        Kd = cov.cov_tape_plain(ntc, M.transform_params(ntc, pzc, tab64),
                                M.transform_noise(nzc, cfg), ts64, ts64, m64,
                                m64, D, True, False)
        Ld, info = torch.linalg.cholesky_ex(Kd)
        ad = torch.linalg.solve_triangular(
            Ld, xm64.expand(2, -1)[..., None], upper=False)[..., 0]
        v = -0.5 * (m64.sum() * math.log(2 * math.pi)
                    + 2 * (torch.log(torch.diagonal(Ld, dim1=1, dim2=2))
                           * m64).sum(1) + (ad * ad).sum(1))
        g_p, g_n = torch.autograd.grad(v.sum(), (pzc, nzc))
        bad = info > 0
        vr.append(torch.where(bad, float("nan"), v.detach()))
        gpr.append(g_p)
        gnr.append(g_n)
        ev = torch.linalg.eigvalsh(Kd.detach())
        conds.append(torch.where(ev[:, 0] > 0, ev[:, -1] / ev[:, 0],
                                 float("inf")))
        del Kd, Ld
    vr, gpr, gnr, conds = (torch.cat(x) for x in (vr, gpr, gnr, conds))
    g_k = torch.cat([gp.flatten(1), gn[:, None]], 1).double().cpu()
    g_r = torch.cat([gpr.flatten(1), gnr[:, None]], 1)
    fin_g = (torch.isfinite(vr) & torch.isfinite(g_r).all(1)
             & torch.isfinite(g_k).all(1))
    e_g = per_particle_rel(g_k, g_r)
    well = fin_g & (conds < 1e5)
    if int(well.sum()) < 8:
        fail(f"grad: only {int(well.sum())} well-conditioned particles")
    if not float(e_g[well].max()) <= 1e-2:
        fail(f"grad vs f64 CPU autograd: worst {float(e_g[well].max()):.3e}"
             f" on a particle with cond < 1e5")
    rest = fin_g & ~well
    # A step along the gradient must raise every LML that stays finite.
    with torch.no_grad():
        gnorm = torch.sqrt((gp * gp).sum((1, 2)) + gn * gn).clamp_min(1e-9)
        p2 = pz + 1e-3 * gp / gnorm[:, None, None]
        n2 = noise_z + 1e-3 * gn / gnorm
        v1 = M.lml(nt, p2, n2, ts, xs_main, mask, cfg, tab)
    up_ok = torch.isfinite(v1) & torch.isfinite(lml_k)
    if not bool((v1[up_ok] >= lml_k[up_ok] - 1e-3).all()):
        fail("grad: a step along the gradient lowered an LML")
    K0 = M.assemble_K0(nt, pz, ts, mask, cfg, tab)
    v_n, g_n0 = M.lml_value_and_noise_grad_from_K0(K0, noise_z, xs_main,
                                                   mask, cfg)
    del K0
    e_nv = ((v_n.double().cpu() - vr).abs() / vr.abs())
    e_ng = ((g_n0.double().cpu() - gnr).abs() / gnr.abs())
    ok_n = well & torch.isfinite(v_n.cpu()) & torch.isfinite(g_n0.cpu())
    if not (float(e_nv[ok_n].max()) <= 1e-3
            and float(e_ng[ok_n].max()) <= 1e-2):
        fail(f"K0 noise gradient vs f64: value {float(e_nv[ok_n].max()):.3e}"
             f", grad {float(e_ng[ok_n].max()):.3e}")
    phase("grad", f"LmlTapeFused value under grad torch.equal to the value "
          f"path; z-space gradient vs f64 CPU autograd: worst normwise rel "
          f"{float(e_g[well].max()):.3e} (median "
          f"{float(e_g[well].median()):.3e}) on {int(well.sum())} particles with cond < 1e5 (gate 1e-2); "
          f"{int(rest.sum())} more finite with cond >= 1e5: worst "
          f"{float(e_g[rest].max()) if rest.any() else 0.0:.3e}; "
          f"{int((~fin_g).sum())} not finite; step along the gradient "
          f"raised all {int(up_ok.sum())} finite LMLs; K0 noise gradient on "
          f"{int(ok_n.sum())}: value rel {float(e_nv[ok_n].max()):.3e}, "
          f"grad rel {float(e_ng[ok_n].max()):.3e}")

    # ---- 8. end to end: config 4 --------------------------------------
    n = N_MAIN
    t_days = np.arange(n, dtype=np.float64)
    y = (0.02 * t_days + 3.0 * np.sin(2 * np.pi * t_days / 52.0)
         + 1.5 * np.sin(2 * np.pi * t_days / 13.0)
         + 0.5 * rng.standard_normal(n))
    ds_future = np.arange(n, n + 32, dtype=np.float64)
    sched = A.Schedule.linear_schedule(n, 0.25)
    A.seed(0)
    warm = A.GPModel(t_days, y, n_particles=P_MAIN)
    A.fit_smc(warm, schedule=sched, n_mcmc=1, n_hmc=0)
    A.predict(warm, ds_future, quantiles=[.1, .5, .9])
    torch.cuda.synchronize()
    del warm

    A.seed(1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    counters = {"cov_tape": (cov, "launches"),
                "chol_panel": (chol, "launches"),
                "linv_stats_wd": (kinv, "stats_launches"),
                "kinv_beta_strips": (kinv, "strips_launches"),
                "cov_tape_bwd": (cov_vjp, "launches")}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    torch.cuda.synchronize()
    ev[0].record()
    model = A.GPModel(t_days, y, n_particles=P_MAIN)
    A.fit_smc(model, schedule=sched, n_mcmc=10, n_hmc=10)
    ev[1].record()
    df = A.predict(model, ds_future, quantiles=[.1, .5, .9])
    ev[2].record()
    torch.cuda.synchronize()
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    fit_ms, pred_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path never launched: {launches}")
    rs = model.round_stats
    sweeps = sum(r["hmc_sweeps"] for r in rs)
    if sweeps <= 0:
        fail("the config-4 fit ran no HMC sweep")
    cols = ["y_mean", "y_0.1", "y_0.5", "y_0.9"]
    if len(df) != P_MAIN * 32 or not np.isfinite(df[cols].to_numpy()).all():
        fail("predict output not finite or of the wrong shape")
    p = model.particles
    w = model.particle_weights()
    if not (torch.isfinite(p.lml).all() and np.isfinite(w).all()
            and math.isfinite(model.log_marginal_likelihood_estimate())):
        fail("non-finite LML, weight or log-ML estimate")
    smc.validate_particles(p, model.config, tables=model.tables)

    # Float64 CPU re-evaluation of the 8 heaviest particles (plain path).
    alive = (p.lml > smc.BAD_LML).cpu().numpy()
    top = [i for i in np.argsort(-w) if alive[i]][:8]
    d = A.to_dict(model)
    d["kernels"] = [d["kernels"][i] for i in top]
    d["noise_zs"] = [d["noise_zs"][i] for i in top]
    d["noises"] = [d["noises"][i] for i in top]
    d["pf_state"]["log_weights"] = [d["pf_state"]["log_weights"][i]
                                    for i in top]
    ref = A.from_dict(d, device="cpu", dtype=f64)
    lml_gpu = p.lml[torch.as_tensor(top, device=dev)].double().cpu()
    lml_rel = float(((lml_gpu - ref.particles.lml).abs()
                     / ref.particles.lml.abs()).max())
    df_ref = A.predict(ref, ds_future, quantiles=[.1, .5, .9])
    got = df[cols].to_numpy().reshape(P_MAIN, 32, 4)[top]
    want = df_ref[cols].to_numpy().reshape(8, 32, 4)
    pred_err = float(np.abs(got - want).max() / (y.max() - y.min()))
    if not (lml_rel <= 1e-3 and pred_err <= 1e-3):
        fail(f"f32 card vs f64 CPU on the top particles: LML rel "
             f"{lml_rel:.3e}, predict err / y-range {pred_err:.3e}")
    phase("e2e", f"fit_smc(N={n}, P={P_MAIN}, schedule={sched}, n_mcmc=10,"
          f" n_hmc=10) {fit_ms:.1f} ms, predict(32, 3 quantiles) "
          f"{pred_ms:.1f} ms (CUDA events, after an n_hmc=0 warm-up fit); "
          f"launches {launches}; per round (step, MH accepted, HMC sweeps, "
          f"HMC parameter accepts) " + ", ".join(
              f"({r['step']}, {r['mh_accepted']}, {r['hmc_sweeps']}, "
              f"{r['hmc_accepted']})" for r in rs)
          + f"; total HMC sweeps {sweeps}; best LML "
          f"{float(p.lml.max()):.3f}, ESS "
          f"{model.effective_sample_size():.2f}, log-ML est "
          f"{model.log_marginal_likelihood_estimate():.3f}; top-8 vs f64 "
          f"CPU: LML rel {lml_rel:.3e}, predict err / y-range "
          f"{pred_err:.3e}; validate_particles ok")

    def entry(name, src, replaces, err, ms, dev_ms, plain_ms, bnd, lib_ms):
        return {"name": name, "route": "cuda",
                "source": f"autogp_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": lib_ms}

    kernels = [
        entry("cov_tape", "cov_tape.cu", "autogp_tpu/ops/cov_pallas.py:252",
              cov_err, cov_ms, cov_dev_ms, cov_plain_ms, cov_bound, None),
        entry("chol_panel", "chol_panel.cu",
              "autogp_tpu/ops/chol_pallas.py:46", chol_err, p_ms, p_dev_ms,
              p_plain_ms, chol_bound, p_lib_ms),
        entry("linv_stats_wd", "kinv.cu",
              "autogp_tpu/ops/kinv_pallas.py:73", stats_abs, st_ms,
              st_dev_ms, st_plain_ms, stats_bound, None),
        entry("kinv_beta_strips", "kinv.cu",
              "autogp_tpu/ops/kinv_pallas.py:73", kinv_abs, kv_ms, kv_dev_ms,
              kv_plain_ms, kinv_bound, kv_lib_ms),
        entry("cov_tape_bwd", "cov_tape_bwd.cu",
              "autogp_tpu/ops/cov_pallas_vjp.py:275", bwd_abs, bw_ms,
              bw_dev_ms, bw_plain_ms, bwd_bound, None),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
