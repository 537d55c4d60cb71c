#!/usr/bin/env python3
"""Drive the PyTorch port's SMC and online-forecasting paths, HMC included,
once on one NVIDIA GPU.

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
     exactly 0; reported, not gated: the same errors on the factor of the
     64 prior trees' grams (phase 6's), with the grams' condition numbers;
  6. bwd (kernel 5) at [64, 1024, 1024] on the 64 prior trees of phase 3,
     K^-1 and beta from the kinv kernel on phase 5's prior-tree factor,
     g = 1: against its plain version in f64 on the same inputs, per
     particle max|err| / max|ref| <= 1e-3 for the parameter and the noise
     gradients; two runs bitwise equal; timed there and at the config-4
     fit's shapes (N = 256, 512 and 1024 with 256 to 1024 points active);
  7. grad -- LmlTapeFused on the 64 prior particles at N = 1024: the value
     under grad torch.equal to the value-only LML; the z-space gradient
     against float64 autograd through the plain dense path, normwise
     relative <= 1e-2 on particles whose f64 gram has condition number
     < 1e5 (the rest reported); that reference runs on the card (64
     particles at N = 1024 take the host minutes) and is held to float64
     CPU autograd on the first 4 particles (<= 1e-8); a step along the gradient raises every
     particle's LML that stays finite; the K0 noise gradient likewise;
  8. end to end: config 4 -- GPModel(n_particles=64) on a synthetic
     N = 1024 series, fit_smc(linear_schedule(1024, .25), n_mcmc=10,
     n_hmc=10), predict at 32 future points with quantiles -- after an
     n_hmc=0 warm-up fit, with launch counters reset just before; every
     kernel entry must launch (kinv's two entries, linv_stats_wd and
     kinv_beta_strips, counted apart); finiteness, validate_particles with
     round trips,
     and a float64 CPU re-evaluation of the top particles' LMLs and
     predictions;
  8b. intape -- the LML gradient's in-tape L^-1 backend (INTAPE_LINV):
     (a) on phase 5's factor, linv_beta (the kinv kernel's L^-1 output)
     against the plain version in f64, normwise <= 1e-4 for L^-1, the
     strict upper exactly 0, beta and fro bitwise those of linv_stats_wd;
     kinv_beta and linv_stats (Wd by tri_inv_blocked) with phase 5's gates;
     (b) kernel 5's in-tape entry on phase 3's trees, V and beta from
     linv_beta of phase 6's factor, g = 1: against its plain version in f64
     on the same inputs, per particle <= 1e-3, two runs bitwise equal, and
     bitwise kernel 5 on kinv_beta_strips of the same factor;
     (c) LmlTapeFused with INTAPE_LINV on the 64 prior particles at N=1024:
     value torch.equal to the value path, z-space gradient against phase
     7's float64 reference, gate 1e-2 on grams of condition < 1e5; (d) the
     config-4 fit of phase 8 (same seed) with INTAPE_LINV: linv_beta and
     cov_tape_bwd_linv launch equally often, kinv_beta_strips and kernel 5
     never, linv_stats_wd does; the final LMLs torch.equal to phase 8's;
     finiteness, validate_particles and the top-8 check against float64 on
     the CPU; (e) the A/B of both backends
     (autogp_tpu_torch.scripts.bench_grad_ab) at [64, 1024, 1024], values
     equal. INTAPE_LINV is False again afterwards;
  9. kernel 6 (per-slot assembly) at [64, 1024, 1024] on the phase-3
     trees: against its plain version (normwise <= 1e-5), against the
     plain version in f64 (<= 1e-3) and bitwise against kernel 1's gram;
 10. bwd_unfused and kernel 7 (the tape backward's unfused entry and the
     per-slot backward) at [64, 1024, 1024] on the same trees and a fixed
     random non-symmetric cotangent: against the plain version in f64 on
     the same inputs, per particle max|err| / max|ref| <= 1e-3 (parameter)
     and <= 1e-5 (noise); two runs bitwise equal;
 11. dense_grad -- cov_matrix_diff + mvn_logpdf_masked_cvjp with tape=True
     and tape=False at N = 32 and N = 1024 on the 64 prior particles: the
     value torch.equal to the value path; the two forms' gradients against
     each other (<= 1e-3) and against float64 CPU autograd (gate 1e-2 on
     grams of condition < 1e5 at N = 32, where the fits take this route;
     reported with the condition numbers at N = 1024, against phase 7's
     reference); model.lml under grad
     at N = 200 (dense route, ragged last panel) likewise, and the ragged
     factorization against the f64 factor (<= 1e-4). The launches of kernels 6
     and 7 on this path are counted here;
 12. online: config 5's widths (P = 128, n_mcmc = 5, n_hmc = 5, depth cap
     5, n_exit = 1) through autogp_tpu_torch.scripts.online.main on a
     synthetic 544-point CSV (numpy seed 0: 512 train, 32 test, 100
     future points), the environment set as a user would set it and the
     schedule 1, 2, ..., 34, 64, 128, 256, 512 passed to main (the
     SCHEDULE_STEP variable gives a stride only); one gp.NNN file per step
     with finite predictions and logp_test; the unfused backward launches
     in the rounds at bucket 32 and never afterwards, the fused one the
     other way round; then add_data of 16 points, maybe_resample,
     mcmc_structure(n_mcmc=5, n_hmc=5), predict_proba, and the top-8
     check against float64 on the CPU.

Before the last line it prints the card line and one JSON object with each
kernel's launches on the main path, its error, its time beside its plain
version's and a library call's (CUDA events), and its bound: the largest
of the bytes it must move over 3.35 TB/s and its operations over the peak
of each pipe they run on (FP32 67 TFLOP/s, TF32 tensor cores 495 TFLOP/s,
special functions), with that pipe named (`pipe`); the last line is the
device JSON.
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

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, TF32
# on the tensor cores (dense) and HBM3 bandwidth. Special functions (exp,
# log, sin, reciprocal): 16 results per clock per SM on sm_90 (NVIDIA's
# CUDA C++ documentation, arithmetic instruction throughput table) x 132
# SMs x 1.98 GHz.
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
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


_T_START = time.perf_counter()
_t_phase = _T_START


def phase(name, msg):
    """Print a phase's result with the seconds it took and the script's
    seconds so far (host clock)."""
    global _t_phase
    now = time.perf_counter()
    print(f"[{name}] {msg} [{now - _t_phase:.1f} s, {now - _T_START:.1f} s "
          f"so far]", flush=True)
    _t_phase = now


def bound(flops, sfu, nbytes, tf32=0.0):
    """(bound_ms, bound_by, pipe): the largest of the times the work needs
    on each pipe it runs on -- FP32 `flops` on the CUDA cores, TF32
    `tf32` flops on the tensor cores (3xTF32 counts its three products),
    `sfu` special-function calls -- and the byte time. The pipes can run
    side by side, so the slowest one is the least time and no share of it
    reads above 100%."""
    pipes = {"fp32": flops / PEAK_F32, "tf32 tensor cores": tf32 / PEAK_TF32,
             "special functions": sfu / PEAK_SFU,
             "memory": nbytes / PEAK_BYTES}
    pipe = max(pipes, key=pipes.get)
    return (pipes[pipe] * 1e3, "bytes" if pipe == "memory" else
            "operations", pipe)


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
    host work and glue ops. Each kernel's mean time is weighted by its
    launches per call, so a launch the profiler did not record cannot
    lower the result. The profiler now and then records none of a
    kernel's launches: the profile is then taken again, and after five
    such profiles the result is NaN (printed as nan, null in the kernels
    line), which fails no phase: the wrapper's time is the one the
    contract asks for."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if any(n in e.key for n in names)]
        if all(any(n in e.key for e in evs) for n in names):
            return sum(e.self_device_time_total / e.count
                       * max(1, round(e.count / reps)) for e in evs) / 1e3
    return float("nan")


def normwise_rel(a, b):
    """Per-particle max|a - b| / max|b|, then the max over particles."""
    return float(per_particle_rel(a, b).max())


def per_particle_rel(a, b):
    num = (a.double() - b.double()).abs().flatten(1).amax(1)
    den = b.double().abs().flatten(1).amax(1)
    return num / den


def top8_vs_f64_cpu(A, np, torch, model, df, ds_pred, quantiles, y_range):
    """Re-evaluate the 8 heaviest live particles of `model` in float64 on
    the CPU (plain path): (LML rel err, prediction err / y range) against
    the card's LMLs and the predictions `df` of A.predict(model, ds_pred,
    quantiles)."""
    from autogp_tpu_torch.inference import smc
    p = model.particles
    P, n_pred = model.num_particles, len(ds_pred)
    w = model.particle_weights()
    alive = (p.lml > smc.BAD_LML).cpu().numpy()
    top = [i for i in np.argsort(-w) if alive[i]][:8]
    d = A.to_dict(model)
    for key in ("kernels", "noise_zs", "noises"):
        d[key] = [d[key][i] for i in top]
    d["pf_state"]["log_weights"] = [d["pf_state"]["log_weights"][i]
                                    for i in top]
    ref = A.from_dict(d, device="cpu", dtype=torch.float64)
    lml_gpu = p.lml[torch.as_tensor(top, device=p.lml.device)].double().cpu()
    lml_rel = float(((lml_gpu - ref.particles.lml).abs()
                     / ref.particles.lml.abs()).max())
    cols = ["y_mean"] + [f"y_{q}" for q in quantiles]
    df_ref = A.predict(ref, ds_pred, quantiles=quantiles)
    got = df[cols].to_numpy().reshape(P, n_pred, len(cols))[top]
    want = df_ref[cols].to_numpy().reshape(len(top), n_pred, len(cols))
    return lml_rel, float(np.abs(got - want).max() / y_range)


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
        L_s, a_s, wd_s), ("linv_kernel", "fro_sum_kernel"), 5)
    kv_plain_ms = cuda_ms(torch, lambda: kinv.kinv_beta_plain(L_s, a_s), 3)
    st_plain_ms = cuda_ms(torch, lambda: kinv.linv_stats_plain(L_s, a_s), 3)

    def lib_kinv():
        Kx = torch.cholesky_inverse(L_s)
        return Kx, torch.matmul(Kx, xf[..., None])
    kv_lib_ms = cuda_ms(torch, lib_kinv, 5)
    NN = P_MAIN * N_MAIN * N_MAIN
    # Triangular inverse and L^-T L^-1: N^3 / 3 flops each (LAPACK trtri,
    # lauum). The inverse runs on the tensor cores in 3xTF32 (three TF32
    # products for each FP32 one), L^-T L^-1 on the FP32 pipe. Read L, Wd,
    # alpha once, write K^-1, beta, fro once.
    sub_tf32 = 3 * P_MAIN * N_MAIN ** 3 / 3
    kinv_bound = bound(P_MAIN * N_MAIN ** 3 / 3, 0,
                       4 * (2 * NN + P_MAIN * N_MAIN * Bk + 3 * P_MAIN
                            * N_MAIN), tf32=sub_tf32)
    stats_bound = bound(0, 0, 4 * (NN + P_MAIN * N_MAIN * Bk + 2 * P_MAIN
                                   * N_MAIN), tf32=sub_tf32)
    # Reported, not gated: the same entry on the factor of phase 6, the
    # 64 prior trees' grams at N = 1024 (768 points active), whose
    # conditioning is real; condition numbers from the float64 gram.
    Kc = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, D, True, True)
    _, a_c, wd_c, L_c = chol.chol_solve_strips(Kc, xs_main.expand(P_MAIN,
                                                                  -1))
    del Kc
    Ki_c, beta_c, fro_c = kinv.kinv_beta_strips(a_c, wd_c, L_c)
    Kir, beta_r2, fro_r2 = kinv.kinv_beta_plain(L_c.double(), a_c.double())
    prior_errs = torch.stack([
        per_particle_rel(torch.tril(Ki_c), torch.tril(Kir)),
        per_particle_rel(beta_c, beta_r2),
        ((fro_c.double() - fro_r2) / fro_r2).abs()], 1).cpu()
    del Kir
    K64 = cov.cov_tape_plain(nt, pt.double(), noise.double(), ts.double(),
                             ts.double(), mask.double(), mask.double(), D,
                             True, False)
    ev = torch.linalg.eigvalsh(K64)
    cond_c = torch.where(ev[:, 0] > 0, ev[:, -1] / ev[:, 0],
                         float("inf")).cpu()
    del K64, ev
    fin_c = torch.isfinite(prior_errs).all(1)
    well_c = fin_c & (cond_c < 1e5)

    def worst(sel):
        return ", ".join(f"{float(prior_errs[sel, i].max()):.3e}"
                         if sel.any() else "none" for i in range(3))
    prior_msg = (f"on the prior trees' factor (phase 6; reported, not "
                 f"gated): worst K^-1, beta, fro rel on {int(well_c.sum())}"
                 f" particles with cond < 1e5: {worst(well_c)}; on the "
                 f"{int((fin_c & ~well_c).sum())} with cond >= 1e5: "
                 f"{worst(fin_c & ~well_c)}; {int((~fin_c).sum())} not "
                 f"finite; cond min / median / max "
                 f"{float(cond_c.min()):.3e} / "
                 f"{float(cond_c.median()):.3e} / {float(cond_c.max()):.3e}")
    phase("kinv", f"kinv_beta_strips and linv_stats_wd ok at [64, 1024, "
          f"1024]: vs f64 plain on the same f32 factor, normwise rel K^-1 "
          f"{kinv_errs[0]:.3e}, beta {kinv_errs[1]:.3e}, fro rel "
          f"{kinv_errs[2]:.3e} (gates 1e-4, 1e-4, 1e-5), max abs K^-1 err "
          f"{kinv_abs:.3e} (beta and fro {stats_abs:.3e}); strictly-upper "
          f"blocks 0; stats bitwise equal "
          f"across the two entries; {prior_msg}; ms kinv_beta_strips "
          f"(wrapper, kernels "
          f"alone, plain, cholesky_inverse+matvec) ({kv_ms:.4f}, "
          f"{kv_dev_ms:.4f}, {kv_plain_ms:.4f}, {kv_lib_ms:.4f}), bound "
          f"{kinv_bound[0]:.4f} ms ({kinv_bound[2]}); linv_stats_wd "
          f"(wrapper, kernels alone, plain) ({st_ms:.4f}, {st_dev_ms:.4f}, "
          f"{st_plain_ms:.4f}), bound "
          f"{stats_bound[0]:.4f} ms ({stats_bound[2]})")
    del Ki, Kf

    # ---- 6. bwd (kernel 5), on phase 5's prior-tree factor ---------------
    g1 = torch.ones(P_MAIN, device=dev)
    pb, nb = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, Ki_c, beta_c, g1, D)
    pb2, nb2 = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, Ki_c, beta_c, g1, D)
    torch.cuda.synchronize()
    if not (torch.equal(pb, pb2) and torch.equal(nb, nb2)):
        fail("kernel 5: two runs on the same inputs differ")

    def plain_bwd(dtype, chunk, kinv_lower, beta_):
        outs = []
        for s in range(0, P_MAIN, chunk):
            sl = slice(s, s + chunk)
            outs.append(cov_vjp.cov_tape_bwd_plain(
                nt[sl], pt[sl].to(dtype), ts.to(dtype), mask.to(dtype),
                kinv_lower[sl].to(dtype), beta_[sl].to(dtype),
                g1[sl].to(dtype), D))
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))
    pr, nr = plain_bwd(f64, 4, Ki_c, beta_c)
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
        ("cov_tape_bwd_kernel", "reduce_tiles_kernel"), 3)
    t0 = time.perf_counter()
    plain_bwd(f32, 8, Ki_c, beta_c)
    torch.cuda.synchronize()
    bw_plain_ms = (time.perf_counter() - t0) * 1e3
    # The fit's own shapes: its buckets and active points (config 4).
    bw_fit = {}
    for N, a in ((256, 256), (512, 512), (1024, 256), (1024, 512),
                 (1024, 768), (1024, 1024)):
        tsn, mkn = grid(N, a)
        Kn = cov.cov_tape(nt, pt, noise, tsn, tsn, mkn, mkn, D, True, True)
        _, an, wdn, Ln = chol.chol_solve_strips(
            Kn, (xs_main[:N] * mkn).expand(P_MAIN, -1))
        Kin, bn, _ = kinv.kinv_beta_strips(an, wdn, Ln)
        del Kn, Ln, wdn

        def run_fit_bwd():
            return cov_vjp.cov_tape_bwd(nt, pt, tsn, mkn, Kin, bn, g1, D)
        bw_fit[(N, a)] = (cuda_ms(torch, run_fit_bwd, 5), device_ms(
            torch, run_fit_bwd, ("cov_tape_bwd_kernel",
                                 "reduce_tiles_kernel"), 3))
        del Kin
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
          f"{bwd_bound[0]:.4f} ms ({bwd_bound[1]}); ms (wrapper, kernels "
          f"alone) at the fit's [64, N, N] with n points active by (N, n): "
          + ", ".join(f"({N}, {a}): ({w:.4f}, {k:.4f})"
                      for (N, a), (w, k) in bw_fit.items()))
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
    tab64_card = M.prior_tables(cfg, dev, f64)

    def f64_reference(ts_, xs_, mask_, chunk, ref_dev="cpu", count=P_MAIN):
        """(LML [count], z-space gradient [count, 3M + 1], condition number
        [count]) of the first `count` prior particles by float64 autograd
        through the plain dense path on `ref_dev`; returned on the CPU."""
        tab_r = tab64 if ref_dev == "cpu" else tab64_card
        ts64, m64 = ts_.double().to(ref_dev), mask_.double().to(ref_dev)
        xm64 = xs_.double().to(ref_dev) * m64
        vr, gr, conds = [], [], []
        for s in range(0, count, chunk):
            sl = slice(s, min(s + chunk, count))
            ntc = nt[sl].to(ref_dev)
            pzc = pz[sl].double().to(ref_dev).requires_grad_(True)
            nzc = noise_z[sl].double().to(ref_dev).requires_grad_(True)
            Kd = cov.cov_tape_plain(
                ntc, M.transform_params(ntc, pzc, tab_r),
                M.transform_noise(nzc, cfg), ts64, ts64, m64, m64, D, True,
                False)
            Ld, info = torch.linalg.cholesky_ex(Kd)
            ad = torch.linalg.solve_triangular(
                Ld, xm64.expand(len(ntc), -1)[..., None],
                upper=False)[..., 0]
            v = -0.5 * (m64.sum() * math.log(2 * math.pi)
                        + 2 * (torch.log(torch.diagonal(Ld, dim1=1, dim2=2))
                               * m64).sum(1) + (ad * ad).sum(1))
            g_p, g_n = torch.autograd.grad(v.sum(), (pzc, nzc))
            vr.append(torch.where(info > 0, float("nan"), v.detach()).cpu())
            gr.append(torch.cat([g_p.flatten(1), g_n[:, None]], 1).cpu())
            ev = torch.linalg.eigvalsh(Kd.detach())
            conds.append(torch.where(ev[:, 0] > 0, ev[:, -1] / ev[:, 0],
                                     float("inf")).cpu())
            del Kd, Ld
        return torch.cat(vr), torch.cat(gr), torch.cat(conds)

    # At N = 1024 the plain path in float64 takes the host minutes for 64
    # particles, so the reference runs on the card (the same plain PyTorch
    # code, no hand-written kernel in it) and is anchored to float64 CPU
    # autograd on the first 4 particles.
    vr, g_r, conds = f64_reference(ts, xs_main, mask, 4, dev)
    vr_c, g_r_c, _ = f64_reference(ts, xs_main, mask, 2, "cpu", count=4)
    fin_c = (torch.isfinite(vr_c) & torch.isfinite(g_r_c).all(1)
             & (conds[:4] < 1e5))
    anchor = max(float(per_particle_rel(g_r[:4], g_r_c)[fin_c].max()),
                 float(((vr[:4] - vr_c).abs() / vr_c.abs())[fin_c].max())
                 ) if fin_c.any() else float("nan")
    if not anchor <= 1e-8:
        fail(f"grad: float64 reference on the card vs float64 CPU autograd "
             f"on {int(fin_c.sum())} of the first 4 particles: {anchor:.3e}")
    gnr = g_r[:, -1]
    g_k = torch.cat([gp.flatten(1), gn[:, None]], 1).double().cpu()
    fin_g = (torch.isfinite(vr) & torch.isfinite(g_r).all(1)
             & torch.isfinite(g_k).all(1))
    e_g = per_particle_rel(g_k, g_r)
    well = fin_g & (conds < 1e5)
    if int(well.sum()) < 8:
        fail(f"grad: only {int(well.sum())} well-conditioned particles")
    if not float(e_g[well].max()) <= 1e-2:
        fail(f"grad vs f64 autograd: worst {float(e_g[well].max()):.3e}"
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
          f"path; z-space gradient vs float64 autograd through the plain "
          f"path on the card (which agrees with float64 CPU autograd on the "
          f"first 4 particles to {anchor:.3e}, gate 1e-8): worst normwise rel "
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

    lml_rel, pred_err = top8_vs_f64_cpu(A, np, torch, model, df, ds_future,
                                        [.1, .5, .9], y.max() - y.min())
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

    rs8, fit_ms8, lml8 = rs, fit_ms, p.lml.clone()
    del model, df

    # ---- 8b. intape: the in-tape L^-1 backend --------------------------
    from autogp_tpu_torch import gp_math
    from autogp_tpu_torch.scripts import bench_grad_ab
    # (a) kinv's L^-1 output and the entries without Wd, phase 5's factor;
    # the launches of kinv_beta and linv_stats are counted here (their
    # path: only scripts and tests call them in the reference).
    for attr in ("kinv_beta_launches", "linv_stats_launches"):
        setattr(kinv, attr, 0)
    V_s, beta_v, fro_v = kinv.linv_beta(L_s, a_s, wd_s)
    Ki_k, beta_kb, fro_kb = kinv.kinv_beta(L_s, a_s)
    beta_ls, fro_ls = kinv.linv_stats(L_s, a_s)
    torch.cuda.synchronize()
    wd_launches = {"kinv_beta": kinv.kinv_beta_launches,
                   "linv_stats": kinv.linv_stats_launches}
    Vr = kinv.linv_plain(L_s.double())
    Kir = gp_math.kinv_from_linv(Vr)

    def stats_errs(b, f):
        return (normwise_rel(b, beta_r),
                float(((f.double() - fro_r) / fro_r).abs().max()),
                max(float((b.double() - beta_r).abs().max()),
                    float((f.double() - fro_r).abs().max())))
    lb_errs = (normwise_rel(V_s, Vr), *stats_errs(beta_v, fro_v))
    lb_abs = max(lb_errs[3], float((V_s.double() - Vr).abs().max()))
    kb_errs = (normwise_rel(torch.tril(Ki_k), torch.tril(Kir)),
               *stats_errs(beta_kb, fro_kb))
    kb_abs = max(kb_errs[3], float(
        (torch.tril(Ki_k).double() - torch.tril(Kir)).abs().max()))
    ls_errs = stats_errs(beta_ls, fro_ls)
    wd_dev = normwise_rel(kinv.factor_wd(L_s), wd_s)
    del Vr, Kir
    for name, e in (("linv_beta", lb_errs), ("kinv_beta", kb_errs),
                    ("linv_stats", (0.0, *ls_errs))):
        if not (e[0] <= 1e-4 and e[1] <= 1e-4 and e[2] <= 1e-5):
            fail(f"{name} vs f64 plain (matrix, beta, fro): {e[:3]}")
    if bool(torch.triu(V_s, 1).any()):
        fail("linv_beta: L^-1 is not 0 above the diagonal")
    if bool((Ki_k[:, upper_blocks] != 0).any()):
        fail("kinv_beta: a strictly-upper block of K^-1 is not 0")
    if not (torch.equal(beta_v, beta_s) and torch.equal(fro_v, fro_s)):
        fail("linv_beta and linv_stats_wd disagree on beta / fro")
    if not (torch.equal(beta_kb, beta_ls) and torch.equal(fro_kb, fro_ls)):
        fail("kinv_beta and linv_stats disagree on beta / fro")
    del V_s, Ki_k
    eye_n = torch.eye(N_MAIN, device=dev).expand_as(L_s)

    def lib_linv():
        X = torch.linalg.solve_triangular(L_s, eye_n, upper=False)
        return X, torch.matmul(X.mT, a_s[..., None])
    lin_names = ("linv_kernel", "fro_sum_kernel")
    lib_linv_ms = cuda_ms(torch, lib_linv, 5)
    lb_ms = cuda_ms(torch, lambda: kinv.linv_beta(L_s, a_s, wd_s), 10)
    lb_dev_ms = device_ms(torch, lambda: kinv.linv_beta(L_s, a_s, wd_s),
                          lin_names, 5)
    lb_plain_ms = cuda_ms(torch, lambda: kinv.linv_beta_plain(L_s, a_s), 3)
    kb_ms = cuda_ms(torch, lambda: kinv.kinv_beta(L_s, a_s), 10)
    kb_dev_ms = device_ms(torch, lambda: kinv.kinv_beta(L_s, a_s),
                          kinv_names, 5)
    ls_ms = cuda_ms(torch, lambda: kinv.linv_stats(L_s, a_s), 10)
    ls_dev_ms = device_ms(torch, lambda: kinv.linv_stats(L_s, a_s),
                          lin_names, 5)
    # L^-1 out: read L, Wd, alpha, write L^-1, beta, fro. Without Wd the
    # B^3 / 3 flops of each diagonal-block inverse join, Wd is not read.
    # The substitution on the tensor cores (3xTF32) as in phase 5; Wd's
    # inverses (tri_inv_blocked) and L^-T L^-1 on the FP32 pipe.
    linv_bound = bound(0, 0, 4 * (2 * NN + P_MAIN * N_MAIN * Bk + 2 * P_MAIN
                                  * N_MAIN), tf32=sub_tf32)
    wd_flops = P_MAIN * N_MAIN * Bk ** 2 / 3
    kinvb_bound = bound(P_MAIN * N_MAIN ** 3 / 3 + wd_flops, 0,
                        4 * (2 * NN + 2 * P_MAIN * N_MAIN), tf32=sub_tf32)
    statsb_bound = bound(wd_flops, 0, 4 * (NN + 2 * P_MAIN * N_MAIN),
                         tf32=sub_tf32)
    intape_msgs = [
        f"(a) at [64, 1024, 1024] vs f64 plain on the same f32 factor "
        f"(matrix, beta, fro; gates 1e-4, 1e-4, 1e-5): linv_beta "
        f"{lb_errs[0]:.3e}, {lb_errs[1]:.3e}, {lb_errs[2]:.3e} (max abs "
        f"{lb_abs:.3e}), strict upper 0, beta and fro bitwise "
        f"linv_stats_wd's; kinv_beta {kb_errs[0]:.3e}, {kb_errs[1]:.3e}, "
        f"{kb_errs[2]:.3e} (max abs {kb_abs:.3e}), strictly-upper blocks 0;"
        f" linv_stats {ls_errs[0]:.3e}, {ls_errs[1]:.3e} (max abs "
        f"{ls_errs[2]:.3e}), bitwise kinv_beta's stats; Wd by "
        f"tri_inv_blocked vs the panel kernel's: normwise {wd_dev:.3e}; ms "
        f"(wrapper, kernels alone, plain, library) linv_beta ({lb_ms:.4f}, "
        f"{lb_dev_ms:.4f}, {lb_plain_ms:.4f}, {lib_linv_ms:.4f} "
        f"solve_triangular+matvec), bound {linv_bound[0]:.4f} "
        f"({linv_bound[2]}); kinv_beta ({kb_ms:.4f}, {kb_dev_ms:.4f}, "
        f"{kv_plain_ms:.4f}, {kv_lib_ms:.4f} cholesky_inverse+matvec), "
        f"bound {kinvb_bound[0]:.4f} ({kinvb_bound[2]}); linv_stats "
        f"({ls_ms:.4f}, {ls_dev_ms:.4f}, {st_plain_ms:.4f}, "
        f"{lib_linv_ms:.4f}), bound {statsb_bound[0]:.4f} "
        f"({statsb_bound[2]})"]
    del L_s, wd_s, eye_n

    # (b) kernel 5's in-tape entry on phase 3's trees, phase 6's factor.
    V_c, beta_vc, _ = kinv.linv_beta(L_c, a_c, wd_c)
    del L_c, wd_c
    pl, nl = cov_vjp.cov_tape_bwd_linv(nt, pt, ts, mask, V_c, beta_vc, g1, D)
    pl2, nl2 = cov_vjp.cov_tape_bwd_linv(nt, pt, ts, mask, V_c, beta_vc, g1,
                                         D)
    torch.cuda.synchronize()
    if not (torch.equal(pl, pl2) and torch.equal(nl, nl2)):
        fail("kernel 5c: two runs on the same inputs differ")
    Kv64 = gp_math.kinv_from_linv(V_c.double())
    pr, nr = plain_bwd(f64, 4, Kv64, beta_vc)
    ok_l = torch.isfinite(pr.flatten(1)).all(1) & torch.isfinite(nr)
    if int(ok_l.sum()) < P_MAIN // 2:
        fail(f"kernel 5c: only {int(ok_l.sum())} particles with a finite "
             f"f64 reference")
    e_pl = per_particle_rel(pl, pr)[ok_l]
    e_nl = ((nl.double() - nr).abs() / nr.abs())[ok_l]
    lt_abs = float((pl.double() - pr).abs()[ok_l].max())
    if not (float(e_pl.max()) <= 1e-3 and float(e_nl.max()) <= 1e-3):
        fail(f"kernel 5c vs f64 plain: worst pbar {float(e_pl.max()):.3e}, "
             f"nbar {float(e_nl.max()):.3e}")
    del Kv64, pr
    vs5 = max(float(per_particle_rel(pl, pb)[ok_l].max()),
              float(((nl.double() - nb).abs() / nb.double().abs())[ok_l]
                    .max()))
    eq5 = torch.equal(pl, pb) and torch.equal(nl, nb)
    if not eq5:
        fail(f"kernel 5c is not bitwise kernel 5 on the same factor "
             f"(max rel {vs5:.3e})")

    def run_linv():
        return cov_vjp.cov_tape_bwd_linv(nt, pt, ts, mask, V_c, beta_vc, g1,
                                         D)
    lt_ms = cuda_ms(torch, run_linv, 5)
    lt_dev_ms = device_ms(torch, run_linv,
                          ("cov_tape_bwd_kernel", "reduce_tiles_kernel"), 3)
    t0 = time.perf_counter()
    for s_ in range(0, P_MAIN, 8):
        sl = slice(s_, s_ + 8)
        cov_vjp.cov_tape_bwd_plain(nt[sl], pt[sl], ts, mask,
                                   gp_math.kinv_from_linv(V_c[sl]),
                                   beta_vc[sl], g1[sl], D)
    torch.cuda.synchronize()
    lt_plain_ms = (time.perf_counter() - t0) * 1e3
    del V_c
    # Needed work: kernel 5's, plus the active lower triangle of K^-1 from
    # L^-1: sum over active i of (i + 1) (n - i) products, i.e.
    # n (n + 1) (n + 2) / 3 flops per particle; the active lower triangle
    # of L^-1 and the active beta read once.
    ktile_flops = P_MAIN * n_act * (n_act + 1) * (n_act + 2) / 3
    linv_bwd_bound = bound(sum(c[0] for c in bwd_c) * n_low + ktile_flops,
                           sum(c[1] for c in bwd_c) * n_low,
                           4 * P_MAIN * (n_low + n_act))
    intape_msgs.append(
        f"(b) cov_tape_bwd_linv vs f64 plain on the same V, beta "
        f"({int(ok_l.sum())} particles): worst pbar {float(e_pl.max()):.3e} "
        f"(median {float(e_pl.median()):.3e}), nbar {float(e_nl.max()):.3e} "
        f"(gate 1e-3), max abs pbar err {lt_abs:.3e}; two runs bitwise "
        f"equal; bitwise kernel 5 on kinv_beta_strips of the same factor; "
        f"ms (wrapper, kernels alone, "
        f"plain f32 in chunks of 8) ({lt_ms:.4f}, {lt_dev_ms:.4f}, "
        f"{lt_plain_ms:.4f}), bound {linv_bwd_bound[0]:.4f} ms "
        f"({linv_bwd_bound[1]})")

    # (c) LmlTapeFused with the in-tape backend, against phase 7.
    cov_vjp.INTAPE_LINV = True
    try:
        pzg = pz.clone().requires_grad_(True)
        nzg = noise_z.clone().requires_grad_(True)
        v_i = M.lml(nt, pzg, nzg, ts, xs_main, mask, cfg, tab)
        gp_i, gn_i = torch.autograd.grad(v_i.sum(), (pzg, nzg))
        torch.cuda.synchronize()
        if not torch.equal(v_i.detach(), lml_k):
            fail("intape: LmlTapeFused value under grad differs from the "
                 "value path")
        g_i = torch.cat([gp_i.flatten(1), gn_i[:, None]], 1).double().cpu()
        fin_i = (torch.isfinite(vr) & torch.isfinite(g_r).all(1)
                 & torch.isfinite(g_i).all(1))
        well_i = fin_i & (conds < 1e5)
        e_i = per_particle_rel(g_i, g_r)
        if int(well_i.sum()) < 8 or not float(e_i[well_i].max()) <= 1e-2:
            fail(f"intape grad vs f64 autograd: worst "
                 f"{float(e_i[well_i].max()):.3e} on {int(well_i.sum())} "
                 f"particles with cond < 1e5")
        both_i = fin_i & torch.isfinite(g_k).all(1)
        vs_k = float(per_particle_rel(g_i[both_i], g_k[both_i]).max())
        intape_msgs.append(
            f"(c) LmlTapeFused value torch.equal to the value path; "
            f"gradient vs f64 autograd worst {float(e_i[well_i].max()):.3e} "
            f"(median {float(e_i[well_i].median()):.3e}) on "
            f"{int(well_i.sum())} particles with cond < 1e5 (gate 1e-2); vs "
            f"phase 7's gradient {vs_k:.3e} (bitwise equal: "
            f"{torch.equal(g_i, g_k)})")

        # (d) the config-4 fit of phase 8 on the in-tape backend.
        A.seed(1)
        counters_i = {"cov_tape": (cov, "launches"),
                      "chol_panel": (chol, "launches"),
                      "linv_stats_wd": (kinv, "stats_launches"),
                      "linv_beta": (kinv, "linv_beta_launches"),
                      "cov_tape_bwd_linv": (cov_vjp, "linv_launches"),
                      "kinv_beta_strips": (kinv, "strips_launches"),
                      "cov_tape_bwd": (cov_vjp, "launches")}
        for mod, attr in counters_i.values():
            setattr(mod, attr, 0)
        torch.cuda.synchronize()
        ev[0].record()
        model = A.GPModel(t_days, y, n_particles=P_MAIN)
        A.fit_smc(model, schedule=sched, n_mcmc=10, n_hmc=10)
        ev[1].record()
        df = A.predict(model, ds_future, quantiles=[.1, .5, .9])
        ev[2].record()
        torch.cuda.synchronize()
        launches_i = {k: getattr(mod, attr)
                      for k, (mod, attr) in counters_i.items()}
    finally:
        cov_vjp.INTAPE_LINV = False
    fit_ms_i, pred_ms_i = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    if not torch.equal(model.particles.lml, lml8):
        fail("intape fit: final LMLs are not torch.equal to phase 8's")
    li = launches_i
    if not (li["linv_beta"] > 0 and li["linv_beta"] == li["cov_tape_bwd_linv"]
            and li["kinv_beta_strips"] == 0 and li["cov_tape_bwd"] == 0
            and min(li["linv_stats_wd"], li["cov_tape"],
                    li["chol_panel"]) > 0):
        fail(f"intape fit: launches {li}")
    if len(df) != P_MAIN * 32 or not np.isfinite(df[cols].to_numpy()).all():
        fail("intape fit: predict output not finite or of the wrong shape")
    p = model.particles
    if not (torch.isfinite(p.lml).all()
            and np.isfinite(model.particle_weights()).all()
            and math.isfinite(model.log_marginal_likelihood_estimate())):
        fail("intape fit: non-finite LML, weight or log-ML estimate")
    smc.validate_particles(p, model.config, tables=model.tables)
    lml_rel_i, pred_err_i = top8_vs_f64_cpu(A, np, torch, model, df,
                                            ds_future, [.1, .5, .9],
                                            y.max() - y.min())
    if not (lml_rel_i <= 1e-3 and pred_err_i <= 1e-3):
        fail(f"intape fit: f32 card vs f64 CPU on the top particles: LML "
             f"rel {lml_rel_i:.3e}, predict err / y-range {pred_err_i:.3e}")

    def round_line(rs_):
        return ", ".join(f"({r['step']}, {r['mh_accepted']}, "
                         f"{r['hmc_sweeps']}, {r['hmc_accepted']})"
                         for r in rs_)
    intape_msgs.append(
        f"(d) config-4 fit with INTAPE_LINV {fit_ms_i:.1f} ms (phase 8: "
        f"{fit_ms8:.1f} ms), predict {pred_ms_i:.1f} ms; launches {li}; per "
        f"round (step, MH accepted, HMC sweeps, HMC parameter accepts) "
        f"{round_line(model.round_stats)} (phase 8: {round_line(rs8)}); "
        f"final LMLs torch.equal to phase 8's; top-8 vs f64 CPU: LML rel "
        f"{lml_rel_i:.3e}, predict err / y-range {pred_err_i:.3e}; "
        f"validate_particles ok")
    launches_intape = li
    del model, df

    # (e) the A/B of the two backends.
    ab = bench_grad_ab.run(N=N_MAIN, P=P_MAIN, reps=10, device=dev)
    if not ab["value_max_abs_diff"] == 0.0:
        fail(f"A/B: the two backends' values differ by "
             f"{ab['value_max_abs_diff']:.3e}")
    intape_msgs.append(
        f"(e) bench_grad_ab grad-LML batch [64, 1024, 1024] ms (CUDA events"
        f", turns A B B A): kinv kernel {ab['ms'][False]:.4f}, L^-1 in tape "
        f"{ab['ms'][True]:.4f}; value max|diff| {ab['value_max_abs_diff']}; "
        f"param-grad max rel diff {ab['param_grad_rel']:.3e}, noise-grad "
        f"{ab['noise_grad_rel']:.3e} ({ab['n_finite']} particles)")
    if cov_vjp.INTAPE_LINV:
        fail("intape: INTAPE_LINV was not restored")
    phase("intape", "; ".join(intape_msgs))

    # ---- 9. kernel 6: per-slot assembly -------------------------------
    def chunked(fn, chunk):
        outs = [fn(slice(s, s + chunk)) for s in range(0, P_MAIN, chunk)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)

    K6 = cov.cov_matrix(nt, pt, noise, ts, mask, D, masked=True)
    K6p = cov.cov_matrix_plain(nt, pt, noise, ts, mask, D, True)
    K1 = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, D, gram=True)
    torch.cuda.synchronize()
    slot_rel = normwise_rel(K6, K6p)
    slot_err = float((K6 - K6p).abs().max())
    slot_eq_tape = torch.equal(K6, K1)
    del K6p, K1
    K6r = chunked(lambda sl: cov.cov_matrix_plain(
        nt[sl], pt[sl].double(), noise[sl].double(), ts.double(),
        mask.double(), D, True), 8)
    slot_rel64 = normwise_rel(K6, K6r)
    del K6, K6r
    if not (slot_rel <= 1e-5 and slot_rel64 <= 1e-3 and slot_eq_tape):
        fail(f"kernel 6: vs plain {slot_rel:.3e}, vs f64 {slot_rel64:.3e}, "
             f"bitwise equal to kernel 1: {slot_eq_tape}")

    def run_slot():
        return cov.cov_matrix(nt, pt, noise, ts, mask, D, masked=True)
    slot_ms = cuda_ms(torch, run_slot, 20)
    slot_dev_ms = device_ms(torch, run_slot, ("cov_slot_kernel",), 10)
    slot_plain_ms = cuda_ms(torch, lambda: cov.cov_matrix_plain(
        nt, pt, noise, ts, mask, D, True), 3)
    # Needed work: the active nodes on every element of the active square
    # (no symmetry is used); every element of the output written once.
    n_sq = n_act * n_act
    slot_bound = bound(sum(c[0] for c in fwd) * n_sq,
                       sum(c[1] for c in fwd) * n_sq,
                       P_MAIN * N_MAIN * N_MAIN * 4)
    phase("kernel6", f"cov_slot ok at [64, 1024, 1024]: normwise rel vs "
          f"plain {slot_rel:.3e} (gate 1e-5, max abs {slot_err:.3e}), vs "
          f"plain f64 {slot_rel64:.3e} (gate 1e-3), bitwise equal to kernel "
          f"1's gram; ms (wrapper, kernel alone, plain) ({slot_ms:.4f}, "
          f"{slot_dev_ms:.4f}, {slot_plain_ms:.4f}), bound "
          f"{slot_bound[0]:.4f} ms ({slot_bound[1]})")

    # ---- 10. bwd_unfused (kernel 5b) and kernel 7 ----------------------
    kbar = torch.randn(P_MAIN, N_MAIN, N_MAIN, generator=gen, device=dev)
    pr, nr = chunked(lambda sl: cov_vjp.cov_grads_plain(
        nt[sl], pt[sl].double(), kbar[sl].double(), ts.double(),
        mask.double(), D, True), 4)
    ok_g = torch.isfinite(pr.flatten(1)).all(1) & torch.isfinite(nr)
    if int(ok_g.sum()) < P_MAIN // 2:
        fail(f"cov_grads: only {int(ok_g.sum())} particles with a finite "
             f"f64 reference")
    t0 = time.perf_counter()
    chunked(lambda sl: cov_vjp.cov_grads_plain(
        nt[sl], pt[sl], kbar[sl], ts, mask, D, True), 8)
    torch.cuda.synchronize()
    grads_plain_ms = (time.perf_counter() - t0) * 1e3
    # Needed work: forward and backward sweep of the active nodes plus the
    # mask product on every element of the active square; the active
    # square of the cotangent read once.
    given_c = [(f[0] + b[0] + 2, f[1] + b[1]) for f, b in zip(
        fwd, tape_cost(nt, D, BWD_COST))]
    given_bound = bound(sum(c[0] for c in given_c) * n_sq,
                        sum(c[1] for c in given_c) * n_sq,
                        4 * P_MAIN * n_sq)
    given = {}
    for name, fn, knames in (
            ("bwd_unfused", cov_vjp.cov_grads_tape,
             ("cov_tape_bwd_kernel", "reduce_tiles_kernel")),
            ("kernel7", cov_vjp.cov_grads,
             ("cov_slot_bwd_kernel", "reduce_tiles_kernel"))):
        def run_given():
            return fn(nt, pt, kbar, ts, mask, D, masked=True)
        pb_g, nb_g = run_given()
        pb_g2, nb_g2 = run_given()
        torch.cuda.synchronize()
        if not (torch.equal(pb_g, pb_g2) and torch.equal(nb_g, nb_g2)):
            fail(f"{name}: two runs on the same inputs differ")
        e_p = per_particle_rel(pb_g, pr)[ok_g]
        e_n = ((nb_g.double() - nr).abs() / nr.abs().clamp_min(1.0))[ok_g]
        if not (float(e_p.max()) <= 1e-3 and float(e_n.max()) <= 1e-5):
            fail(f"{name} vs f64 plain on the same cotangent: worst pbar "
                 f"{float(e_p.max()):.3e}, nbar {float(e_n.max()):.3e}")
        given[name] = (float((pb_g.double() - pr).abs()[ok_g].max()),
                       cuda_ms(torch, run_given, 5),
                       device_ms(torch, run_given, knames, 3))
        phase(name, f"{fn.__name__} ok at [64, 1024, 1024] on a random "
              f"non-symmetric cotangent ({int(ok_g.sum())} particles with a "
              f"finite f64 reference): per-particle max|err| / max|ref| "
              f"worst pbar {float(e_p.max()):.3e} (median "
              f"{float(e_p.median()):.3e}; gate 1e-3), nbar "
              f"{float(e_n.max()):.3e} (gate 1e-5), max abs pbar err "
              f"{given[name][0]:.3e}; two runs bitwise equal; ms (wrapper, "
              f"kernels alone, plain f32 in chunks of 8) "
              f"({given[name][1]:.4f}, {given[name][2]:.4f}, "
              f"{grads_plain_ms:.4f}), bound {given_bound[0]:.4f} ms "
              f"({given_bound[1]})")
    del kbar, pr

    # ---- 11. dense_grad: cov_matrix_diff + mvn_logpdf_masked_cvjp -------
    from autogp_tpu_torch import gp_math

    def dense_route(ts_, xs_, mask_, tape):
        """(LML [P], z-space gradient [P, 3M + 1]) by the dense route."""
        pzg = pz.clone().requires_grad_(True)
        nzg = noise_z.clone().requires_grad_(True)
        Kd = cov_vjp.cov_matrix_diff(
            nt, M.transform_params(nt, pzg, tab),
            M.transform_noise(nzg, cfg), ts_, mask_, D, masked=True,
            tape=tape)
        v = gp_math.mvn_logpdf_masked_cvjp(Kd, xs_, mask_, True)
        g_p, g_n = torch.autograd.grad(v.sum(), (pzg, nzg))
        return v.detach(), torch.cat([g_p.flatten(1), g_n[:, None]], 1)

    def against_f64(g_card, v_ref, g_ref, cond):
        """Normwise relative error per particle against the float64 reference
        gradient, and the masks of well- and ill-conditioned particles
        with finite values on both sides."""
        g_c = g_card.double().cpu()
        fin = (torch.isfinite(v_ref) & torch.isfinite(g_ref).all(1)
               & torch.isfinite(g_c).all(1))
        return (per_particle_rel(g_c, g_ref), fin & (cond < 1e5),
                fin & ~(cond < 1e5))

    for mod, attr in ((cov, "slot_launches"), (cov_vjp, "slot_launches"),
                      (cov_vjp, "unfused_launches")):
        setattr(mod, attr, 0)
    dense_msgs = []
    for N in (32, N_MAIN):
        if N == N_MAIN:
            ts_d, mask_d, xs_d = ts, mask, xs_main
            v_val, (v_ref, g_ref, cond) = lml_k, (vr, g_r, conds)
        else:
            ts_d, mask_d = grid(N, N * 3 // 4)
            xs_d = torch.sin(9.0 * ts_d) * mask_d
            v_val = M.lml(nt, pz, noise_z, ts_d, xs_d, mask_d, cfg, tab)
            v_ref, g_ref, cond = f64_reference(ts_d, xs_d, mask_d, 64)
        v_t, g_t = dense_route(ts_d, xs_d, mask_d, tape=True)
        v_s, g_s = dense_route(ts_d, xs_d, mask_d, tape=False)
        torch.cuda.synchronize()
        if not (torch.equal(v_t, v_val) and torch.equal(v_s, v_val)):
            fail(f"dense_grad N={N}: the value under grad differs from the "
                 f"value path")
        both = torch.isfinite(g_t).all(1) & torch.isfinite(g_s).all(1)
        forms = float(per_particle_rel(g_s[both], g_t[both]).max())
        if not forms <= 1e-3:
            fail(f"dense_grad N={N}: tape and per-slot gradients differ by "
                 f"{forms:.3e}")
        e_d, well_d, rest_d = against_f64(g_t, v_ref, g_ref, cond)
        worst_well = float(e_d[well_d].max()) if well_d.any() else 0.0
        if N == 32 and not (int(well_d.sum()) >= 8 and worst_well <= 1e-2):
            fail(f"dense_grad N=32 vs f64 CPU autograd: worst "
                 f"{worst_well:.3e} on {int(well_d.sum())} particles with "
                 f"cond < 1e5")
        dense_msgs.append(
            f"N={N}: value torch.equal to the value path for both forms; "
            f"tape vs per-slot gradient {forms:.3e} (gate 1e-3); dense "
            f"route vs f64 {'CPU autograd' if N == 32 else 'autograd on the card'}"
            f" worst {worst_well:.3e} (median "
            f"{float(e_d[well_d].median()) if well_d.any() else 0.0:.3e}) "
            f"on {int(well_d.sum())} particles with cond < 1e5 (largest "
            f"{float(cond[well_d].max()) if well_d.any() else 0.0:.3e})"
            + (" (gate 1e-2)" if N == 32 else " (reported, no gate)")
            + f", worst {float(e_d[rest_d].max()) if rest_d.any() else 0.0:.3e}"
            f" on {int(rest_d.sum())} more with cond >= 1e5")
    dense_launches = {"cov_slot": cov.slot_launches,
                      "cov_slot_bwd": cov_vjp.slot_launches}
    if min(dense_launches.values()) <= 0 or cov_vjp.unfused_launches <= 0:
        fail(f"dense_grad: a kernel of the path never launched: "
             f"{dense_launches}, unfused {cov_vjp.unfused_launches}")
    # model.lml at N = 200: the dense route with a ragged last panel.
    ts_r, mask_r = grid(200, 150)
    xs_r = torch.sin(9.0 * ts_r) * mask_r
    v_r0 = M.lml(nt, pz, noise_z, ts_r, xs_r, mask_r, cfg, tab)
    pzg = pz.clone().requires_grad_(True)
    nzg = noise_z.clone().requires_grad_(True)
    v_rg = M.lml(nt, pzg, nzg, ts_r, xs_r, mask_r, cfg, tab)
    g_rp, g_rn = torch.autograd.grad(v_rg.sum(), (pzg, nzg))
    if not torch.equal(v_rg.detach(), v_r0):
        fail("dense_grad N=200: value under grad differs from the value path")
    e_r, well_r, rest_r = against_f64(
        torch.cat([g_rp.flatten(1), g_rn[:, None]], 1),
        *f64_reference(ts_r, xs_r, mask_r, 16))
    if not (int(well_r.sum()) >= 8 and float(e_r[well_r].max()) <= 1e-2):
        fail(f"dense_grad N=200 vs f64 CPU autograd: "
             f"{float(e_r[well_r].max()):.3e}")
    K64, x64 = spd(P_MAIN, 200)
    L_r, a_r = chol.chol_solve(torch.tril(K64).float(), x64.float())
    Lr = torch.linalg.cholesky(K64)
    ar = torch.linalg.solve_triangular(Lr, x64[..., None],
                                       upper=False)[..., 0]
    ragged = (normwise_rel(L_r, Lr), normwise_rel(a_r, ar))
    if not max(ragged) <= 1e-4:
        fail(f"ragged factorization at N=200 vs f64 factor: {ragged}")
    phase("dense_grad", "; ".join(dense_msgs) + f"; model.lml under grad at "
          f"N=200 (dense route, panels 128 + 72): value torch.equal, "
          f"gradient vs f64 worst {float(e_r[well_r].max()):.3e} on "
          f"{int(well_r.sum())} with cond < 1e5 (gate 1e-2); ragged factor "
          f"at N=200 vs f64 factor: L {ragged[0]:.3e}, alpha "
          f"{ragged[1]:.3e} (gate 1e-4); launches on this path "
          f"{dense_launches}")

    # ---- 12. online: config 5's widths through the CLI ------------------
    import tempfile
    import pandas as pd
    from autogp_tpu_torch.scripts import online
    P_ON, N_TRAIN, N_TEST = 128, 512, 32
    sched_on = list(range(1, 35)) + [64, 128, 256, 512]
    rng_on = np.random.default_rng(0)
    t_on = np.arange(N_TRAIN + N_TEST, dtype=np.float64)
    y_on = (0.02 * t_on + 3.0 * np.sin(2 * np.pi * t_on / 52.0)
            + 1.5 * np.sin(2 * np.pi * t_on / 13.0)
            + 0.5 * rng_on.standard_normal(len(t_on)))
    snaps = {}
    plain_callback = online.fn_callback

    def counting_callback(*, ds_test, y_test, log_dir, plot=False, **kw):
        snaps[kw["step"]] = (cov_vjp.unfused_launches, cov_vjp.launches,
                             kw["elapsed"])
        return plain_callback(ds_test=ds_test, y_test=y_test,
                              log_dir=log_dir, plot=plot, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "series.csv")
        np.savetxt(csv, np.c_[t_on, y_on], delimiter=",")
        os.environ.update({
            "DATASET": csv, "TIMETYPE": "NUMERIC", "N_PARTICLES": str(P_ON),
            "SEED": "5", "N_MCMC": "5", "N_HMC": "5", "N_HMC_EXIT": "1",
            "MAX_DEPTH": "5", "CHANGEPOINTS": "1",
            "ADAPTIVE_RESAMPLING": "1", "SHUFFLE": "0",
            "N_TEST": str(N_TEST), "N_FUTURE": "100"})
        for mod, attr in (*counters.values(), (cov, "slot_launches"),
                          (cov_vjp, "slot_launches"),
                          (cov_vjp, "unfused_launches")):
            setattr(mod, attr, 0)
        online.fn_callback = counting_callback
        sys.stdout.flush()
        real_stdout, sys.stdout = sys.stdout, open(os.devnull, "w")
        try:
            t0 = time.perf_counter()
            m_on = online.main(schedule=sched_on,
                               log_root=os.path.join(tmp, "logs"))
            torch.cuda.synchronize()
            online_s = time.perf_counter() - t0
        finally:
            sys.stdout.close()
            sys.stdout = real_stdout
            online.fn_callback = plain_callback
        (log_dir,) = os.listdir(os.path.join(tmp, "logs"))
        log_dir = os.path.join(tmp, "logs", log_dir)
        want_files = [f"gp.{s:03d}" for s in [0] + sched_on]
        got_files = sorted(f for f in os.listdir(log_dir)
                           if f.startswith("gp."))
        if got_files != want_files:
            fail(f"online: step files {got_files} != {want_files}")
        for s_ in [0] + sched_on:
            dfs = pd.read_csv(os.path.join(log_dir, f"gp.{s_:03d}"))
            if len(dfs) != P_ON * (N_TRAIN + N_TEST + 100):
                fail(f"online: gp.{s_:03d} has {len(dfs)} rows")
            vals = dfs[["y_mean", "y_0.025", "y_0.975", "logp_test"]]
            if not np.isfinite(vals.to_numpy()).all():
                fail(f"online: gp.{s_:03d} holds non-finite predictions")
            if s_ > 0 and not (dfs["logp_test"] != 0).all():
                fail(f"online: gp.{s_:03d} has no logp_test")
    if m_on.device.type != "cuda" or m_on.num_particles != P_ON:
        fail("online: the CLI's model is not the 128-particle CUDA model")
    # The gradient route by round: unfused at bucket 32, fused afterwards.
    rs_on = m_on.round_stats
    prev = snaps[0]
    step_s = {}
    for r in rs_on:
        cur = snaps[r["step"]]
        d_unf, d_fus = cur[0] - prev[0], cur[1] - prev[1]
        step_s[r["step"]] = cur[2] - prev[2]
        small = smc.bucket_size(r["step"]) < 64
        want_unf = small and r["hmc_sweeps"] > 0
        want_fus = (not small) and r["hmc_sweeps"] > 0
        if (d_unf > 0) != want_unf or (d_fus > 0) != want_fus:
            fail(f"online: round {r['step']} (bucket "
                 f"{smc.bucket_size(r['step'])}, {r['hmc_sweeps']} HMC "
                 f"sweeps) launched unfused {d_unf}, fused {d_fus}")
        prev = cur
    unf_fit, fus_fit = prev[0], prev[1]
    if not (unf_fit > 0 and fus_fit > 0):
        fail(f"online: unfused {unf_fit} / fused {fus_fit} launches")
    s32 = [step_s[s_] for s_ in sched_on if s_ <= 32]
    fit_s = snaps[sched_on[-1]][2]
    # Streaming: 16 more points, resample, rejuvenate, score the rest.
    t0 = time.perf_counter()
    A.add_data(m_on, t_on[512:528], y_on[512:528])
    resampled_on = A.maybe_resample(m_on, P_ON / 2)
    acc_on = A.mcmc_structure(m_on, n_mcmc=5, n_hmc=5)
    proba = A.predict_proba(m_on, t_on[528:], y_on[528:])
    ds_fut_on = np.arange(544, 576, dtype=np.float64)
    df_on = A.predict(m_on, ds_fut_on, quantiles=[.025, .975])
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    online_launches = {k: getattr(mod, attr)
                       for k, (mod, attr) in counters.items()}
    online_launches["cov_tape_bwd_unfused"] = cov_vjp.unfused_launches
    if min(online_launches.values()) <= 0:
        fail(f"online: a kernel of the path never launched: "
             f"{online_launches}")
    if not (np.isfinite(proba["logp"]).all() and len(proba) == P_ON
            and torch.isfinite(m_on.particles.lml).all()
            and np.isfinite(m_on.particle_weights()).all()):
        fail("online: non-finite predict_proba, LML or weight after "
             "add_data + mcmc_structure")
    smc.validate_particles(m_on.particles, m_on.config, tables=m_on.tables)
    lml_rel_on, pred_err_on = top8_vs_f64_cpu(
        A, np, torch, m_on, df_on, ds_fut_on, [.025, .975],
        y_on.max() - y_on.min())
    if not (lml_rel_on <= 1e-3 and pred_err_on <= 1e-3):
        fail(f"online: f32 card vs f64 CPU on the top particles: LML rel "
             f"{lml_rel_on:.3e}, predict err / y-range {pred_err_on:.3e}")
    phase("online", f"online.main(P={P_ON}, n_mcmc=5, n_hmc=5, n_exit=1, "
          f"depth cap 5, schedule 1..34, 64, 128, 256, 512 passed to main; "
          f"the rest by environment variables) {online_s:.1f} s in all, "
          f"{fit_s:.1f} s of SMC work in {len(sched_on)} rounds ("
          f"{online_s - fit_s:.1f} s in {len(sched_on) + 1} callbacks and "
          f"set-up); s per round at bucket 32 median "
          f"{float(np.median(s32)):.3f} (min {min(s32):.3f}, max "
          f"{max(s32):.3f}; steps 1/8/16/24/32 "
          + "/".join(f"{step_s[s_]:.3f}" for s_ in (1, 8, 16, 24, 32))
          + "), at 64/128/256/512 "
          + "/".join(f"{step_s[s_]:.3f}" for s_ in (64, 128, 256, 512))
          + f"; {len(want_files)} step files with finite predictions and "
          f"logp_test; unfused backward launched in every bucket-32 round "
          f"with HMC sweeps ({unf_fit} launches) and in no later round, "
          f"fused in the later rounds only ({fus_fit}); HMC sweeps "
          f"{sum(r['hmc_sweeps'] for r in rs_on)}, parameter accepts "
          f"{sum(r['hmc_accepted'] for r in rs_on)}, MH accepts "
          f"{sum(r['mh_accepted'] for r in rs_on)}; then add_data(16) + "
          f"maybe_resample ({resampled_on}) + mcmc_structure(5, 5) ("
          f"{int(acc_on.sum())} accepts) + predict_proba(16) + predict(32) "
          f"{stream_s:.2f} s; launches {online_launches}; best LML "
          f"{float(m_on.particles.lml.max()):.3f}, ESS "
          f"{m_on.effective_sample_size():.2f}; top-8 vs f64 CPU: LML rel "
          f"{lml_rel_on:.3e}, predict err / y-range {pred_err_on:.3e}; "
          f"validate_particles ok")

    # Each kernel's launches are those of the path that is its own: the
    # config-4 fit (phase 8) for the first five, the online run (phase 12)
    # for the unfused backward, the dense_grad drive of cov_matrix_diff(
    # tape=False) (phase 11) for kernels 6 and 7.
    launches.update(dense_launches)
    launches["linv_beta"] = launches_intape["linv_beta"]
    launches["cov_tape_bwd_linv"] = launches_intape["cov_tape_bwd_linv"]
    launches.update(wd_launches)
    launches["cov_tape_bwd_unfused"] = online_launches[
        "cov_tape_bwd_unfused"]

    def entry(name, src, replaces, err, ms, dev_ms, plain_ms, bnd, lib_ms):
        return {"name": name, "route": "cuda",
                "source": f"autogp_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms,
                "device_ms": None if math.isnan(dev_ms) else dev_ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "pipe": bnd[2], "library_ms": lib_ms}

    kernels = [
        entry("cov_tape", "cov_tape.cu", "autogp_tpu/ops/cov_pallas.py:252",
              cov_err, cov_ms, cov_dev_ms, cov_plain_ms, cov_bound, None),
        entry("chol_panel", "chol_panel.cu",
              "autogp_tpu/ops/chol_pallas.py:46", chol_err, p_ms, p_dev_ms,
              p_plain_ms, chol_bound, p_lib_ms),
        entry("linv_stats_wd", "kinv.cu",
              "autogp_tpu/ops/kinv_pallas.py:73", stats_abs, st_ms,
              st_dev_ms, st_plain_ms, stats_bound, lib_linv_ms),
        entry("linv_beta", "kinv.cu", "autogp_tpu/ops/kinv_pallas.py:73",
              lb_abs, lb_ms, lb_dev_ms, lb_plain_ms, linv_bound,
              lib_linv_ms),
        entry("kinv_beta", "kinv.cu", "autogp_tpu/ops/kinv_pallas.py:73",
              kb_abs, kb_ms, kb_dev_ms, kv_plain_ms, kinvb_bound, kv_lib_ms),
        entry("linv_stats", "kinv.cu", "autogp_tpu/ops/kinv_pallas.py:73",
              ls_errs[2], ls_ms, ls_dev_ms, st_plain_ms, statsb_bound,
              lib_linv_ms),
        entry("kinv_beta_strips", "kinv.cu",
              "autogp_tpu/ops/kinv_pallas.py:73", kinv_abs, kv_ms, kv_dev_ms,
              kv_plain_ms, kinv_bound, kv_lib_ms),
        entry("cov_tape_bwd", "cov_tape_bwd.cu",
              "autogp_tpu/ops/cov_pallas_vjp.py:275", bwd_abs, bw_ms,
              bw_dev_ms, bw_plain_ms, bwd_bound, None),
        entry("cov_tape_bwd_linv", "cov_tape_bwd.cu",
              "autogp_tpu/ops/cov_pallas_vjp.py:275", lt_abs, lt_ms,
              lt_dev_ms, lt_plain_ms, linv_bwd_bound, None),
        entry("cov_slot", "cov_slot.cu", "autogp_tpu/ops/cov_pallas.py:386",
              slot_err, slot_ms, slot_dev_ms, slot_plain_ms, slot_bound,
              None),
        entry("cov_tape_bwd_unfused", "cov_tape_bwd.cu",
              "autogp_tpu/ops/cov_pallas_vjp.py:275",
              *given["bwd_unfused"], grads_plain_ms, given_bound, None),
        entry("cov_slot_bwd", "cov_slot_bwd.cu",
              "autogp_tpu/ops/cov_pallas_vjp.py:117", *given["kernel7"],
              grads_plain_ms, given_bound, None),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
