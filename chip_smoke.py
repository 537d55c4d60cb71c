#!/usr/bin/env python3
"""Drive the PyTorch port's SMC, online-forecasting, greedy-search,
decomposition, depth-annealing, fixed-structure HMC and particle-mesh
paths, its tutorial flows and depth caps above 8 once on one NVIDIA GPU.

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
     timed there and, beside kernel 1's full gram, at [64, 32, 32] (24
     points active: the bucket where the online run takes the dense
     route);
 10. bwd_unfused and kernel 7 (the tape backward's unfused entry and the
     per-slot backward) at [64, 1024, 1024] on the same trees and a fixed
     random non-symmetric cotangent: against the plain version in f64 on
     the same inputs, per particle max|err| / max|ref| <= 1e-3 (parameter)
     and <= 1e-5 (noise); two runs bitwise equal; kernel 7 bitwise 5b on
     the same cotangent (it compacts the heaps into 5b's tapes on the card
     and runs 5b's body); both timed there and at [64, 32, 32];
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

 13. greedy: config 3 -- fit_greedy(max_depth=3) on the 144-point
     airline series of scripts/bench_configs.py (GPConfig(changepoints=
     False, max_depth=3), seed 11, one particle; bucket 256, a batch of 32
     candidates a stage), timed with CUDA events after a warm-up fit on
     seed 12, every launch counter reset just before: kernels 1, 2, 4
     (kinv_beta_strips) and 5 must launch; the AIC non-increasing over the
     stages, validate_particles, the final LML within 1e-3 of a float64
     CPU re-evaluation, the AIC 2 (k - lml); the warm-up fit's last
     candidate batch ([32, 256, 256], 144 points active) at its start and
     its optimized parameters: model.lml and its autograd gradient on the
     card against the same function in float64 on the CPU (LML rel 1e-3;
     at the start, gradient normwise 1e-2 per lane whose float64 gram has
     condition number < 1e5), kernel 1 against its plain version (1e-5)
     and kernel 5 against its plain version in f64 on the same inputs
     (each parameter's error <= 1e-5 of the sum of its terms' magnitudes;
     at the start, per lane max|err| / max|ref| <= 1e-3, reported beside
     the plain version's in float32); then
     fit_greedy_mcmc(n_mcmc=6, n_parallel=4) from that state: AIC
     non-increasing, kernel 5 launches;
 14. decompose: decompose, extract_kernel and split_kernel_sop by
     GP.Periodic on phase 8's model -- every fragment LML of the 8
     heaviest particles that float64 finds finite on the CPU (the model
     carried over by to_dict / from_dict) finite on the card and within
     1e-3 relative (the
     fragments' LMLs are float64: kernel 1's float64 entry, held to its
     plain version at normwise 1e-12 on the largest fragment model's
     inputs) --, the largest sum-of-products component
     depth by leaf type, then predict_mvn_sum and predict_sum at phase 8's
     32 points, every launch counter reset before predict_mvn_sum: kernel
     1 must launch there; its component blocks against kernel 1's plain
     version on the same inputs (normwise 1e-5 per block); per particle
     the Y mean equals F_T + F_nT (normwise 1e-4); the 8 heaviest
     particles' means and covariances within 1e-3 (normwise) of a float64
     CPU run on the model carried over by to_dict / from_dict.
 15. depth: run_smc_anneal_depth on config 4's series (N = 1024,
     transformed as GPModel transforms it), schedule [1, 2, 3, 4, 5], P =
     64, n_mcmc = 10, n_hmc = 10, every launch counter reset just before:
     kernels 1-5 must launch; validate_particles with round trips, finite
     LMLs and normalized weights, the top 8 LMLs within 1e-3 of float64 on
     the CPU, the first extension's weights (depth 1 -> 2, normalization
     included) within 1e-3 (|lml_old| + |lml_new|) + 1e-3 of the same
     function in float64 on the CPU on the same draws; then the posterior
     oracle of tests/test_inference.py:347 at P = 4096
     (autogp_tpu_torch.scripts.depth_oracle): ESS > 40, every structure
     within 5 se + 0.03 of data-annealed SMC, total variation < 0.15
     between the two, and each within total variation 0.10 of the exact
     posterior;
 16. config2: BASELINE config 2 -- experiment_hmc.config2_sweeps (20
     sweeps at N = 500, counters reset just before, final LML within 1e-3
     of float64 on the CPU), experiment_hmc.run at its defaults (the
     Bayes-rule oracle inside at the float32 tolerance, lp_true within
     1e-3 of a float64 CPU run), kernels 1-5 at P = 1 on config 2's
     [1, 512, 512] and kernels 1 and 5 on the experiment's [1, 256, 256],
     and kernels 1 and 5 at [64, 1024, 1024] on heaps of 1, 3 and 15
     slots, against their plain versions with the gates of phases 3-6.
 17. mesh: config 4 (phase 8's series, schedule and widths, P = 64,
     predict at 32 points) fitted unsharded from seed 17, then as two
     ranks spawned from this process, each joined to a gloo group over
     TCP on localhost with its 32 particles on cuda:0, through
     GPModel(mesh=) from the same seed, every launch counter zeroed just
     before the fit in each rank: kernels 1-5 must launch in each rank;
     each rank's gathered node_type and parents equal the unsharded
     fit's, params, noise_z, log_weights, lml, log_ml_est,
     particle_weights() and predict's means and quantiles within 1e-6
     relative and every entry bitwise equal; validate_particles with
     round trips on the gathered batch; an odd P raises ValueError. A
     rank that raises, dies or outlives 300 s fails the phase. Kernels 5,
     5c, 5b and 7 on two 32-row halves and every fifth row of a [64, 1024,
     1024] batch, each given part_batch=64 (the whole batch's partition),
     torch.equal to the whole batch's rows (scripts/batch_bits.py).
 18. tutorials: the flows of autogp_tpu_torch/scripts/tutorials on
     cuda:0 -- overview, decomposition (its fragment LMLs held to float64
     on the CPU as in phase 14), callbacks and greedy_mcmc at their FAST
     settings with their own asserts; iclaims at its full reference budget
     (443 weeks in log space, 354 to train, P = 8, linear_schedule(354,
     .20), n_mcmc=50, n_hmc=10, shuffle, adaptive_resampling=False, then
     predict at 469 points, predict_quantile at 0.025 / 0.5 / 0.975 and
     predict_mvn with the log-normal correction), every launch counter
     zeroed just before: its asserts, kernels 1-5 launch,
     validate_particles, finite live LMLs, the top 8 LMLs and predictions
     within 1e-3 of float64 on the CPU, the quantiles within 1e-3 of the y
     range of a float64 CPU predict_quantile on the carried-over model.
 19. deep: depth caps above 8, every launch counter zeroed first --
     (a) the reference's greedy configuration on tsdl.161
     (GPConfig(changepoints=False, max_depth=10), seed 2, fit_greedy(
     max_depth=10)), then fit_greedy_mcmc(n_mcmc=20, n_parallel=4) from
     seed 7, on 1023-slot heaps: AIC non-increasing in both, AIC = 2 (k -
     lml) within 1e-6, the final LMLs within 1e-3 of float64 on the CPU;
     (b) config 4's fit (phase 8's series, schedule and widths) with
     GPConfig(static_max_depth=10): the prior's LMLs, the fitted top-8
     LMLs and predictions within 1e-3 of float64 on the CPU, its time
     beside phase 8's, the scored trees deeper than 8 levels counted;
     (c) predict_mvn_sum and decompose on a particle whose Periodic split
     is 9 levels deep against the float64 host construction (1e-3), and
     decompose on (b)'s model (kernel 1's float64 entry on 1023-slot
     heaps) with phase 14's gates; kernels 1, 1 f64, 2, 3, 4 and 5 must
     launch. Then (d), launches not counted: kernels 1, 1 f64, 5, 5b, 5c, 6
     and 7 at depth caps 9, 10 and 12 on right combs as tall as the cap
     and prior trees, and on the full 9-level tree, against their plain
     versions (1, 6: 1e-5 normwise; 1 f64: 1e-12; 5: kernel5_rows; 5b:
     1e-3 per particle), the twins bitwise (6 = 1, 5c = 5, 7 = 5b), kernels
     1 and 6 bitwise on every taller stack instance; config 4's prior trees
     in 31- and 1023-slot heaps: kernels 1, 5, 5b and 7 bitwise, slot for
     slot; a tape longer than an entry stages raises before launch; each
     kernel timed on both heaps.

Before the last line it prints the card line and one JSON object with each
kernel's launches on the main path, its error, its time beside its plain
version's and a library call's (CUDA events), and its bound: the largest
of the bytes it must move over 3.35 TB/s and its operations over the peak
of each pipe they run on (FP32 67 TFLOP/s, TF32 tensor cores 495 TFLOP/s,
special functions), with that pipe named (`pipe`), and its launches in
config 3's greedy fit (`launches_config3`) and in phase 14's
predict_mvn_sum (`launches_predict_mvn_sum`), each read from the row's own
counter, and in phases 15, 16 and 17's rank 0, phase 18's iclaims fit and
phase 19's path (`launches_depth`, `launches_config2`,
`launches_mesh_rank0`, `launches_tutorials`, `launches_deep`), and its
ms on 31- and 1023-slot heaps of the same trees (`ms_cap5_cap10`, phase
19); the last line is the device JSON.
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
PEAK_F64 = 34e12      # FP64 outside the tensor cores (same data sheet)
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


def bound(flops, sfu, nbytes, tf32=0.0, f64=0.0):
    """(bound_ms, bound_by, pipe): the largest of the times the work needs
    on each pipe it runs on -- FP32 `flops` on the CUDA cores, TF32
    `tf32` flops on the tensor cores (3xTF32 counts its three products),
    `sfu` special-function calls, FP64 `f64` operations -- and the byte
    time. The pipes can run side by side, so the slowest one is the least
    time and no share of it reads above 100%."""
    pipes = {"fp32": flops / PEAK_F32, "tf32 tensor cores": tf32 / PEAK_TF32,
             "special functions": sfu / PEAK_SFU, "fp64": f64 / PEAK_F64,
             "memory": nbytes / PEAK_BYTES}
    pipe = max(pipes, key=pipes.get)
    return (pipes[pipe] * 1e3, "bytes" if pipe == "memory" else
            "operations", pipe)


def tape_cost(node_type, depth_cap, table):
    """Per-particle (flops, sfu) per element of running its tape once."""
    from autogp_tpu_torch.ops import cov
    _, ttype, _, _, tlen, _ = cov.build_tape(node_type, depth_cap)
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


def airline_series(np, n=144):
    """Config 3's series (scripts/bench_configs.py:38-43): an airline-like
    trend times a 12-step season, plus noise, numpy seed 0."""
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=float)
    y = (1.0 + 0.02 * t) * (10.0 + 3.0 * np.sin(2 * np.pi * t / 12.0)) \
        + 0.5 * rng.standard_normal(n)
    return t, y


def row_counters():
    """Each kernels-line row's own launch counter, (module, attribute)."""
    from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv
    return {"cov_tape": (cov, "launches"),
            "cov_tape_f64": (cov, "f64_launches"),
            "chol_panel": (chol, "launches"),
            "linv_stats_wd": (kinv, "stats_launches"),
            "linv_beta": (kinv, "linv_beta_launches"),
            "kinv_beta": (kinv, "kinv_beta_launches"),
            "linv_stats": (kinv, "linv_stats_launches"),
            "kinv_beta_strips": (kinv, "strips_launches"),
            "cov_tape_bwd": (cov_vjp, "launches"),
            "cov_tape_bwd_linv": (cov_vjp, "linv_launches"),
            "cov_slot": (cov, "slot_launches"),
            "cov_tape_bwd_unfused": (cov_vjp, "unfused_launches"),
            "cov_slot_bwd": (cov_vjp, "slot_launches")}


def zero_counts(counters):
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_counts(counters):
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def term_scale(torch, nt, pt, ts, mask, kinv_lower, beta, depth_cap):
    """[P, 3M] float64: for each parameter, the sum over the gram's
    elements of |cotangent x dK / dparameter|, the size of the terms whose
    sum kernel 5 returns, from the plain version in float64 on the same
    inputs (one forward-mode derivative, dual numbers, per parameter of a
    slot active in some tree; 0 at the others, on which K does not
    depend)."""
    from autogp_tpu_torch import gp_math
    from autogp_tpu_torch.ops import cov
    f64 = torch.float64
    P, M = nt.shape
    Kinv = torch.tril(kinv_lower) + torch.tril(kinv_lower, -1).mT
    kbar = gp_math.mvn_logpdf_cotangent(
        beta.double(), Kinv.double(), mask.double(),
        torch.ones(P, dtype=f64, device=pt.device))
    pt64, ts64, m64 = pt.double(), ts.double(), mask.double()
    zero = torch.zeros(P, dtype=f64, device=pt.device)

    def K(par):
        return cov.cov_tape_plain(nt, par, zero, ts64, ts64, m64, m64,
                                  depth_cap, True, False)
    scale = torch.zeros(P, 3 * M, dtype=f64, device=pt.device)
    live = (nt != 0).any(0).nonzero()[:, 0].tolist()
    import torch.autograd.forward_ad as fwAD
    for k in (3 * s_ + j for s_ in live for j in range(3)):
        tangent = torch.zeros_like(pt64).view(P, -1)
        tangent[:, k] = 1.0
        with fwAD.dual_level():
            dK = fwAD.unpack_dual(K(fwAD.make_dual(
                pt64, tangent.view_as(pt64)))).tangent
        scale[:, k] = (kbar * dK).abs().sum((1, 2))
    return scale


def greedy_batch_check(A, np, torch, batch):
    """One stage's padded candidate batch of config 3's fit, at its start
    and at its optimized parameters: model.lml and its autograd gradient
    on the card (kernels 1, 2, 4 and 5) against the same function in
    float64 on the CPU, where every kernel wrapper takes its plain
    version; kernel 1 against its plain version; kernel 5 against its
    plain version in f64 on the same inputs.

    The gradient is a sum of terms that cancel: its float32 error is
    relative to the terms' size, not to the sum. So kernel 5's error in
    each parameter is gated against the sum of its terms' magnitudes
    (`term_scale`) on both batches, and its error relative to the
    gradient, reported beside that of the plain version run in float32,
    at the start only; the end-to-end gradient likewise: at the optimized
    parameters the gradient is near zero. Returns a message."""
    from autogp_tpu_torch import model as M
    from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv
    nt, pz_sets, nz_sets, data, cfg, tables = batch
    f64 = torch.float64
    ts, xs, mask = data.ts, data.xs, data.mask
    B, N, D = nt.shape[0], ts.shape[0], tables.depth_cap
    if (B, N, int(mask.sum())) != (32, 256, 144):
        fail(f"greedy: the candidate batch is [{B}, {N}] with "
             f"{int(mask.sum())} active, not [32, 256] with 144")
    tab64 = M.prior_tables(cfg, "cpu", f64)
    ts64, xs64, m64 = (a.double().cpu() for a in (ts, xs, mask))
    ntc = nt.cpu()
    route = ("cov_tape", "chol_panel", "kinv_beta_strips", "cov_tape_bwd")
    counters = {k: v for k, v in row_counters().items() if k in route}
    msgs = []
    for label, pz, nz in zip(("start", "optimized"), pz_sets, nz_sets):
        gated = label == "start"
        # model.lml and its gradient: the card against float64 on the CPU.
        before = read_counts(counters)
        pzg = pz.detach().clone().requires_grad_(True)
        nzg = nz.detach().clone().requires_grad_(True)
        v = M.lml(nt, pzg, nzg, ts, xs, mask, cfg, tables)
        gp, gn = torch.autograd.grad(v.sum(), (pzg, nzg))
        torch.cuda.synchronize()
        used = {k: n_ - before[k] for k, n_ in read_counts(counters).items()}
        if min(used.values()) <= 0:
            fail(f"greedy batch ({label}): lml under grad skipped a kernel "
                 f"of the fused route: {used}")
        pzc = pz.detach().double().cpu().requires_grad_(True)
        nzc = nz.detach().double().cpu().requires_grad_(True)
        vr = M.lml(ntc, pzc, nzc, ts64, xs64, m64, cfg, tab64)
        gpr, gnr = torch.autograd.grad(vr.sum(), (pzc, nzc))
        vr = vr.detach()
        with torch.no_grad():
            K64 = cov.cov_tape_plain(
                ntc, M.transform_params(ntc, pzc, tab64),
                M.transform_noise(nzc, cfg), ts64, ts64, m64, m64, D, True,
                False)
            ev = torch.linalg.eigvalsh(K64)
            cond = torch.where(ev[:, 0] > 0, ev[:, -1] / ev[:, 0],
                               float("inf"))
        vc = v.detach().double().cpu()
        g_c = torch.cat([gp.flatten(1), gn[:, None]], 1).double().cpu()
        g_r = torch.cat([gpr.flatten(1), gnr[:, None]], 1)
        fin_r = torch.isfinite(vr) & torch.isfinite(g_r).all(1)
        fin_c = torch.isfinite(vc) & torch.isfinite(g_c).all(1)
        well = fin_r & (cond < 1e5)
        if int(well.sum()) == 0 or not bool(fin_c[well].all()):
            fail(f"greedy batch ({label}): {int(well.sum())} lanes with "
                 f"cond < 1e5, {int((well & ~fin_c).sum())} of them not "
                 f"finite on the card")
        both = fin_r & torch.isfinite(vc)
        lml_rel = float(((vc - vr).abs() / vr.abs())[both].max())
        e_g = per_particle_rel(g_c, g_r)
        g_rel = float(e_g[well].max())
        if not lml_rel <= 1e-3 or (gated and not g_rel <= 1e-2):
            fail(f"greedy batch ({label}): card vs float64 CPU, LML rel "
                 f"{lml_rel:.3e} (gate 1e-3), gradient worst {g_rel:.3e} "
                 f"on cond < 1e5 (gate 1e-2)")
        # Kernels 1 and 5 alone on these inputs.
        with torch.no_grad():
            pt = M.transform_params(nt, pz, tables)
            noise = M.transform_noise(nz, cfg)
            K = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, D, True,
                             True)
            k1 = normwise_rel(K, cov.cov_tape_plain(
                nt, pt, noise, ts, ts, mask, mask, D, True, True))
            _, alpha, wd, L = chol.chol_solve_strips(
                K, (xs * mask).expand(B, N))
            Ki, beta, _ = kinv.kinv_beta_strips(alpha, wd, L)
            g1 = torch.ones(B, device=ts.device)
            pb, nb = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, Ki, beta, g1, D)
            pr, nr = cov_vjp.cov_tape_bwd_plain(
                nt, pt.double(), ts.double(), mask.double(), Ki.double(),
                beta.double(), g1.double(), D)
            p32, _ = cov_vjp.cov_tape_bwd_plain(nt, pt, ts, mask, Ki, beta,
                                                g1, D)
        scale = term_scale(torch, nt, pt, ts, mask, Ki, beta, D)
        ok = torch.isfinite(pr.flatten(1)).all(1) & torch.isfinite(nr)
        err = (pb.double() - pr).abs().flatten(1)
        e_s = torch.where(scale > 0, err / scale, err).amax(1)
        e_s = torch.where(ok, e_s, 0.0)
        worst = int(e_s.argmax())
        e_p = per_particle_rel(pb, pr)[ok]
        e_32 = per_particle_rel(p32, pr)[ok]
        e_n = float(((nb.double() - nr).abs() / nr.abs())[ok].max())
        if not (k1 <= 1e-5 and float(e_s.max()) <= 1e-5 and e_n <= 1e-3
                and (not gated or float(e_p.max()) <= 1e-3)):
            fail(f"greedy batch ({label}): kernel 1 vs plain {k1:.3e} (gate"
                 f" 1e-5); kernel 5 vs f64 plain: worst error / sum of the "
                 f"terms' magnitudes {float(e_s.max()):.3e} (gate 1e-5, lane"
                 f" {worst}, {nt[worst].tolist()}), per lane max|err| / "
                 f"max|ref| {float(e_p.max()):.3e} (gate 1e-3 at the start),"
                 f" nbar {e_n:.3e} (gate 1e-3) on {int(ok.sum())} lanes")
        rest = fin_r & fin_c & ~well
        msgs.append(
            f"{label}: LML rel {lml_rel:.3e} on {int(both.sum())} lanes "
            f"(gate 1e-3), gradient worst {g_rel:.3e} (median "
            f"{float(e_g[well].median()):.3e}"
            f"{'; gate 1e-2' if gated else ', reported'}) on "
            f"{int(well.sum())} lanes with cond < 1e5 (largest "
            f"{float(cond[well].max()):.3e}), {int(rest.sum())} more with "
            f"cond >= 1e5 worst "
            f"{float(e_g[rest].max()) if rest.any() else 0.0:.3e}; kernel 1"
            f" vs plain {k1:.3e} (gate 1e-5); kernel 5 vs f64 plain on "
            f"{int(ok.sum())} lanes: error / sum of the terms' magnitudes "
            f"worst {float(e_s.max()):.3e} (gate 1e-5), nbar rel {e_n:.3e} "
            f"(gate 1e-3), per lane max|err| / max|ref| worst "
            f"{float(e_p.max()):.3e} (median {float(e_p.median()):.3e}"
            f"{'; gate 1e-3' if gated else ', reported'}; the plain version"
            f" in float32: {float(e_32.max()):.3e})")
    return (f"candidate batch [{B}, {N}, {N}] with {int(mask.sum())} active"
            f" vs float64: " + "; ".join(msgs))


def greedy_phase(A, np, torch):
    """Config 3 on the card: fit_greedy(max_depth=3) on the 144-point
    airline series (bucket 256, a batch of 32 candidates a stage), timed
    after a warm-up fit on another seed, launches counted; the warm-up's
    last candidate batch checked by greedy_batch_check; then
    fit_greedy_mcmc(n_mcmc=6, n_parallel=4) from its state. Returns the
    fit's launches by kernels-line row."""
    from autogp_tpu_torch.inference import greedy as G
    from autogp_tpu_torch.inference import smc
    from autogp_tpu_torch.ops import cov_vjp
    t, y = airline_series(np)
    cfg = A.GPConfig(changepoints=False, max_depth=3)
    bucket = G.sweep_bucket(cfg, 3)
    # The warm-up fit, its candidate batches recorded on their way through
    # map_optimize (inputs and optimized parameters).
    batches = []
    map_optimize = G.map_optimize

    def recording(nt, pz, nz, data, cfg_, tables, *args, **kw):
        res = map_optimize(nt, pz, nz, data, cfg_, tables, *args, **kw)
        batches.append((nt, (pz, res.params_z), (nz, res.noise_z), data,
                        cfg_, tables))
        return res
    G.map_optimize = recording
    try:
        A.seed(12)
        A.fit_greedy(A.GPModel(t, y, n_particles=1, config=cfg),
                     max_depth=3)
    finally:
        G.map_optimize = map_optimize
    torch.cuda.synchronize()

    counters = row_counters()
    zero_counts(counters)
    A.seed(11)
    steps = []

    def callback(*, model, step, aic, elapsed):
        steps.append((step, aic, str(model.covariance_kernels(
            reparameterize=False)[0])))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    m = A.GPModel(t, y, n_particles=1, config=cfg)
    A.fit_greedy(m, max_depth=3, callback_fn=callback)
    ev[1].record()
    torch.cuda.synchronize()
    fit_ms = ev[0].elapsed_time(ev[1])
    launches = read_counts(counters)
    path = ("cov_tape", "chol_panel", "kinv_beta_strips", "cov_tape_bwd")
    if min(launches[k] for k in path) <= 0:
        fail(f"greedy: a kernel of config 3's path never launched: "
             f"{launches}")
    if m.device.type != "cuda" or m.particles.params.dtype != torch.float32:
        fail("greedy: the model is not a float32 CUDA model")
    aics = [a for _, a, _ in steps]
    if [s_ for s_, _, _ in steps] != [1, 2, 3] or not all(
            b <= a for a, b in zip(aics, aics[1:])):
        fail(f"greedy: steps or AICs not non-increasing: {steps}")
    smc.validate_particles(m.particles, m.config, tables=m.tables)
    lml_card = float(m.particles.lml[0])
    ref = A.from_dict(A.to_dict(m), device="cpu", dtype=torch.float64)
    lml_ref = float(ref.particles.lml[0])
    lml_rel = abs(lml_card - lml_ref) / abs(lml_ref)
    if not lml_rel <= 1e-3:
        fail(f"greedy: final LML {lml_card} vs float64 CPU {lml_ref} "
             f"(rel {lml_rel:.3e})")
    k = int(G.n_params(m.particles.node_type[0], cfg.noise is None))
    aic_err = abs(aics[-1] - 2.0 * (k - lml_card)) / abs(aics[-1])
    if not aic_err <= 1e-6:
        fail(f"greedy: AIC {aics[-1]} != 2 (k - lml) = "
             f"{2.0 * (k - lml_card)} (k = {k})")
    stats = m.round_stats
    batch_msg = greedy_batch_check(A, np, torch, batches[-1])
    # fit_greedy_mcmc from that state; its kernel-5 launches counted.
    cov_vjp.launches = 0
    mc = []
    t0 = time.perf_counter()
    A.fit_greedy_mcmc(m, n_mcmc=6, n_parallel=4, callback_fn=lambda **kw:
                      mc.append((kw["aic"], kw["accepted"])))
    torch.cuda.synchronize()
    mcmc_s = time.perf_counter() - t0
    mc_aics = [a for a, _ in mc]
    if len(mc) != 6 or not all(b <= a for a, b in zip(mc_aics, mc_aics[1:])):
        fail(f"greedy_mcmc: AICs not non-increasing: {mc}")
    if cov_vjp.launches <= 0:
        fail("greedy_mcmc: kernel 5 never launched")
    phase("greedy", f"config 3: fit_greedy(max_depth=3) on the 144-point "
          f"airline series (bucket 256, batch {bucket}) {fit_ms:.1f} ms (CUDA "
          f"events, after a warm-up fit on seed 12); per stage (step, AIC, "
          f"structure, candidates, probes) " + ", ".join(
              f"({s_}, {a:.4f}, {st}, {r['candidates']}, {r['probes']})"
              for (s_, a, st), r in zip(steps, stats))
          + f"; launches {launches}; final LML {lml_card:.4f} vs float64 "
          f"CPU {lml_ref:.4f} (rel {lml_rel:.3e}, gate 1e-3); AIC = 2 (k - "
          f"lml) with k = {k} (rel {aic_err:.1e}); validate_particles ok; "
          f"{batch_msg}; fit_greedy_mcmc(6, n_parallel=4) {mcmc_s:.2f} s, "
          f"AICs " + ", ".join(f"{a:.4f}{'*' if acc else ''}" for a, acc in mc)
          + f" (* accepted), kernel 5 launches {cov_vjp.launches}")
    return launches


def decompose_phase(A, np, torch, model, ds_pred, quantiles):
    """The decomposition API on a fitted CUDA model: decompose,
    extract_kernel and split_kernel_sop by GP.Periodic, predict_sum and
    predict_mvn_sum at ds_pred; kernel 1 must launch in predict_mvn_sum
    and agree with its plain version on the component blocks, each
    particle's Y mean must be F_T + F_nT, and the 8 heaviest particles'
    means and covariances must agree with a float64 CPU run of
    predict_mvn_sum on the model carried over by to_dict / from_dict.
    Returns predict_mvn_sum's launches by kernels-line row."""
    from autogp_tpu_torch import model as M
    from autogp_tpu_torch import tree as T
    from autogp_tpu_torch.ops import cov
    GP = A.GP
    P = model.num_particles
    t0 = time.perf_counter()
    subs, frag_msg, f64_launches = fragment_lml_check(A, np, torch, model,
                                                      top=8)
    kernels = model.covariance_kernels(reparameterize=False)
    if len(subs) != P or any(
            s_.device.type != "cuda" or s_.num_particles != len(GP.unroll(k))
            for s_, k in zip(subs, kernels)):
        fail("decompose: wrong sub-model count, size or device")
    f64_row = f64_kernel_row(A, np, torch, model, subs)
    ex = A.extract_kernel(model, GP.Periodic)
    sa, sb = A.split_kernel_sop(model, GP.Periodic)
    if not all(m_.device.type == "cuda" and m_.num_particles == P
               for m_ in (ex, sa, sb)):
        fail("extract_kernel / split_kernel_sop: wrong model")
    depths = {lt.__name__: max(max(c.depth for c in s_)
                               for s_ in A.api.sum_components(model, lt))
              for lt in (GP.Periodic, GP.Linear)}
    # A Constant(0) pad encodes as z = -inf: its transform is exactly 0.
    cfg2 = A.GPConfig(max_depth=2)
    with np.errstate(divide="ignore"):
        nt0, pz0 = T.node_to_tensor(GP.Constant(0.0) + GP.Periodic(1, 1, 1),
                                    cfg2)
    pt0 = M.transform_params(
        torch.as_tensor(nt0, device="cuda")[None],
        torch.as_tensor(pz0, dtype=torch.float32, device="cuda")[None],
        M.prior_tables(cfg2, "cuda", torch.float32))
    if not (bool(torch.isfinite(pt0).all()) and float(pt0[0, 1, 0]) == 0.0):
        fail(f"Constant(0) pad transforms to {pt0[0, 1].tolist()}, not 0")
    api_s = time.perf_counter() - t0

    counters = row_counters()
    zero_counts(counters)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    mix, idx = A.predict_mvn_sum(model, ds_pred, GP.Periodic)
    ev[1].record()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    if launches["cov_tape"] <= 0:
        fail("predict_mvn_sum: kernel 1 never launched")
    # Kernel 1 on predict_mvn_sum's own inputs against its plain version.
    nt_c, pt_c, z, depth_c = A.api.sum_component_heaps(model, ds_pred,
                                                       GP.Periodic)
    ones = torch.ones_like(z)
    zero = torch.zeros(nt_c.shape[0], device=z.device)
    Kc = cov.cov_tape(nt_c, pt_c, zero, z, z, ones, ones, depth_c,
                      gram=False)
    blk_err = 0.0
    for s_ in range(0, len(nt_c), 16):
        Kp = cov.cov_tape_plain(nt_c[s_:s_ + 16], pt_c[s_:s_ + 16],
                                zero[s_:s_ + 16], z, z, ones, ones, depth_c,
                                False, False)
        # Per block, relative to its largest entry; a Constant(0)
        # component's block (no such leaf in the particle) must be 0.
        num = (Kc[s_:s_ + 16] - Kp).abs().flatten(1).amax(1)
        den = Kp.abs().flatten(1).amax(1)
        blk_err = max(blk_err, float(torch.where(den > 0, num / den,
                                                 num).max()))
    if not blk_err <= 1e-5:
        fail(f"predict_mvn_sum: kernel 1's component blocks vs plain "
             f"{blk_err:.3e} (gate 1e-5)")
    del Kc
    ev[2].record()
    df = A.predict_sum(model, ds_pred, GP.Periodic, quantiles=quantiles)
    ev[3].record()
    torch.cuda.synchronize()
    cols = ["y_mean"] + [f"y_{q}" for q in quantiles]
    if (len(df) != 3 * P * len(ds_pred)
            or not np.isfinite(df[cols].to_numpy()).all()):
        fail("predict_sum output not finite or of the wrong shape")
    sum_errs = [float(np.abs(c.mean[idx["Y"]] - c.mean[idx["F"][0]]
                             - c.mean[idx["F"][1]]).max()
                      / np.abs(c.mean[idx["Y"]]).max())
                for c in mix.components]
    sum_err = max(sum_errs)
    if not sum_err <= 1e-4:
        fail(f"predict_mvn_sum: Y mean != F_T + F_nT (normwise {sum_err:.3e}"
             f", particle {int(np.argmax(sum_errs))})")
    w = model.particle_weights()
    top = [int(i) for i in np.argsort(-w)[:8]]
    d = A.to_dict(model)
    for key in ("kernels", "noise_zs", "noises"):
        d[key] = [d[key][i] for i in top]
    d["pf_state"]["log_weights"] = [d["pf_state"]["log_weights"][i]
                                    for i in top]
    t0 = time.perf_counter()
    ref = A.from_dict(d, device="cpu", dtype=torch.float64)
    mix_ref, _ = A.predict_mvn_sum(ref, ds_pred, GP.Periodic)
    ref_s = time.perf_counter() - t0

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())
    mean_err = max(rel(mix.components[i].mean, c.mean)
                   for i, c in zip(top, mix_ref.components))
    cov_err = max(rel(mix.components[i].cov, c.cov)
                  for i, c in zip(top, mix_ref.components))
    if not (mean_err <= 1e-3 and cov_err <= 1e-3):
        fail(f"predict_mvn_sum: card vs float64 CPU on the top 8: mean "
             f"{mean_err:.3e}, cov {cov_err:.3e}")
    phase("decompose", f"on phase 8's config-4 model (P={P}): decompose "
          f"({frag_msg}; kernel 1's float64 entry: {f64_launches} launches,"
          f" at [{f64_row['shape']}] vs its plain version "
          f"{f64_row['err']:.3e} normwise (gate 1e-12), {f64_row['ms']:.4f}"
          f" ms, plain {f64_row['plain_ms']:.4f} ms, bound "
          f"{f64_row['bound'][0]:.4f} ms ({f64_row['bound'][2]})), "
          f"extract_kernel(Periodic), split_kernel_sop(Periodic) "
          f"{api_s:.2f} s; largest component "
          f"depth by leaf type {depths}; predict_mvn_sum({len(ds_pred)}) "
          f"{ev[0].elapsed_time(ev[1]):.1f} ms, predict_sum({len(ds_pred)}, "
          f"{len(quantiles)} quantiles) {ev[2].elapsed_time(ev[3]):.1f} ms "
          f"(CUDA events); launches in predict_mvn_sum {launches}; kernel 1's"
          f" [{len(nt_c)}, {len(z)}, {len(z)}] component blocks (depth cap "
          f"{depth_c}) vs plain {blk_err:.3e} (gate 1e-5); Y mean = F_T + "
          f"F_nT to {sum_err:.3e} (gate 1e-4); top 8 vs float64 CPU "
          f"({ref_s:.1f} s): mean {mean_err:.3e}, cov {cov_err:.3e} (gate "
          f"1e-3); Constant(0) pads transform to 0")
    f64_row["launches"] = f64_launches
    return launches, f64_row


def fragment_lml_check(A, np, torch, model, top=None):
    """decompose(model) on the card against decompose of the model carried
    to the CPU in float64 (to_dict / from_dict), on the fragments of every
    particle or of the `top` heaviest (the CPU's float64 evaluator takes
    ~0.7 s a fragment model at N = 1024): every fragment LML that float64
    finds finite must be finite on the card and within 1e-3 relative.
    Returns (the card's fragment models, a summary, the launches of
    kernel 1's float64 entry in decompose)."""
    from autogp_tpu_torch.ops import cov
    cov.f64_launches = 0
    t0 = time.perf_counter()
    subs = A.decompose(model)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    f64_launches = cov.f64_launches
    keep = list(range(model.num_particles))
    if top is not None:
        keep = [int(i) for i in np.argsort(-model.particle_weights())[:top]]
    t0 = time.perf_counter()
    d = A.to_dict(model)
    for key in ("kernels", "noise_zs", "noises"):
        d[key] = [d[key][i] for i in keep]
    d["pf_state"]["log_weights"] = [d["pf_state"]["log_weights"][i]
                                    for i in keep]
    ref = A.from_dict(d, device="cpu", dtype=torch.float64)
    ref_subs = A.decompose(ref)
    ref_s = time.perf_counter() - t0
    subs_kept = [subs[i] for i in keep]
    if [s_.num_particles for s_ in subs_kept] != [s_.num_particles
                                                 for s_ in ref_subs]:
        fail("decompose: the card's fragments differ from float64's")
    got = np.concatenate([s_.particles.lml.double().cpu().numpy()
                          for s_ in subs_kept])
    want = np.concatenate([s_.particles.lml.numpy() for s_ in ref_subs])
    fin = np.isfinite(want)
    lost = fin & ~np.isfinite(got)
    rel = np.abs(got[fin] - want[fin]) / np.abs(want[fin])
    worst = float(np.nanmax(rel)) if fin.any() else 0.0
    if lost.any() or not (rel <= 1e-3).all():
        fail(f"decompose: {int(lost.sum())} fragment LMLs finite in float64 "
             f"on the CPU are not finite on the card; the finite ones agree "
             f"to {worst:.3e} relative (gate 1e-3)")
    n_all = sum(s_.num_particles for s_ in subs)
    which = ("all" if top is None
             else f"the {len(keep)} heaviest particles'")
    return subs, (
        f"{n_all} fragments, {card_s:.2f} s on the card; of {which} "
        f"{len(want)}, float64 CPU finds {int(fin.sum())} LMLs finite "
        f"({ref_s:.1f} s), the card {int(np.isfinite(got).sum())}, all of "
        f"those within {worst:.3e} relative (gate 1e-3)"), f64_launches


def f64_kernel_row(A, np, torch, model, subs):
    """Kernel 1's float64 entry on the inputs `model.lml_f64` gives it for
    the largest fragment model of `subs` (the model's N-point bucket):
    against its plain version on the same float64 inputs (per-particle
    normwise error), both timed (CUDA events), its bound (the float64
    output over the memory rate, or one FP64 operation for each formula
    operation and each exp / log / sin over the FP64 rate)."""
    from autogp_tpu_torch import model as M
    from autogp_tpu_torch.inference import smc
    from autogp_tpu_torch.ops import cov
    f64, dev = torch.float64, model.device
    sub = max(subs, key=lambda s_: s_.num_particles)
    p = sub.particles
    tab = M.prior_tables(sub.config, dev, f64)
    data = smc.make_dataset(model._ds_numeric(), model._y_numeric(),
                            dtype=f64, device=dev)
    pt = M.transform_params(p.node_type, p.params.double(), tab)
    noise = M.transform_noise(p.noise_z.double(), sub.config)
    ts, mask = data.ts, data.mask
    D = tab.depth_cap

    def kern():
        return cov.cov_tape(p.node_type, pt, noise, ts, ts, mask, mask, D,
                            gram=True)

    def plain():
        return cov.cov_tape_plain(p.node_type, pt, noise, ts, ts, mask,
                                  mask, D, True, False)
    before = cov.f64_launches
    K = kern()
    torch.cuda.synchronize()
    if cov.f64_launches != before + 1:
        fail("cov_tape on float64 CUDA tensors did not launch its entry")
    err = normwise_rel(K, plain())
    if not err <= 1e-12:
        fail(f"kernel 1's float64 entry vs its plain version: {err:.3e} "
             f"(gate 1e-12)")
    Pn, N = K.shape[0], K.shape[1]
    cost = tape_cost(p.node_type, D, FWD_COST)
    n_act = float(mask.sum())
    ops = sum(f + s_ for f, s_ in cost) * n_act * n_act
    return {"shape": f"{Pn}, {N}, {N}", "err": err,
            "abs_err": float((K - plain()).abs().max()),
            "ms": cuda_ms(torch, kern, 5),
            "dev_ms": device_ms(torch, kern, ("cov_tape_f64_kernel",), 5),
            "plain_ms": cuda_ms(torch, plain, 2),
            "bound": bound(0.0, 0.0, Pn * N * N * 8, f64=ops)}


def depth_posterior_oracle(np, torch):
    """The posterior oracle of tests/test_inference.py:347-398 on the card
    (autogp_tpu_torch.scripts.depth_oracle): depth-annealed SMC ([1, 2])
    against data-annealed SMC ([4, 8, 12]) on the 12-point series, both
    targeting p(structure | data) at max_depth 2 under one prior, and
    each against the exact posterior (importance sampling from the
    parameter prior, 200000 draws a structure); bucket 32, the dense
    gradient route (kernels 1, 2, 5b). Gates: ESS > 40 each, every
    structure within 5 se + 0.03, total variation < 0.15 between the two,
    and < 0.10 from each to the exact posterior. The last gate holds the
    extension weight's normalization on the old depth's support: with the
    reference's weight the depth-annealed ensemble lay 0.156-0.172 from
    the exact posterior, with the normalized one 0.025-0.054 (P = 4096,
    seeds 5-7, NVIDIA H100, scripts/depth_oracle.py). It runs P = 4096:
    at the JAX test's 1024 the ensembles' noise alone put the
    depth-annealed one 0.056-0.109 from exact over seeds 5-8
    (`--particles 1024`). Returns a message."""
    from autogp_tpu_torch.ops import cov_vjp
    from autogp_tpu_torch.scripts import depth_oracle as O
    P = 4096
    cov_vjp.unfused_launches = 0
    fd, ess_d = O.depth_annealed(P, 5, "cuda", torch.float32)
    fa, ess_a = O.data_annealed(P, 9, "cuda", torch.float32)
    unfused = cov_vjp.unfused_launches
    gap = O.structure_gap(fd, ess_d, fa, ess_a)
    tv = O.total_variation(fd, fa)
    t0 = time.perf_counter()
    exact = O.exact_posterior("cuda", torch.float32)
    exact_s = time.perf_counter() - t0
    tv_d, tv_a = O.total_variation(fd, exact), O.total_variation(fa, exact)
    if not (unfused > 0 and ess_d > 40 and ess_a > 40 and gap < 1.0
            and tv < 0.15 and tv_d < 0.10 and tv_a < 0.10):
        fail(f"depth oracle: 5b launches {unfused}, ESS {ess_d:.1f} / "
             f"{ess_a:.1f} (gate 40), worst structure gap / bound {gap:.3f} "
             f"(gate 1), total variation {tv:.4f} (gate 0.15), to the exact"
             f" posterior {tv_d:.4f} depth-annealed and {tv_a:.4f} "
             f"data-annealed (gate 0.10)")
    return (f"posterior oracle at P={P} (dense route, {unfused} 5b "
            f"launches): total variation {tv:.4f} (gate 0.15), worst "
            f"structure gap / bound {gap:.3f} (gate 1), ESS {ess_d:.1f} "
            f"depth-annealed, {ess_a:.1f} data-annealed; to the exact "
            f"posterior ({exact_s:.1f} s) {tv_d:.4f} and {tv_a:.4f} (gate "
            f"0.10)")


def depth_phase(A, np, torch, t_days, y):
    """Depth-annealed SMC on config 4's series (N = 1024, transformed as
    GPModel transforms it): run_smc_anneal_depth(schedule=[1, 2, 3, 4,
    5], P = 64, n_mcmc = 10, n_hmc = 10), the other arguments at their
    defaults, every launch counter zeroed just before and read just after.
    Gates: kernels 1, 2, 3, 4, 5 launch; validate_particles with round
    trips; no NaN log weight, finite LMLs and normalized weights; the top
    8 particles' LMLs within 1e-3 of a float64 CPU re-evaluation; the first
    extension's weights (depth 1 -> 2) against extend_weight in float64 on
    the CPU on the same draws and trees, |dw| <= 1e-3 (|lml_old| +
    |lml_new|) + 1e-3 where both are finite; then the posterior oracle.
    Returns the fit's launches by kernels-line row."""
    from autogp_tpu_torch import model as M
    from autogp_tpu_torch.inference import smc, smc_depth
    P, D_MAX = P_MAIN, 5
    ts = A.LinearTransform.from_minmax(t_days, 0, 1).apply(t_days)
    xs = A.LinearTransform.from_mean_width(y, 1).apply(y)
    # The first extension's inputs and outputs, and CUDA events around
    # every extension.
    first, ext_ev = [], []
    extend, extend_weight = smc_depth.extend, smc_depth.extend_weight

    def recording_weight(*args):
        out = extend_weight(*args)
        if not first:
            first.append((args, out))
        return out

    def timed_extend(*args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = extend(*args)
        ev[1].record()
        ext_ev.append(ev)
        return out
    smc_depth.extend, smc_depth.extend_weight = timed_extend, recording_weight
    counters = row_counters()
    rs = []
    try:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        zero_counts(counters)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        parts, cfg = smc_depth.run_smc_anneal_depth(
            gen, ts, xs, schedule=list(range(1, D_MAX + 1)), n_particles=P,
            n_mcmc=10, n_hmc=10, round_stats=rs)
        ev[1].record()
        torch.cuda.synchronize()
    finally:
        smc_depth.extend, smc_depth.extend_weight = extend, extend_weight
    launches = read_counts(counters)
    fit_ms = ev[0].elapsed_time(ev[1])
    ext_ms = sum(a.elapsed_time(b) for a, b in ext_ev)
    path = ("cov_tape", "chol_panel", "linv_stats_wd", "kinv_beta_strips",
            "cov_tape_bwd")
    if min(launches[k] for k in path) <= 0:
        fail(f"depth: a kernel of the path never launched: {launches}")
    if (cfg.max_depth != D_MAX or parts.node_type.shape != (P, 31)
            or parts.params.dtype != torch.float32
            or parts.params.device.type != "cuda" or len(ext_ev) != 4):
        fail("depth: wrong final config, heap, dtype, device or extension "
             "count")
    tables = M.prior_tables(cfg, "cuda", torch.float32)
    smc.validate_particles(parts, cfg, tables=tables)
    w = smc.normalized_weights(parts.log_weights)
    if not (torch.isfinite(parts.lml).all() and torch.isfinite(w).all()):
        fail("depth: non-finite LML or normalized weight")
    n_dead = int(torch.isinf(parts.log_weights).sum())

    # Top 8 by weight among the live particles, in float64 on the CPU.
    f64 = torch.float64
    data64 = smc.make_dataset(ts, xs, dtype=f64, device="cpu")
    d64 = (data64.ts, data64.xs, data64.mask)
    alive = (parts.lml > smc.BAD_LML).cpu().numpy()
    top = [int(i) for i in np.argsort(-w.cpu().numpy()) if alive[i]][:8]
    sel = torch.as_tensor(top, device="cuda")
    lml_ref = M.lml(parts.node_type[sel].cpu(), parts.params[sel].cpu()
                    .double(), parts.noise_z[sel].cpu().double(), *d64, cfg,
                    M.prior_tables(cfg, "cpu", f64))
    top_rel = float(((parts.lml[sel].cpu().double() - lml_ref).abs()
                     / lml_ref.abs()).max())
    if not top_rel <= 1e-3:
        fail(f"depth: top-8 LMLs vs float64 CPU rel {top_rel:.3e}")

    # The first extension again in float64 on the CPU.
    t0 = time.perf_counter()
    (nt, pz, nz, ext, data, cfg2, tab2, depth_old, biased), (
        _, _, _, w_card) = first[0]

    def cpu(t):
        return t.cpu().double() if t.is_floating_point() else t.cpu()
    ext64 = smc_depth.Extension(*(
        type(f)(*map(cpu, f)) if isinstance(f, tuple) else cpu(f)
        for f in ext))
    tab64 = M.prior_tables(cfg2, "cpu", f64)
    _, _, lml_new64, w64 = smc_depth.extend_weight(
        cpu(nt), cpu(pz), cpu(nz), ext64, d64, cfg2, tab64, depth_old,
        biased)
    # The bound's scale: the old LMLs on the card (float32 is enough).
    lml_old = M.lml(nt, pz, nz, *data, cfg2, tab2).cpu().double()
    # The increment the driver adds: the weight less the backward
    # kernel's log mass on the old support.
    w_card = (w_card - smc_depth.detach_support_logprob(
        ext.node_type, depth_old, tab2, biased)).cpu().double()
    w64 = w64 - smc_depth.detach_support_logprob(ext64.node_type, depth_old,
                                                 tab64, biased)
    both = torch.isfinite(w64) & torch.isfinite(w_card)
    dw = (w_card - w64).abs()
    bnd = 1e-3 * (lml_old.abs() + lml_new64.abs()) + 1e-3
    if int(both.sum()) < P // 2 or bool((dw > bnd)[both].any()):
        worst = float((dw / bnd)[both].max()) if both.any() else float("nan")
        fail(f"depth: first extension's weights vs float64 CPU: "
             f"{int(both.sum())} finite in both, worst |dw| / bound "
             f"{worst:.3e}")
    w_msg = (f"first extension (depth 1 -> 2) vs extend_weight - "
             f"detach_support_logprob in float64 on the CPU ({time.perf_counter() - t0:.1f} s): {int(both.sum())}"
             f" of {P} finite in both ({int((~torch.isfinite(w_card)).sum())} "
             f"not finite on the card, {int((~torch.isfinite(w64)).sum())} in"
             f" float64), worst |dw| {float(dw[both].max()):.3e}, worst "
             f"|dw| / bound {float((dw / bnd)[both].max()):.3e}")

    oracle_msg = depth_posterior_oracle(np, torch)
    mh = sum(r["mh_accepted"] for r in rs)
    sweeps = sum(r["hmc_sweeps"] for r in rs)
    hacc = sum(r["hmc_accepted"] for r in rs)
    phase("depth", f"run_smc_anneal_depth(config 4's series N={len(ts)}, "
          f"schedule 1..{D_MAX}, P={P}, n_mcmc=10, n_hmc=10) "
          f"{fit_ms:.1f} ms (CUDA events), the 4 extensions {ext_ms:.1f} ms "
          f"({100 * ext_ms / fit_ms:.2f}%); per depth (depth, ESS before "
          f"resampling, resampled, MH accepts, HMC sweeps, HMC parameter "
          f"accepts) " + ", ".join(
              f"({r['depth']}, {r['ess']:.2f}, {r['resampled']}, "
              f"{r['mh_accepted']}, {r['hmc_sweeps']}, {r['hmc_accepted']})"
              for r in rs)
          + f"; MH acceptance {mh}/{P * 10 * D_MAX} "
          f"({mh / (P * 10 * D_MAX):.4f}), HMC parameter acceptance "
          f"{hacc}/{sweeps} ({hacc / max(sweeps, 1):.4f}); launches "
          f"{launches}; final ESS {float(smc.effective_sample_size(parts.log_weights)):.2f}, "
          f"{n_dead} particles of weight 0, best LML "
          f"{float(parts.lml.max()):.3f}; validate_particles ok; top-8 LMLs"
          f" vs float64 CPU rel {top_rel:.3e} (gate 1e-3); {w_msg}; "
          f"{oracle_msg}")
    return launches


def gate_failures(rows):
    """The (label, error, gate) rows whose error is above its gate (or not
    a number)."""
    return [r for r in rows if not r[1] <= r[2]]


def rows_text(rows):
    return ", ".join(f"{lab} {err:.3e}" + (f" (gate {g:g})" if g < math.inf
                                           else "") for lab, err, g in rows)


def kernel5_rows(torch, label, nt, pt, ts, mask, kinv_lower, beta, depth,
                 terms=True):
    """Kernel 5 against its plain version in float64 on the same inputs
    (the float32 K^-1 and beta upcast), over the particles whose float64
    reference is finite (at least half): each parameter's error within
    1e-3 of its particle's largest gradient entry (phase 6's gate) plus
    1e-5 of the sum of its terms' magnitudes (term_scale, the gate of
    config 3's candidates); the noise gradient's <= 1e-3 of itself. Both
    parts are reported alone. Neither part alone holds: on one-slot prior
    trees the gradient cancels within terms 1e6 times its size, and the
    kernel read 0.234 of the largest entry and 8.0e-8 of the terms' size;
    on 15 slots it read up to 0.91 of an entry's terms' size and 1.2e-2
    of the largest entry (NVIDIA H100 80GB HBM3, 700.00 W).
    Plain version and scale in chunks of 8 particles. Without `terms` the
    terms' size is not computed (a derivative per parameter: too slow for
    hundreds of active slots) and the gate is 1e-3 of the largest entry
    alone."""
    from autogp_tpu_torch.ops import cov_vjp
    f64 = torch.float64
    P = nt.shape[0]
    g1 = torch.ones(P, device=nt.device)
    pb, nb = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, kinv_lower, beta, g1,
                                  depth)
    pr, nr, scale = [], [], []
    for s in range(0, P, 8):
        sl = slice(s, s + 8)
        p_, n_ = cov_vjp.cov_tape_bwd_plain(
            nt[sl], pt[sl].to(f64), ts.to(f64), mask.to(f64),
            kinv_lower[sl].to(f64), beta[sl].to(f64), g1[sl].to(f64), depth)
        pr.append(p_)
        nr.append(n_)
        scale.append(term_scale(torch, nt[sl], pt[sl], ts, mask,
                                kinv_lower[sl], beta[sl], depth) if terms
                     else torch.zeros_like(p_.flatten(1)))
    pr, nr, scale = torch.cat(pr), torch.cat(nr), torch.cat(scale)
    ok = torch.isfinite(pr.flatten(1)).all(1) & torch.isfinite(nr)
    err = (pb.double() - pr).abs().flatten(1)
    top = pr.abs().flatten(1).amax(1, keepdim=True)
    e_b = (err / (1e-3 * top + 1e-5 * scale))[ok]
    e_p = (err / top)[ok]
    e_s = torch.where(scale > 0, err / scale, err)[ok]
    e_n = ((nb.double() - nr).abs() / nr.abs())[ok]

    def worst(e):
        return float(e.max()) if ok.any() else float("nan")
    inf = float("inf")
    return [(f"{label} kernel 5 particles without a finite f64 reference",
             float((~ok).sum()), P // 2),
            (f"{label} kernel 5 pbar / (1e-3 max|pbar| + 1e-5 terms' size)",
             worst(e_b), 1.0),
            (f"{label} kernel 5 pbar / max|pbar|", worst(e_p), inf),
            (f"{label} kernel 5 pbar / terms' size", worst(e_s), inf),
            (f"{label} kernel 5 nbar", worst(e_n), 1e-3)]


def kernels_at_one_particle(torch, gen):
    """Kernels 1-5 at P = 1 against their plain versions, with the gates of
    phases 1-6, at config 2's shapes: on [1, 512, 512] (config2_sweeps:
    Linear + Periodic at N = 500, a 7-slot heap) kernel 1 <= 1e-5 of
    plain; the driver's factor of a well-conditioned SPD matrix <= 1e-4
    of float64; kinv_beta_strips and linv_stats_wd on it <= 1e-4 (K^-1,
    beta) and 1e-5 (||L^-1||^2) of plain in float64, 0 above the diagonal
    blocks; kernel 5 on config 2's gram (kernel5_rows). On [1, 256, 256]
    (experiment_hmc.run's defaults: bench 2's 200 observed points, a
    15-slot heap) kernels 1 and 5 again. Launches kernels 1 and 5 twice,
    kernel 2 14 times (panels of three chol_solve_strips calls and one
    chol_solve), linv_stats_wd once, kinv_beta_strips 3 times. Returns
    (label, error, gate) rows."""
    import numpy as np
    from autogp_tpu_torch import GPConfig
    from autogp_tpu_torch import model as M
    from autogp_tpu_torch import tree as T
    from autogp_tpu_torch.inference import smc
    from autogp_tpu_torch.ops import chol, cov, kinv
    from autogp_tpu_torch.scripts import experiment_hmc as X
    f32, f64 = torch.float32, torch.float64
    ts_np, xs_np, node, cfg = X.config2_problem()
    cfg_x = GPConfig(changepoints=True, max_depth=4)
    ts_x, xs_x, _, _ = X.simulate(2, 1000, 200, np.random.default_rng(0),
                                  cfg_x)
    node_x, noise_x = X.BENCHMARKS[2]
    problems = (
        ("[1, 512, 512]", ts_np, xs_np, node, cfg, 0.1),
        ("[1, 256, 256]", ts_x, xs_x, node_x, cfg_x, float(
            M.untransform_param("noise", noise_x, cfg_x))))
    rows = []
    for label, t_np, x_np, node_, cfg_, nz in problems:
        tab = M.prior_tables(cfg_, "cuda", f32)
        nt_np, pz_np = T.node_to_tensor(node_, cfg_)
        nt = torch.as_tensor(nt_np, device="cuda")[None]
        pt = M.transform_params(nt, torch.as_tensor(
            pz_np, dtype=f32, device="cuda")[None], tab)
        noise = M.transform_noise(torch.full((1,), nz, device="cuda"), cfg_)
        data = smc.make_dataset(t_np, x_np, dtype=f32, device="cuda")
        ts, xs, mask = data.ts, data.xs, data.mask
        N, D = ts.shape[0], cfg_.depth_cap
        K = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, D, True, True)
        Kp = cov.cov_tape_plain(nt, pt, noise, ts, ts, mask, mask, D, True,
                                True)
        rows.append((f"{label} kernel 1", normwise_rel(K, Kp), 1e-5))
        _, a_c, wd_c, L_c = chol.chol_solve_strips(K, xs.expand(1, N))
        Ki_c, beta_c, _ = kinv.kinv_beta_strips(a_c, wd_c, L_c)
        rows += kernel5_rows(torch, label, nt, pt, ts, mask, Ki_c, beta_c, D)
    N = 512
    X64 = torch.randn(1, N, N, generator=gen, device="cuda", dtype=f64)
    S64 = X64 @ X64.mT / N + torch.eye(N, device="cuda", dtype=f64)
    x64 = torch.randn(1, N, generator=gen, device="cuda", dtype=f64)
    L, a = chol.chol_solve(torch.tril(S64).float(), x64.float())
    Lr = torch.linalg.cholesky(S64)
    ar = torch.linalg.solve_triangular(Lr, x64[..., None],
                                       upper=False)[..., 0]
    _, a_s, wd_s, L_s = chol.chol_solve_strips(torch.tril(S64).float(),
                                               x64.float())
    Ki, beta, fro = kinv.kinv_beta_strips(a_s, wd_s, L_s)
    beta_s, fro_s = kinv.linv_stats_wd(L_s, a_s, wd_s)
    Kir, br, fr = kinv.kinv_beta_plain(L_s.double(), a_s.double())
    blk = torch.arange(N, device="cuda") // min(N, chol.BLOCK)
    upper = float((Ki[:, blk[None, :] > blk[:, None]] != 0).sum())
    return rows + [
        ("[1, 512, 512] driver vs f64", max(normwise_rel(L, Lr),
                                            normwise_rel(a, ar)), 1e-4),
        ("linv_stats_wd beta", normwise_rel(beta_s, br), 1e-4),
        ("linv_stats_wd fro", float(((fro_s.double() - fr) / fr).abs()
                                    .max()), 1e-5),
        ("kinv_beta_strips K^-1", normwise_rel(torch.tril(Ki),
                                               torch.tril(Kir)), 1e-4),
        ("kinv_beta_strips beta", normwise_rel(beta, br), 1e-4),
        ("kinv_beta_strips fro", float(((fro.double() - fr) / fr).abs()
                                       .max()), 1e-5),
        ("kinv_beta_strips entries above the diagonal blocks", upper, 0)]


def small_heap_rows(torch, gen, depth):
    """Kernels 1 and 5 on 64 prior trees of depth cap `depth` (heaps of 2^
    depth - 1 slots, as the depth run's rounds give them) at [64, 1024,
    1024], 768 points active: kernel 1 <= 1e-5 of plain; kernel 5 on the
    kernels' own K^-1 and beta of those grams (kernel5_rows). Returns
    (label, error, gate) rows."""
    from autogp_tpu_torch import config as C
    from autogp_tpu_torch import model as M
    from autogp_tpu_torch.ops import chol, cov, kinv
    f32 = torch.float32
    n_act = 3 * N_MAIN // 4
    ts = torch.zeros(N_MAIN, device="cuda")
    ts[:n_act] = torch.linspace(0, 1, n_act, device="cuda")
    mask = (torch.arange(N_MAIN, device="cuda") < n_act).float()
    xs = torch.sin(12 * ts) * mask
    cfg = C.GPConfig(max_depth=depth)
    tab = M.prior_tables(cfg, "cuda", f32)
    nt, pz = M.sample_tree(gen, P_MAIN, tab, f32, "cuda")
    pt = M.transform_params(nt, pz, tab)
    nz = M.transform_noise(torch.randn(P_MAIN, generator=gen,
                                       device="cuda"), cfg)
    K = cov.cov_tape(nt, pt, nz, ts, ts, mask, mask, depth, True, True)
    Kp = cov.cov_tape_plain(nt, pt, nz, ts, ts, mask, mask, depth, True,
                            True)
    label = f"M={nt.shape[1]}"
    rows = [(f"{label} kernel 1", normwise_rel(K, Kp), 1e-5)]
    del Kp
    _, a, wd, L = chol.chol_solve_strips(K, xs.expand(P_MAIN, -1))
    del K
    Ki, beta, _ = kinv.kinv_beta_strips(a, wd, L)
    del L, wd
    return rows + kernel5_rows(torch, label, nt, pt, ts, mask, Ki, beta,
                               depth)


DEEP_LEAVES = (2, 3, 4, 5, 9, 1)   # Linear, SE, GE, Periodic, WN, Constant
DEEP_OPS = (6, 7, 6, 8)            # Plus, Times, Plus, ChangePoint


def comb_heap(np, depth, height):
    """node_type [M] (M = 2^depth - 1) of a right comb of `height` levels:
    an operator at each level of the right spine, a leaf on each left,
    the spine's last slot a leaf. Its post-order stack holds `height`
    values at once, the most a tree of that many levels needs."""
    nt = np.zeros((1 << depth) - 1, dtype=np.int64)
    s = 0
    for k in range(height - 1):
        nt[s] = DEEP_OPS[k % len(DEEP_OPS)]
        nt[2 * s + 1] = DEEP_LEAVES[k % len(DEEP_LEAVES)]
        s = 2 * s + 2
    nt[s] = DEEP_LEAVES[(height - 1) % len(DEEP_LEAVES)]
    return nt


def full_heap(np, depth):
    """node_type [M] of the full tree of `depth` levels (every slot
    active): Times above the leaves, Plus above those, leaves cycling
    through DEEP_LEAVES."""
    M = (1 << depth) - 1
    nt = np.full(M, 6, dtype=np.int64)
    bottom = M // 2
    nt[(bottom - 1) // 2:bottom] = 7
    nt[bottom:] = [DEEP_LEAVES[i % len(DEEP_LEAVES)]
                   for i in range(M - bottom)]
    if depth == 1:
        nt[0] = DEEP_LEAVES[0]
    return nt


def deep_batch(np, torch, gen, depth, heaps, n_prior):
    """(node_type [P, M], params_t [P, M, 3] float32, noise [P]) on the
    card: the given heaps (numpy [M] each) with random parameters, then
    n_prior trees of the prior at depth cap `depth`."""
    from autogp_tpu_torch import config as C
    from autogp_tpu_torch import model as M
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = C.GPConfig(max_depth=depth)
    tab = M.prior_tables(cfg, "cuda", torch.float32)
    nts = [torch.as_tensor(np.stack(heaps), device="cuda")] if heaps else []
    pzs = [0.5 * torch.randn(len(heaps), nts[0].shape[1], 3, generator=gen,
                             device="cuda")] if heaps else []
    if n_prior:
        nt, pz = M.sample_tree(gen, n_prior, tab, torch.float32, "cuda")
        nts.append(nt)
        pzs.append(pz)
    nt, pz = torch.cat(nts), torch.cat(pzs)
    noise = M.transform_noise(torch.randn(nt.shape[0], generator=gen,
                                          device="cuda"), cfg)
    return nt, M.transform_params(nt, pz, tab), noise


def raises_without_launch(fn, counter, limit):
    """Whether fn() raises ValueError naming `limit` with the launch
    counter (module, attribute) unmoved."""
    mod, attr = counter
    before = getattr(mod, attr)
    try:
        fn()
    except ValueError as e:
        return str(limit) in str(e) and getattr(mod, attr) == before
    return False


def deep_kernel_rows(np, torch, gen, depth, N=256, P=4):
    """Kernels 1, 1 f64, 5, 5b, 5c, 6 and 7 on heaps of depth cap `depth`
    (2^depth - 1 slots) at [P, N, N], 3/4 of the points active: a right
    comb as tall as the cap (the tallest stack), a second comb one level
    shorter, and P - 2 trees of the prior at that cap. Gates: kernels 1
    and 6 <= 1e-5 normwise of their plain version; kernel 1's float64 entry
    <= 1e-12; kernel 5 (kernel5_rows: 1e-3 of each particle's largest
    entry plus 1e-5 of each parameter's terms' size; noise 1e-3) on its own
    K^-1 and beta; 5b <= 1e-3 per particle on a random cotangent (noise
    1e-5); the twins bitwise: 6 = 1 (full gram), 5c = 5, 7 = 5b; kernels 1
    and 6 bitwise themselves with the stack forced to each taller
    instance. Returns (label, error, gate) rows; a bitwise gate reads 0
    when it holds."""
    from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv
    f64 = torch.float64
    heaps = [comb_heap(np, depth, depth), comb_heap(np, depth, depth - 1)]
    nt, pt, noise = deep_batch(np, torch, gen, depth, heaps, P - 2)
    n_act = 3 * N // 4
    ts = torch.zeros(N, device="cuda")
    ts[:n_act] = torch.linspace(0, 1, n_act, device="cuda")
    mask = (torch.arange(N, device="cuda") < n_act).float()
    xs = torch.sin(12 * ts) * mask
    lab = f"D={depth}"
    tp = cov.tape(nt, depth)
    rows = [(f"{lab} tallest stack - cap (must be 0)",
             float(abs(tp.max_height - depth)), 0)]
    K = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, depth, True)
    rows.append((f"{lab} kernel 1", normwise_rel(K, cov.cov_tape_plain(
        nt, pt, noise, ts, ts, mask, mask, depth, True, False)), 1e-5))
    K6 = cov.cov_matrix(nt, pt, noise, ts, mask, depth)
    rows.append((f"{lab} kernel 6", normwise_rel(K6, cov.cov_matrix_plain(
        nt, pt, noise, ts, mask, depth)), 1e-5))
    rows.append((f"{lab} kernel 6 bitwise kernel 1 (differing entries)",
                 float((K6 != K).sum()), 0))
    for h in (8, 12, 16, 32):
        if h > tp.max_height:
            K_h = cov._launch(nt, pt, noise, ts, ts, mask, mask, depth, True,
                              False, min_height=h)
            K6_h = cov._launch_slot(nt, pt, noise, ts, mask, depth, True,
                                    min_height=h)
            rows.append((f"{lab} kernels 1 and 6 with a stack of {h} bitwise "
                         f"(differing entries)",
                         float((K_h != K).sum() + (K6_h != K6).sum()), 0))
    d64 = [x.to(f64) for x in (pt, noise, ts, mask)]
    K64 = cov.cov_tape(nt, d64[0], d64[1], d64[2], d64[2], d64[3], d64[3],
                       depth, True)
    rows.append((f"{lab} kernel 1 f64", normwise_rel(K64, cov.cov_tape_plain(
        nt, d64[0], d64[1], d64[2], d64[2], d64[3], d64[3], depth, True,
        False)), 1e-12))
    # The LML gradient's kernels on the factor of the lower-only gram.
    Kl = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, depth, True, True)
    _, a, wd, L = chol.chol_solve_strips(Kl, xs.expand(nt.shape[0], N))
    Ki, beta, _ = kinv.kinv_beta_strips(a, wd, L)
    V, beta_v, _ = kinv.linv_beta(L, a, wd)
    rows += kernel5_rows(torch, lab, nt, pt, ts, mask, Ki, beta, depth)
    g1 = torch.ones(nt.shape[0], device="cuda")
    p5, n5 = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, Ki, beta, g1, depth)
    p5c, n5c = cov_vjp.cov_tape_bwd_linv(nt, pt, ts, mask, V, beta, g1,
                                         depth)
    rows.append((f"{lab} kernel 5c bitwise 5 (differing entries)",
                 float((p5c != p5).sum() + (n5c != n5).sum()), 0))
    kbar = torch.randn(nt.shape[0], N, N, generator=gen, device="cuda")
    pb, nb = cov_vjp.cov_grads_tape(nt, pt, kbar, ts, mask, depth)
    p7, n7 = cov_vjp.cov_grads(nt, pt, kbar, ts, mask, depth)
    pr, nr = cov_vjp.cov_grads_plain(nt, pt.to(f64), kbar.to(f64),
                                     ts.to(f64), mask.to(f64), depth)
    ok = torch.isfinite(pr.flatten(1)).all(1)
    e = ((pb.double() - pr).abs().flatten(1).amax(1)
         / pr.abs().flatten(1).amax(1).clamp_min(1e-30))[ok]
    rows += [(f"{lab} kernel 5b particles without a finite f64 reference",
              float((~ok).sum()), nt.shape[0] // 2),
             (f"{lab} kernel 5b", float(e.max()), 1e-3),
             (f"{lab} kernel 5b nbar", float(((nb.double() - nr).abs()
                                              / nr.abs())[ok].max()), 1e-5),
             (f"{lab} kernel 7 bitwise 5b (differing entries)",
              float((p7 != pb).sum() + (n7 != nb).sum()), 0)]
    return rows


def full_tree_rows(np, torch, gen, depth=9, N=64):
    """The full tree of `depth` levels (2^depth - 1 active slots: the
    longest tape of its heap) and one prior tree, at [2, N, N]: kernels 1,
    6, 1 f64, 5, 5c, 5b and 7 with deep_kernel_rows' gates."""
    from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv
    f64 = torch.float64
    nt, pt, noise = deep_batch(np, torch, gen, depth, [full_heap(np, depth)],
                               1)
    n_act = 3 * N // 4
    ts = torch.zeros(N, device="cuda")
    ts[:n_act] = torch.linspace(0, 1, n_act, device="cuda")
    mask = (torch.arange(N, device="cuda") < n_act).float()
    xs = torch.sin(12 * ts) * mask
    lab = f"full depth-{depth} tree"
    K = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, depth, True)
    K6 = cov.cov_matrix(nt, pt, noise, ts, mask, depth)
    d64 = [x.to(f64) for x in (pt, noise, ts, mask)]
    K64 = cov.cov_tape(nt, d64[0], d64[1], d64[2], d64[2], d64[3], d64[3],
                       depth, True)
    rows = [(f"{lab} tape length", float(cov.tape(nt, depth).max_len),
             float((1 << depth) - 1)),
            (f"{lab} kernel 1", normwise_rel(K, cov.cov_tape_plain(
                nt, pt, noise, ts, ts, mask, mask, depth, True, False)),
             1e-5),
            (f"{lab} kernel 6 bitwise kernel 1 (differing entries)",
             float((K6 != K).sum()), 0),
            (f"{lab} kernel 1 f64", normwise_rel(K64, cov.cov_tape_plain(
                nt, d64[0], d64[1], d64[2], d64[2], d64[3], d64[3], depth,
                True, False)), 1e-12)]
    Kl = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, depth, True, True)
    _, a, wd, L = chol.chol_solve_strips(Kl, xs.expand(2, N))
    Ki, beta, _ = kinv.kinv_beta_strips(a, wd, L)
    V, _, _ = kinv.linv_beta(L, a, wd)
    rows += kernel5_rows(torch, lab, nt, pt, ts, mask, Ki, beta, depth,
                         terms=False)
    g1 = torch.ones(2, device="cuda")
    p5, n5 = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, Ki, beta, g1, depth)
    p5c, n5c = cov_vjp.cov_tape_bwd_linv(nt, pt, ts, mask, V, beta, g1,
                                         depth)
    kbar = torch.randn(2, N, N, generator=gen, device="cuda")
    pb, nb = cov_vjp.cov_grads_tape(nt, pt, kbar, ts, mask, depth)
    p7, n7 = cov_vjp.cov_grads(nt, pt, kbar, ts, mask, depth)
    pr, _ = cov_vjp.cov_grads_plain(nt, pt.to(f64), kbar.to(f64),
                                    ts.to(f64), mask.to(f64), depth)
    return rows + [
        (f"{lab} kernel 5c bitwise 5 (differing entries)",
         float((p5c != p5).sum() + (n5c != n5).sum()), 0),
        (f"{lab} kernel 5b", normwise_rel(pb.flatten(1), pr.flatten(1)),
         1e-3),
        (f"{lab} kernel 7 bitwise 5b (differing entries)",
         float((p7 != pb).sum() + (n7 != nb).sum()), 0)]


def recode_rows(np, torch, gen, depth=10):
    """64 prior trees of depth cap 5 (ChangePoints on) and the same trees
    re-encoded in heaps of depth cap `depth` (the same slots, the rest
    empty), at [64, 1024, 1024] with 768 points active: kernel 1's lower
    gram and kernel 5's gradient (slot for slot, on the same K^-1 and
    beta; the deeper heap's other slots 0) bitwise equal, so are 5b's and
    7's on a random cotangent. Returns (label, differing entries, 0)
    rows."""
    from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv
    nt5, pt5, noise = deep_batch(np, torch, gen, 5, [], P_MAIN)
    pad = (1 << depth) - 1 - nt5.shape[1]
    nt10 = torch.nn.functional.pad(nt5, (0, pad))
    pt10 = torch.nn.functional.pad(pt5, (0, 0, 0, pad))
    n_act = 3 * N_MAIN // 4
    ts = torch.zeros(N_MAIN, device="cuda")
    ts[:n_act] = torch.linspace(0, 1, n_act, device="cuda")
    mask = (torch.arange(N_MAIN, device="cuda") < n_act).float()
    xs = torch.sin(12 * ts) * mask
    K5 = cov.cov_tape(nt5, pt5, noise, ts, ts, mask, mask, 5, True, True)
    K10 = cov.cov_tape(nt10, pt10, noise, ts, ts, mask, mask, depth, True,
                       True)
    _, a, wd, L = chol.chol_solve_strips(K5, xs.expand(P_MAIN, -1))
    Ki, beta, _ = kinv.kinv_beta_strips(a, wd, L)
    del L, wd, a
    g1 = torch.ones(P_MAIN, device="cuda")

    def diff(o5, o10):
        (p5, n5), (p10, n10) = o5, o10
        return float((p10[:, :p5.shape[1]] != p5).sum() + (n10 != n5).sum()
                     + (p10[:, p5.shape[1]:] != 0).sum())
    rows = [(f"kernel 1 at depth caps 5 and {depth} (differing entries)",
             float((K10 != K5).sum()), 0)]
    del K10
    rows.append((f"kernel 5 at depth caps 5 and {depth} (differing entries)",
                 diff(cov_vjp.cov_tape_bwd(nt5, pt5, ts, mask, Ki, beta, g1,
                                           5),
                      cov_vjp.cov_tape_bwd(nt10, pt10, ts, mask, Ki, beta,
                                           g1, depth)), 0))
    kbar = torch.randn(P_MAIN, N_MAIN, N_MAIN, generator=gen, device="cuda")
    for name, fn in (("5b", cov_vjp.cov_grads_tape),
                     ("7", cov_vjp.cov_grads)):
        rows.append((f"kernel {name} at depth caps 5 and {depth} "
                     f"(differing entries)",
                     diff(fn(nt5, pt5, kbar, ts, mask, 5),
                          fn(nt10, pt10, kbar, ts, mask, depth)), 0))
    return rows


def overlong_rows(np, torch):
    """A tape longer than an entry stages raises before launch, naming the
    limit, with the entry's launch counter unmoved: the full trees of 11
    levels (2047 positions: kernels 5, 5b, 5c, 7) and 14 levels (16383:
    kernels 1, 1 f64, 6). Returns (label, 0 if it held else 1, 0) rows."""
    from autogp_tpu_torch.ops import cov, cov_vjp
    rows = []
    for depth, names in ((11, ("cov_tape_bwd", "cov_tape_bwd_linv",
                               "cov_tape_bwd_unfused", "cov_slot_bwd")),
                         (14, ("cov_tape", "cov_tape_f64", "cov_slot"))):
        nt = torch.as_tensor(full_heap(np, depth), device="cuda")[None]
        M = nt.shape[1]
        pt = torch.full((1, M, 3), 0.5, device="cuda")
        nz = torch.full((1,), 0.1, device="cuda")
        N = 64
        ts = torch.linspace(0, 1, N, device="cuda")
        m = torch.ones(N, device="cuda")
        Z = torch.zeros(1, N, N, device="cuda")
        b, g = torch.zeros(1, N, device="cuda"), torch.ones(1, device="cuda")
        calls = {
            "cov_tape": (lambda: cov.cov_tape(nt, pt, nz, ts, ts, m, m,
                                              depth, True),
                         (cov, "launches")),
            "cov_tape_f64": (lambda: cov.cov_tape(
                nt, pt.double(), nz.double(), ts.double(), ts.double(),
                m.double(), m.double(), depth, True), (cov, "f64_launches")),
            "cov_slot": (lambda: cov.cov_matrix(nt, pt, nz, ts, m, depth),
                         (cov, "slot_launches")),
            "cov_tape_bwd": (lambda: cov_vjp.cov_tape_bwd(
                nt, pt, ts, m, Z, b, g, depth), (cov_vjp, "launches")),
            "cov_tape_bwd_linv": (lambda: cov_vjp.cov_tape_bwd_linv(
                nt, pt, ts, m, Z, b, g, depth), (cov_vjp, "linv_launches")),
            "cov_tape_bwd_unfused": (lambda: cov_vjp.cov_grads_tape(
                nt, pt, Z, ts, m, depth), (cov_vjp, "unfused_launches")),
            "cov_slot_bwd": (lambda: cov_vjp.cov_grads(nt, pt, Z, ts, m,
                                                       depth),
                             (cov_vjp, "slot_launches"))}
        for name in names:
            fn, counter = calls[name]
            held = raises_without_launch(fn, counter, cov.TAPE_LIMITS[name])
            rows.append((f"{name}: a tape of {M} positions raises, naming "
                         f"{cov.TAPE_LIMITS[name]}, and launches nothing "
                         f"(0 if so)", 0.0 if held else 1.0, 0))
    return rows


def config2_phase(A, np, torch):
    """BASELINE config 2 on the card: (a) config2_sweeps (20 sweeps at N =
    500 on the 512 bucket, one particle), every launch counter zeroed just
    before and read just after (the warm-up and the timed call), its final
    LML within 1e-3 of float64 on the CPU; (b) experiment_hmc.run(bench=2,
    n=1000, n_obs=200, n_steps=100, seed=0) with its Bayes-rule oracle at
    the float32 tolerance inside, lp_true within 1e-3 of the float64 CPU
    run's; (c) kernels_at_one_particle, and small_heap_rows at depth caps
    1, 2 and 4 (1-, 3- and 15-slot heaps). Returns (a)'s launches by
    kernels-line row."""
    from autogp_tpu_torch import model as M
    from autogp_tpu_torch.inference import smc
    from autogp_tpu_torch.scripts import experiment_hmc as X
    counters = row_counters()
    zero_counts(counters)
    r = X.config2_sweeps("cuda")
    torch.cuda.synchronize()
    launches = read_counts(counters)
    path = ("cov_tape", "chol_panel", "linv_stats_wd", "kinv_beta_strips",
            "cov_tape_bwd")
    if min(launches[k] for k in path) <= 0:
        fail(f"config2: a kernel of the path never launched: {launches}")
    ts, xs, _, cfg = X.config2_problem()
    data64 = smc.make_dataset(ts, xs, dtype=torch.float64, device="cpu")
    lml_ref = float(M.lml(
        r["node_type"].cpu(), r["params_z"].cpu().double(),
        r["noise_z"].cpu().double(), data64.ts, data64.xs, data64.mask,
        cfg, M.prior_tables(cfg, "cpu", torch.float64))[0])
    lml_card = float(r["lml"][0])
    rel2 = abs(lml_card - lml_ref) / abs(lml_ref)
    if not rel2 <= 1e-3:
        fail(f"config2: final LML {lml_card} vs float64 CPU {lml_ref}")
    n_grad = r["n_sweeps"] * 22
    t0 = time.perf_counter()
    m = X.run(bench=2, n=1000, n_obs=200, n_steps=100, seed=0,
              verbose=False)
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m64 = X.run(bench=2, n=1000, n_obs=200, n_steps=1, seed=0,
                verbose=False, device="cpu")
    ref_s = time.perf_counter() - t0
    lp_rel = abs(m["lp_true"] - m64["lp_true"]) / abs(m64["lp_true"])
    if not lp_rel <= 1e-3:
        fail(f"config2: lp_true {m['lp_true']} vs float64 CPU "
             f"{m64['lp_true']} (rel {lp_rel:.3e})")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261017)
    rows = kernels_at_one_particle(torch, gen)
    for depth in (1, 2, 4):
        rows += small_heap_rows(torch, gen, depth)
    if gate_failures(rows):
        fail(f"config2: kernels at P=1 or on small heaps vs plain: "
             f"{rows_text(gate_failures(rows))}")
    k_msg = (f"kernels at P=1 and on M-slot heaps at [{P_MAIN}, {N_MAIN}, "
             f"{N_MAIN}] vs plain: {rows_text(rows)}")
    phase("config2", f"(a) config2_sweeps: {r['n_sweeps']} sweeps (L=10) "
          f"at N=500 "
          f"{r['ms']:.1f} ms (CUDA events, after a warm-up call), "
          f"{r['ms'] / r['n_sweeps']:.3f} ms per sweep, "
          f"{r['ms'] / n_grad:.4f} ms per gradient ({n_grad}: 11 parameter "
          f"and 11 noise a sweep); parameter accepts {r['n_accept']}/"
          f"{r['n_sweeps']}; launches (warm-up and timed call) {launches}; "
          f"final LML {lml_card:.4f} vs float64 CPU {lml_ref:.4f} (rel "
          f"{rel2:.3e}, gate 1e-3); (b) experiment_hmc.run(bench=2, n=1000,"
          f" n_obs=200, n_steps=100) {run_s:.1f} s: Bayes-rule oracle |lp_"
          f"true - lp_bayes| {abs(m['lp_true'] - m['lp_bayes']):.4e} (gate "
          f"{max(1e-4 * abs(m['lp_bayes']), 3e-4 * 800):.4e}), lp_true "
          f"{m['lp_true']:.4f} vs float64 CPU {m64['lp_true']:.4f} (rel "
          f"{lp_rel:.3e}, gate 1e-3; {ref_s:.1f} s), acceptance "
          f"{m['acc_rate']:.2f}, lp_test {m['lp_init']:.3f} -> "
          f"{m['lp_final']:.3f} (true {m['lp_true']:.3f}), lml "
          f"{m['lml_init']:.3f} -> {m['lml_final']:.3f}, "
          f"{m['ms_per_step']:.2f} ms per step; (c) {k_msg}")
    return launches



# Phase 17: the particle mesh, config 4 as two gloo ranks on cuda:0.
MESH_RANKS, MESH_SEED, MESH_TIMEOUT_S = 2, 17, 300
MESH_PATH = ("cov_tape", "chol_panel", "linv_stats_wd", "kinv_beta_strips",
             "cov_tape_bwd")


def fit_summary(model, particles, df):
    """What phase 17 compares, as numpy: the whole batch `particles` of a
    config-4 fit, its particle_weights() and predict's columns."""
    out = {k: getattr(particles, k).cpu().numpy() for k in (
        "node_type", "parents", "params", "noise_z", "log_weights", "lml",
        "log_ml_est")}
    out["particle_weights"] = model.particle_weights()
    for c in ("y_mean", "y_0.1", "y_0.5", "y_0.9"):
        out["predict " + c] = df[c].to_numpy()
    return out


def mesh_rank(rank, world_size, port, out_dir, t_days, y, ds_future, sched):
    """One rank of phase 17 (spawned): joins a gloo group over TCP on
    localhost, puts its P / world_size particles on cuda:0 and runs phase
    8's fit and predict through GPModel(mesh=) from MESH_SEED, every
    launch counter zeroed just before the fit; writes the gathered
    results, its launches and seconds to out_dir. Rank 0 runs
    validate_particles (with round trips) on the gathered batch."""
    import datetime
    import pickle
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh rank {rank}: torch.cuda.is_available() "
                           f"is False")
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        warnings.simplefilter("ignore")
        import autogp_tpu_torch as A
        from autogp_tpu_torch.inference import smc
        from autogp_tpu_torch.ops import _build
        from autogp_tpu_torch.parallel import mesh as pmesh
        _build.library()
        mesh = pmesh.particle_mesh(device="cuda:0")
        try:   # an odd P: two ranks cannot split it
            A.GPModel(t_days, y, n_particles=5, mesh=mesh)
            odd_raises = False
        except ValueError:
            odd_raises = True
        counters = row_counters()
        A.seed(MESH_SEED)
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = A.GPModel(t_days, y, n_particles=P_MAIN, mesh=mesh)
        A.fit_smc(model, schedule=sched, n_mcmc=10, n_hmc=10)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_counts(counters)
        df = A.predict(model, ds_future, quantiles=[.1, .5, .9])
        everything = pmesh.gather_particles(model.particles, mesh)
        res = fit_summary(model, everything, df)
        if rank == 0:
            smc.validate_particles(everything, model.config,
                                   tables=model.tables)
        res.update(
            launches=launches, fit_s=fit_s, odd_raises=odd_raises,
            shard=model.particles.n_particles,
            device=str(model.particles.params.device),
            round_stats=model.round_stats)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_mesh_ranks(args):
    """Spawn MESH_RANKS ranks of mesh_rank(rank, MESH_RANKS, port, out_dir,
    *args) and return their results; a rank that raises, dies or outlives
    MESH_TIMEOUT_S fails the phase, and no rank outlives this call."""
    import pickle
    import socket
    import tempfile
    import torch.multiprocessing as tmp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = tmp.start_processes(
            mesh_rank, args=(MESH_RANKS, port, out_dir, *args),
            nprocs=MESH_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_TIMEOUT_S
        try:
            while not ctx.join(timeout=2.0):
                if time.monotonic() > deadline:
                    fail(f"mesh: the ranks did not finish in "
                         f"{MESH_TIMEOUT_S} s")
        except (tmp.ProcessRaisedException, tmp.ProcessExitedException) as e:
            fail(f"mesh: a rank failed: {e}")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(timeout=30)
        out = []
        for r in range(MESH_RANKS):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def mesh_phase(A, np, torch, t_days, y, ds_future, sched):
    """Phase 17: config 4 (phase 8's series, schedule, n_mcmc=10,
    n_hmc=10, predict at 32 points) fitted unsharded here from MESH_SEED,
    then as MESH_RANKS gloo ranks sharing cuda:0 through GPModel(mesh=).
    Gates: kernels 1-5 launch in each rank; each rank's gathered
    node_type and parents equal the unsharded fit's; params, noise_z,
    log_weights, lml, log_ml_est, particle_weights() and predict's means
    and quantiles within 1e-6 relative of it and every entry bitwise
    equal; each rank holds P / MESH_RANKS particles on cuda:0; an odd P
    raises ValueError; kernels 5, 5c, 5b and 7 on shards of a [64, 1024,
    1024] batch given part_batch=64 torch.equal to the whole batch's rows
    (scripts/batch_bits.kernel5_shards). Returns rank 0's launches by
    kernels-line row."""
    counters = row_counters()
    t0 = time.perf_counter()
    A.seed(MESH_SEED)
    zero_counts(counters)
    ref_model = A.GPModel(t_days, y, n_particles=P_MAIN)
    A.fit_smc(ref_model, schedule=sched, n_mcmc=10, n_hmc=10)
    torch.cuda.synchronize()
    ref_launches = read_counts(counters)
    df = A.predict(ref_model, ds_future, quantiles=[.1, .5, .9])
    ref = fit_summary(ref_model, ref_model.particles, df)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    del ref_model, df
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_mesh_ranks((t_days, y, ds_future, sched))
    ranks_s = time.perf_counter() - t0

    # Kernel 5's entries on shards of a [64, 1024, 1024] batch, each given
    # the whole batch's count (scripts/batch_bits.py).
    from autogp_tpu_torch.scripts import batch_bits
    t0 = time.perf_counter()
    shards = batch_bits.kernel5_shards(torch.device("cuda"), N=N_MAIN)
    shards_s = time.perf_counter() - t0
    if any(n_bad for *_, n_bad in shards):
        fail(f"mesh: kernel 5 given part_batch=64 differs from the whole "
             f"batch on a shard: {shards}")
    int_keys = ("node_type", "parents")
    msgs = []
    for r, res in enumerate(ranks):
        missing = [k for k in MESH_PATH if res["launches"][k] <= 0]
        if missing:
            fail(f"mesh: rank {r} never launched {missing}: "
                 f"{res['launches']}")
        if not (res["device"] == "cuda:0" and res["shard"] == P_MAIN //
                MESH_RANKS and res["odd_raises"]):
            fail(f"mesh: rank {r} holds {res['shard']} particles on "
                 f"{res['device']}; an odd P raised: {res['odd_raises']}")
        for k in int_keys:
            if not np.array_equal(res[k], ref[k]):
                fail(f"mesh: rank {r}'s {k} differ from the unsharded "
                     f"fit's in {int((res[k] != ref[k]).sum())} entries")
        n_bitwise, n_all, worst = 0, 0, 0.0
        for k, want in ref.items():
            if k in int_keys:
                continue
            got = np.asarray(res[k])
            want = np.asarray(want)
            width = {4: np.int32, 8: np.int64}[want.dtype.itemsize]
            bitwise = got.view(width) == want.view(width)
            diff = ~(bitwise | (got == want))
            rel = (np.abs(got[diff] - want[diff])
                   / np.maximum(np.abs(want[diff]), 1e-300))
            if not (rel <= 1e-6).all():
                fail(f"mesh: rank {r}'s {k} differ from the unsharded "
                     f"fit's by up to {float(np.nanmax(rel)):.3e} relative "
                     f"in {int(diff.sum())} entries")
            n_bitwise += int(bitwise.sum())
            n_all += want.size
            worst = max([worst, *rel.tolist()])
        if n_bitwise != n_all:
            fail(f"mesh: rank {r}: {n_all - n_bitwise} of {n_all} float "
                 f"entries are not bitwise the unsharded fit's (max rel "
                 f"{worst:.3e})")
        msgs.append(f"rank {r}: fit {res['fit_s']:.1f} s, launches "
                    f"{ {k: res['launches'][k] for k in MESH_PATH} }, "
                    f"{n_bitwise}/{n_all} float entries bitwise equal, max "
                    f"rel {worst:.3e}")
    phase("mesh", f"config 4 (N={N_MAIN}, P={P_MAIN}, n_mcmc=10, n_hmc=10, "
          f"predict(32, 3 quantiles)) unsharded {ref_s:.1f} s (launches "
          f"{ {k: ref_launches[k] for k in MESH_PATH} }), then as "
          f"{MESH_RANKS} gloo ranks on cuda:0 through GPModel(mesh=) "
          f"({ranks_s:.1f} s with spawn, import and load): " + "; ".join(
              msgs) + f"; node_type and parents equal the unsharded fit's "
          f"on every rank; every float entry bitwise equal; kernels 5, 5c, "
          f"5b and 7 on {len(shards) // 4} shards of [64, {N_MAIN}, "
          f"{N_MAIN}] given part_batch=64: 0 particles differ from the "
          f"whole batch's ({shards_s:.1f} s); rounds (step, "
          f"resampled, MH accepted, HMC sweeps) " + ", ".join(
              f"({q['step']}, {q['resampled']}, {q['mh_accepted']}, "
              f"{q['hmc_sweeps']})" for q in ranks[0]["round_stats"])
          + f"; validate_particles ok on the gathered batch; P=5 raises "
          f"ValueError")
    return ranks[0]["launches"]


def tutorials_phase(A, np, torch):
    """Phase 18: the port's tutorial flows (autogp_tpu_torch/scripts/
    tutorials) on cuda:0. (a) overview, decomposition, callbacks and
    greedy_mcmc at their FAST settings, each with its own asserts, the
    decomposition's fragment LMLs against float64 on the CPU; (b) iclaims
    at its full reference budget (443 weeks in log space, 354 to train,
    P = 8, linear_schedule(354, .20), n_mcmc=50, n_hmc=10, shuffle,
    adaptive_resampling=False; predict at 469 points, predict_quantile at
    0.025 / 0.5 / 0.975 (tol 1e-6), predict_mvn and the log-normal
    correction), every launch counter zeroed just before. Gates: the
    flow's asserts, kernels 1-5 launch, validate_particles, finite LMLs
    for the live particles, the 8 heaviest particles' LMLs and
    predictions within 1e-3 of float64 on the CPU, the three quantile
    curves within 1e-3 of the y range of a float64 CPU predict_quantile
    on the same carried-over model. Returns iclaims' launches by
    kernels-line row."""
    from autogp_tpu_torch.inference import smc
    from autogp_tpu_torch.scripts.tutorials import (
        callbacks, decomposition, greedy_mcmc, iclaims, overview)
    msgs = []
    for name, flow in (("overview", overview),
                       ("decomposition", decomposition),
                       ("callbacks", callbacks),
                       ("greedy_mcmc", greedy_mcmc)):
        t0 = time.perf_counter()
        try:
            r = flow.run(True, device="cuda:0")
        except AssertionError as e:
            fail(f"tutorials: the {name} flow's assert failed on the card: "
                 f"{e!r}")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        models = [v for v in r.values() if isinstance(v, A.GPModel)]
        if not models or any(m_.device.type != "cuda"
                             or m_.dtype != torch.float32 for m_ in models):
            fail(f"tutorials: {name} did not run on the card in float32")
        extra = ""
        if name == "decomposition":
            _, frag_msg, _ = fragment_lml_check(A, np, torch, r["model"])
            extra = f" (decompose: {frag_msg})"
        elif name == "greedy_mcmc":
            aics = [a for _, a in r["aic_trace"]]
            extra = (f" (greedy AIC {aics[0]:.2f} -> {aics[-1]:.2f} in "
                     f"{len(aics)} steps, hybrid {r['hybrid_aics'][0]:.2f} "
                     f"-> {r['hybrid_aics'][-1]:.2f})")
        msgs.append(f"{name} (FAST) ok {sec:.1f} s{extra}")

    counters = row_counters()
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        r = iclaims.run(False, device="cuda:0")
    except AssertionError as e:
        fail(f"tutorials: the iclaims flow's assert failed on the card: "
             f"{e!r}")
    torch.cuda.synchronize()
    flow_s = time.perf_counter() - t0
    launches = read_counts(counters)
    missing = [k for k in MESH_PATH if launches[k] <= 0]
    if missing:
        fail(f"tutorials: iclaims never launched {missing}: {launches}")
    model = r["model"]
    p = model.particles
    n_train = len(model.ds)
    if not (p.params.device.type == "cuda" and model.num_particles == 8
            and n_train == 354 and len(r["ds_query"]) == 469):
        fail(f"tutorials: iclaims ran P={model.num_particles}, "
             f"n={n_train}, {len(r['ds_query'])} query points on "
             f"{p.params.device}")
    live = p.lml > smc.BAD_LML
    if not (bool(live.any()) and bool(torch.isfinite(p.lml[live]).all())):
        fail(f"tutorials: iclaims' live LMLs not finite: {p.lml.tolist()}")
    smc.validate_particles(p, model.config, tables=model.tables)
    y_log = r["df"]["y"].to_numpy()
    y_range = float(y_log.max() - y_log.min())
    lml_rel, pred_err = top8_vs_f64_cpu(A, np, torch, model, r["forecasts"],
                                        r["ds_query"], [0.025, 0.975],
                                        y_range)
    if not (lml_rel <= 1e-3 and pred_err <= 1e-3):
        fail(f"tutorials: iclaims on the card vs float64 on the CPU, top 8:"
             f" LML rel {lml_rel:.3e}, predict err / y-range {pred_err:.3e}")
    t1 = time.perf_counter()
    ref = A.from_dict(A.to_dict(model), device="cpu", dtype=torch.float64)
    q_err = max(
        float(np.abs(r[k] - A.predict_quantile(ref, r["ds_q"], q,
                                               tol=1e-6)[0]).max())
        for k, q in (("lo", 0.025), ("md", 0.5), ("hi", 0.975))) / y_range
    ref_s = time.perf_counter() - t1
    if not q_err <= 1e-3:
        fail(f"tutorials: iclaims' quantiles vs float64 on the CPU: "
             f"{q_err:.3e} of the y range (gate 1e-3)")
    rs = model.round_stats
    phase("tutorials", "; ".join(msgs) + f"; iclaims at its full budget "
          f"(N={n_train} of {len(r['df'])} weeks in log space, P=8, "
          f"linear_schedule({n_train}, .20), n_mcmc=50, n_hmc=10, shuffle, "
          f"adaptive_resampling=False): fit {r['fit_s']:.1f} s, the flow "
          f"{flow_s:.1f} s (predict at {len(r['ds_query'])} points, "
          f"predict_quantile x 3 at {len(r['ds_q'])}, predict_mvn); per "
          f"round (step, ESS before resampling, resampled, MH accepted, "
          f"HMC sweeps, parameter-HMC accepted) " + ", ".join(
              f"({q['step']}, {q['ess']:.2f}, {q['resampled']}, "
              f"{q['mh_accepted']}, {q['hmc_sweeps']}, {q['hmc_accepted']})"
              for q in rs)
          + f"; launches { {k: launches[k] for k in MESH_PATH} }; best LML "
          f"{float(p.lml.max()):.3f}; max log-normal mean bias "
          f"{float(np.max(r['bias'])):.6g} (>= -1e-8); top-8 vs f64 CPU: "
          f"LML rel {lml_rel:.3e}, predict err / y-range {pred_err:.3e}; "
          f"quantiles vs f64 CPU {q_err:.3e} of the y range ({ref_s:.1f} "
          f"s); validate_particles ok")
    return launches


class TreeRecorder:
    """Wraps ops.cov.tape (kernel 1's and kernel 5's tapes) while on: the
    tallest stack and longest tape of each batch, and the trees scored
    (each particle of each batch) and those deeper than 8 levels, counted
    on the device."""

    def __init__(self, torch):
        from autogp_tpu_torch import gp_math
        from autogp_tpu_torch.ops import cov
        self.torch, self.cov, self.gp_math = torch, cov, gp_math
        self.orig = cov.tape
        self.max_height = self.max_len = 0
        self.trees = 0
        self.deep = None
        self.depths = {}   # depth cap -> each slot's level (1-based)

    def __enter__(self):
        torch, cov = self.torch, self.cov

        def recording(node_type, depth_cap):
            tp = self.orig(node_type, depth_cap)
            self.max_height = max(self.max_height, tp.max_height)
            self.max_len = max(self.max_len, tp.max_len)
            if depth_cap not in self.depths:
                self.depths[depth_cap] = torch.as_tensor(
                    self.gp_math.slot_depths(depth_cap),
                    device=node_type.device)
            d = torch.where(node_type > 0, self.depths[depth_cap][None],
                            0).amax(1)
            n = (d > 8).sum()
            self.deep = n if self.deep is None else self.deep + n
            self.trees += node_type.shape[0]
            return tp
        cov.tape = recording
        return self

    def __exit__(self, *exc):
        self.cov.tape = self.orig

    def deeper_than_8(self):
        return 0 if self.deep is None else int(self.deep)


def vs_cpu_refs(A, np, torch, model, idx, ds_pred=None, df=None,
                y_range=None, tol=1e-3):
    """The card's LMLs of particles `idx` (and, given `df` = A.predict(model,
    ds_pred, quantiles=[.1, .5, .9]), their predictions over `y_range`)
    against the same particles carried to the CPU (to_dict / from_dict) in
    float64; where one misses by more than `tol`, also what float32
    arithmetic itself gets there: the same carried-over model in float32
    on the CPU (the plain path) against float64. Returns per particle
    (card LML rel err, float32 LML rel err, card predict err / y-range,
    float32 predict err / y-range); the float32 columns are NaN where not
    computed, the predict columns 0 without `df`."""
    d = A.to_dict(model)
    for key in ("kernels", "noise_zs", "noises"):
        d[key] = [d[key][i] for i in idx]
    d["pf_state"]["log_weights"] = [d["pf_state"]["log_weights"][i]
                                    for i in idx]
    cols = ["y_mean", "y_0.1", "y_0.5", "y_0.9"]

    def ref(dt):
        r = A.from_dict(d, device="cpu", dtype=dt)
        pred = None if df is None else A.predict(
            r, ds_pred, quantiles=[.1, .5, .9])[cols].to_numpy().reshape(
                len(idx), len(ds_pred), len(cols))
        return r.particles.lml.double().numpy(), pred
    l64, p64 = ref(torch.float64)
    card = model.particles.lml[torch.as_tensor(
        idx, device=model.device)].double().cpu().numpy()
    out = np.full((len(idx), 4), np.nan)
    out[:, 0] = np.abs(card - l64) / np.abs(l64)
    out[:, 2] = 0.0
    if df is not None:
        got = df[cols].to_numpy().reshape(
            model.num_particles, len(ds_pred), len(cols))[idx]
        out[:, 2] = np.abs(got - p64).max((1, 2)) / y_range
    if (out[:, [0, 2]] > tol).any():
        l32, p32 = ref(torch.float32)
        out[:, 1] = np.abs(l32 - l64) / np.abs(l64)
        out[:, 3] = (0.0 if df is None
                     else np.abs(p32 - p64).max((1, 2)) / y_range)
    return out


def float32_gate(np, errs, tol=1e-3):
    """Per particle, the card's error against float64 may be at most `tol`
    or, where float32 arithmetic on the CPU misses float64 by more than
    tol/2 on the same model, twice that miss: the card is held to float64
    as far as float32 can be, and to float32's own error beyond. `errs`:
    (card err, float32 err) columns, float32's NaN where not computed.
    Returns (ok, a summary)."""
    card, f32 = errs[:, 0], np.nan_to_num(errs[:, 1])
    bound = np.maximum(tol, 2.0 * f32)
    beyond = int((f32 > tol / 2).sum())
    seen = ("" if np.isnan(errs[:, 1]).all() else
            f"; float32 on the CPU {float(f32.max()):.3e}")
    return bool((card <= bound).all()), (
        f"{float(card.max()):.3e} (gate {tol:g}{seen}" + (
            f", the gate twice float32's error on the {beyond} particle(s) "
            f"where float32 misses float64 by more than {tol / 2:g}"
            if beyond else "") + ")")


def deep_greedy(A, np, torch):
    """Phase 19 (a): the reference's greedy configuration on tsdl.161 --
    GPConfig(changepoints=False, max_depth=10), seed 2, fit_greedy(
    max_depth=10) -- then the flow's full-budget hybrid from seed 7,
    fit_greedy_mcmc(n_mcmc=20, n_parallel=4). Gates: AIC non-increasing in
    both, AIC = 2 (k - lml) within 1e-6, the final LMLs within 1e-3 of
    float64 on the CPU (float32_gate: or within twice float32's own miss on
    the CPU, where that is above 5e-4). Returns a summary."""
    from autogp_tpu_torch.inference import greedy as G
    from autogp_tpu_torch.scripts.tutorials._common import load_tsdl161
    df = load_tsdl161()
    ds, y = df["ds"], df["y"].to_numpy()
    cfg = A.GPConfig(changepoints=False, max_depth=10)
    msgs = []
    for part in ("fit_greedy(max_depth=10)",
                 "fit_greedy_mcmc(n_mcmc=20, n_parallel=4)"):
        steps = []
        rec = TreeRecorder(torch)
        t0 = time.perf_counter()
        with rec:
            if part.startswith("fit_greedy("):
                A.seed(2)
                m = A.GPModel(ds, y, n_particles=1, config=cfg)

                def cb(*, model, step, aic, elapsed, **kw):
                    steps.append((step, aic, str(model.covariance_kernels(
                        reparameterize=False)[0])))
                A.fit_greedy(m, max_depth=10, callback_fn=cb)
            else:
                A.seed(7)
                m = A.GPModel(ds, y, n_particles=1, config=cfg)
                A.fit_greedy_mcmc(
                    m, n_mcmc=20, n_parallel=4,
                    callback_fn=lambda *, step, aic, accepted, **kw:
                    steps.append((step, aic, accepted)))
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        aics = [a for _, a, _ in steps]
        if not steps or not all(b <= a for a, b in zip(aics, aics[1:])):
            fail(f"deep (a): {part}: AICs not non-increasing: {aics}")
        lml = float(m.particles.lml[0])
        k = int(G.n_params(m.particles.node_type[0], cfg.noise is None))
        aic_err = abs(aics[-1] - 2.0 * (k - lml)) / abs(aics[-1])
        ok, lml_msg = float32_gate(
            np, vs_cpu_refs(A, np, torch, m, [0])[:, :2])
        if not (aic_err <= 1e-6 and ok):
            fail(f"deep (a): {part}: AIC {aics[-1]} vs 2 (k - lml) = "
                 f"{2.0 * (k - lml)} (rel {aic_err:.1e}), final LML vs "
                 f"float64 CPU rel {lml_msg}")
        if part.startswith("fit_greedy("):
            detail = "per stage (step, AIC, structure, candidates, probes) " \
                + ", ".join(f"({s_}, {a:.4f}, {st}, {r['candidates']}, "
                            f"{r['probes']})"
                            for (s_, a, st), r in zip(steps, m.round_stats))
        else:
            detail = "AICs " + ", ".join(
                f"{a:.4f}{'*' if acc else ''}" for _, a, acc in steps) \
                + " (* accepted)"
        msgs.append(f"{part} {sec:.1f} s: {detail}; final LML {lml:.4f} "
                    f"(vs float64 CPU rel {lml_msg}), AIC = 2 (k - lml) "
                    f"with k = {k} (rel {aic_err:.1e}); tallest stack "
                    f"{rec.max_height}, longest tape {rec.max_len}, "
                    f"{rec.trees} trees scored, {rec.deeper_than_8()} "
                    f"deeper than 8 levels")
    return "(a) " + "; ".join(msgs)


def deep_config4(A, np, torch, t_days, y, ds_future, sched, e2e_ms):
    """Phase 19 (b): config 4's fit (phase 8's series, schedule and
    widths, seed 1) with GPConfig(static_max_depth=10): the prior's LMLs
    (8 particles) against float64 on the CPU, fit_smc(n_mcmc=10,
    n_hmc=10) timed (CUDA events), predict at 32 points, the 8 heaviest
    particles' LMLs and predictions (over the y range) within 1e-3 of
    float64 on the CPU (float32_gate per particle), validate_particles.
    Returns (model, summary)."""
    from autogp_tpu_torch.inference import smc
    cfg = A.GPConfig(static_max_depth=10)
    A.seed(1)
    with TreeRecorder(torch) as rec:
        m = A.GPModel(t_days, y, n_particles=P_MAIN, config=cfg)
        alive = (m.particles.lml > smc.BAD_LML).nonzero()[:, 0].tolist()
        prior = vs_cpu_refs(A, np, torch, m, alive[:8])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        A.fit_smc(m, schedule=sched, n_mcmc=10, n_hmc=10)
        ev[1].record()
        df = A.predict(m, ds_future, quantiles=[.1, .5, .9])
        ev[2].record()
        torch.cuda.synchronize()
    fit_ms, pred_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    smc.validate_particles(m.particles, m.config, tables=m.tables)
    w = m.particle_weights()
    alive = (m.particles.lml > smc.BAD_LML).cpu().numpy()
    top = [int(i) for i in np.argsort(-w) if alive[i]][:8]
    fitted = vs_cpu_refs(A, np, torch, m, top, ds_future, df,
                         y.max() - y.min())
    gates = [float32_gate(np, e) for e in (prior[:, :2], fitted[:, :2],
                                       fitted[:, 2:])]
    msg_p, msg_l, msg_x = (g[1] for g in gates)
    if not all(g[0] for g in gates):
        fail(f"deep (b): float32 card vs float64 CPU: prior LMLs rel "
             f"{msg_p}, fitted top-8 LMLs rel {msg_l}, predict err / "
             f"y-range {msg_x}")
    depth = A.GPConfig().depth_cap
    return m, (
        f"(b) config 4 with static_max_depth=10 (1023-slot heaps): prior "
        f"LMLs of 8 particles vs float64 CPU rel {msg_p}; fit_smc "
        f"{fit_ms:.1f} ms (phase 8 at depth cap {depth}: {e2e_ms:.1f} ms), "
        f"predict(32) {pred_ms:.1f} ms; top-8 vs float64 CPU: LML rel "
        f"{msg_l}, predict err / y-range {msg_x}; "
        f"{rec.trees} trees scored through kernel 1's tapes, "
        f"{rec.deeper_than_8()} deeper than 8 levels, tallest stack "
        f"{rec.max_height}, longest tape {rec.max_len}; best LML "
        f"{float(m.particles.lml.max()):.3f}; validate_particles ok")


def deep_components(A, np, torch, model_b):
    """Phase 19 (c): the 9-level particle of tests/test_torch_decompose.py
    (test_predict_mvn_sum_deep_components) on the card -- predict_mvn_sum
    by GP.Periodic against the float64 host construction of its blocks
    (mean and covariance within 1e-3 normwise), its decompose's fragment
    LMLs against float64 on the CPU -- and decompose on phase (b)'s model
    (its 4 heaviest particles' fragments, kernel 1's float64 entry on
    1023-slot heaps). Returns a summary."""
    from autogp_tpu_torch import gp_math
    GP = A.GP
    inner = GP.ChangePoint(GP.Periodic(0.3, 0.2, 1.0),
                           GP.Linear(0.1, 0.2, 0.3), 0.4, 1e-3)
    k = inner
    for i in range(3):
        k = (k + GP.SquaredExponential(0.2 + 0.1 * i, 0.8)) * (
            GP.Periodic(0.4, 0.3 + 0.1 * i, 0.9) + GP.Linear(0.2, 0.3, 0.4))
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = A.GPConfig(static_max_depth=k.depth)
    ds = np.linspace(0, 3, 20)
    m = A.GPModel(ds, np.cos(2 * ds), n_particles=1, config=cfg)
    m = A.gp_model_from_kernels(m, [k])
    comps = A.api.sum_components(m, GP.Periodic)[0]
    ds_pred = np.linspace(3, 3.5, 4)
    mix, idx = A.predict_mvn_sum(m, ds_pred, GP.Periodic)
    ts, xs, tsp = m._ds_numeric(), m._y_numeric(), m._ds_numeric(ds_pred)
    nodes = GP.split_kernel_sop(k, GP.Periodic)
    blocks = [torch.as_tensor(np.stack([f(kk) for kk in nodes]))[None]
              for f in (lambda kk: GP.eval_cov(kk, ts),
                        lambda kk: GP.eval_cov(kk, ts, tsp),
                        lambda kk: GP.eval_cov(kk, tsp))]
    noise = m.observation_noise_variances(reparameterize=False)
    mu, cv = gp_math.infer_gp_sum_from_blocks(
        *blocks, torch.tensor(noise, dtype=torch.float64),
        torch.as_tensor(xs), torch.ones(len(ts), dtype=torch.float64))
    mu, cv = m.y_transform.unapply_mean_var(mu[0].numpy(), cv[0].numpy())
    mu[idx["F"][0]] += m.y_transform.intercept / m.y_transform.slope
    e_mu = float(np.abs(mix.components[0].mean - mu).max()
                 / np.abs(mu).max())
    e_cv = float(np.abs(mix.components[0].cov - cv).max()
                 / np.abs(cv).max())
    if not (e_mu <= 1e-3 and e_cv <= 1e-3):
        fail(f"deep (c): predict_mvn_sum on the 9-level particle vs the "
             f"float64 host construction: mean {e_mu:.3e}, cov {e_cv:.3e} "
             f"(gates 1e-3)")
    _, frag9, _ = fragment_lml_check(A, np, torch, m)
    _, frag_b, f64_launches = fragment_lml_check(A, np, torch, model_b,
                                                 top=4)
    return (f"(c) the 9-level particle (components up to depth "
            f"{max(c.depth for c in comps)}): predict_mvn_sum vs float64 host "
            f"blocks: mean {e_mu:.3e}, cov {e_cv:.3e} (gates 1e-3); its "
            f"decompose: {frag9}; decompose of (b)'s model: {frag_b}, "
            f"kernel 1 float64 launches {f64_launches}")


def recode_times(np, torch, gen):
    """Kernels 1, 6, 5, 5c, 5b and 7 at [64, 1024, 1024], 768 points
    active, on 64 prior trees of depth cap 5 and on the same trees
    re-encoded at depth cap 10: the wrapper's ms (CUDA events; at cap 10 it
    reads the batch's tape maxima back) at both caps in turns (5, 10, 10,
    5), and the kernels' device ms (device_ms) once at each; kernel 1's
    float64 entry at [8, 1024, 1024]. Returns {kernel-line name: (wrapper
    ms at cap 5, at cap 10, device ms at cap 5, at cap 10)}."""
    from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv
    nt5, pt5, noise = deep_batch(np, torch, gen, 5, [], P_MAIN)
    pad = 1023 - 31
    nt10 = torch.nn.functional.pad(nt5, (0, pad))
    pt10 = torch.nn.functional.pad(pt5, (0, 0, 0, pad))
    n_act = 3 * N_MAIN // 4
    ts = torch.zeros(N_MAIN, device="cuda")
    ts[:n_act] = torch.linspace(0, 1, n_act, device="cuda")
    mask = (torch.arange(N_MAIN, device="cuda") < n_act).float()
    xs = torch.sin(12 * ts) * mask
    K = cov.cov_tape(nt5, pt5, noise, ts, ts, mask, mask, 5, True, True)
    _, a, wd, L = chol.chol_solve_strips(K, xs.expand(P_MAIN, -1))
    Ki, beta, _ = kinv.kinv_beta_strips(a, wd, L)
    V, _, _ = kinv.linv_beta(L, a, wd)
    del K, L, wd, a
    g1 = torch.ones(P_MAIN, device="cuda")
    kbar = torch.randn(P_MAIN, N_MAIN, N_MAIN, generator=gen, device="cuda")
    d64 = [x.double() for x in (pt5[:8], pt10[:8], noise[:8], ts, mask)]
    calls = {
        "cov_tape": lambda nt, pt, D: cov.cov_tape(
            nt, pt, noise, ts, ts, mask, mask, D, True, True),
        "cov_slot": lambda nt, pt, D: cov.cov_matrix(nt, pt, noise, ts,
                                                     mask, D),
        "cov_tape_bwd": lambda nt, pt, D: cov_vjp.cov_tape_bwd(
            nt, pt, ts, mask, Ki, beta, g1, D),
        "cov_tape_bwd_linv": lambda nt, pt, D: cov_vjp.cov_tape_bwd_linv(
            nt, pt, ts, mask, V, beta, g1, D),
        "cov_tape_bwd_unfused": lambda nt, pt, D: cov_vjp.cov_grads_tape(
            nt, pt, kbar, ts, mask, D),
        "cov_slot_bwd": lambda nt, pt, D: cov_vjp.cov_grads(
            nt, pt, kbar, ts, mask, D),
        "cov_tape_f64": lambda nt, pt, D: cov.cov_tape(
            nt[:8], d64[0] if D == 5 else d64[1], d64[2], d64[3], d64[3],
            d64[4], d64[4], D, True, True)}
    kernels = {"cov_tape": ("cov_tape_kernel",),
               "cov_slot": ("cov_slot_kernel",),
               "cov_tape_f64": ("cov_tape_f64_kernel",),
               "cov_slot_bwd": ("heap_tape_kernel", "cov_tape_bwd_kernel",
                                "reduce_tiles_kernel")}
    out = {}
    for name, fn in calls.items():
        t = {5: [], 10: []}
        for D in (5, 10, 10, 5):
            nt, pt = (nt5, pt5) if D == 5 else (nt10, pt10)
            t[D].append(cuda_ms(torch, lambda: fn(nt, pt, D), 5))
        dev = [device_ms(torch, lambda: fn(nt, pt, D), kernels.get(
            name, ("cov_tape_bwd_kernel", "reduce_tiles_kernel")), 3)
            for nt, pt, D in ((nt5, pt5, 5), (nt10, pt10, 10))]
        out[name] = (sum(t[5]) / 2, sum(t[10]) / 2, *dev)
    return out


def deep_phase(A, np, torch, t_days, y, ds_future, sched, e2e_ms):
    """Phase 19: depth caps the JAX package takes and kernel 1 once did
    not, on the card. Every launch counter zeroed, then (a) deep_greedy,
    (b) deep_config4, (c) deep_components, the counters read: kernels 1,
    1 f64, 2, 3, 4 and 5 must launch. Then (d), kernel gates that do not
    count: deep_kernel_rows at depth caps 9, 10 and 12, full_tree_rows,
    recode_rows, overlong_rows, and recode_times. Returns (the path's
    launches by kernels-line row, recode_times)."""
    t0 = time.perf_counter()
    counters = row_counters()
    zero_counts(counters)
    msg_a = deep_greedy(A, np, torch)
    model_b, msg_b = deep_config4(A, np, torch, t_days, y, ds_future,
                                  sched, e2e_ms)
    msg_c = deep_components(A, np, torch, model_b)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    need = ("cov_tape", "cov_tape_f64", "chol_panel", "linv_stats_wd",
            "kinv_beta_strips", "cov_tape_bwd")
    if min(launches[k] for k in need) <= 0:
        fail(f"deep: a kernel of the path never launched: {launches}")
    path_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = []
    for depth in (9, 10, 12):
        rows += deep_kernel_rows(np, torch, gen, depth)
    rows += full_tree_rows(np, torch, gen)
    rows += recode_rows(np, torch, gen)
    rows += overlong_rows(np, torch)
    bad = gate_failures(rows)
    if bad:
        fail(f"deep (d): {rows_text(bad)}")
    times = recode_times(np, torch, gen)
    phase("deep", f"{msg_a}; {msg_b}; {msg_c}; path {path_s:.1f} s, "
          f"launches {launches}; (d) {len(rows)} kernel gates held at depth "
          f"caps 9, 10, 12 and on the full depth-9 tree: "
          f"{rows_text(rows)}; ms at depth caps 5 / 10 on the same trees "
          f"([64, 1024, 1024], 768 active; 1 f64 at [8, 1024, 1024]), "
          f"wrapper (device): " + ", ".join(
              f"{k} {a:.4f} / {b:.4f} ({c:.4f} / {d:.4f})"
              for k, (a, b, c, d) in times.items()))
    return launches, times


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
    # lauum), both on the tensor cores in 3xTF32 (three TF32 products for
    # each FP32 one). Read L, Wd, alpha once, write K^-1, beta, fro once.
    sub_tf32 = 3 * P_MAIN * N_MAIN ** 3 / 3
    kprod_tf32 = 3 * P_MAIN * N_MAIN ** 3 / 3
    kinv_bound = bound(0, 0, 4 * (2 * NN + P_MAIN * N_MAIN * Bk + 3 * P_MAIN
                                  * N_MAIN), tf32=sub_tf32 + kprod_tf32)
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

    # kinv_lower_kernel (K^-1 = X^T X, X = L^-1) alone, beside its own
    # bound (N^3 / 3 in 3xTF32; the lower X read once, K^-1 written once)
    # and one FP32 bmm of the full square (TF32 off) as a yardstick.
    X_s = kinv.linv_beta(L_s, a_s, wd_s)[0]
    kl_ms = device_ms(torch, lambda: kinv.kinv_beta_strips(a_s, wd_s, L_s),
                      ("kinv_lower_kernel",), 5)
    kl_bound = bound(0, 0, 4 * (P_MAIN * N_MAIN * (N_MAIN + 1) // 2 + NN),
                     tf32=kprod_tf32)
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kl_lib_ms = cuda_ms(torch, lambda: torch.bmm(X_s.mT, X_s), 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    del X_s
    phase("kinv_lower", f"kinv_lower_kernel alone at [64, 1024, 1024] "
          f"{kl_ms:.4f} ms, bound {kl_bound[0]:.4f} ms ({kl_bound[2]}); "
          f"torch.bmm(X^T, X) in FP32 with TF32 off (the full square, twice "
          f"the lower blocks' work) {kl_lib_ms:.4f} ms")

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
    model8 = model   # phase 14's model
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
    kinvb_bound = bound(wd_flops, 0, 4 * (2 * NN + 2 * P_MAIN * N_MAIN),
                        tf32=sub_tf32 + kprod_tf32)
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
    # n (n + 1) (n + 2) / 3 flops per particle, on the tensor cores in
    # 3xTF32 (three TF32 products each); the active lower triangle of L^-1
    # and the active beta read once.
    ktile_flops = P_MAIN * n_act * (n_act + 1) * (n_act + 2) / 3
    linv_bwd_bound = bound(sum(c[0] for c in bwd_c) * n_low,
                           sum(c[1] for c in bwd_c) * n_low,
                           4 * P_MAIN * (n_low + n_act),
                           tf32=3 * ktile_flops)
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
    # The online run's dense-route bucket: kernel 6 beside kernel 1's full
    # gram on the same inputs (wrapper, kernel alone).
    ts32, mask32 = grid(32, 24)
    small = {
        "kernel 6": (lambda: cov.cov_matrix(nt, pt, noise, ts32, mask32, D,
                                            masked=True), "cov_slot_kernel"),
        "kernel 1": (lambda: cov.cov_tape(nt, pt, noise, ts32, ts32, mask32,
                                          mask32, D, gram=True),
                     "cov_tape_kernel")}
    small_ms = {k: (cuda_ms(torch, f, 200), device_ms(torch, f, (n,), 50))
                for k, (f, n) in small.items()}
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
          f"{slot_bound[0]:.4f} ms ({slot_bound[1]}); at [64, 32, 32] with "
          f"24 active, ms (wrapper, kernel alone): "
          + ", ".join(f"{k} ({a:.4f}, {b:.4f})"
                      for k, (a, b) in small_ms.items()))

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
    given, outs = {}, {}
    gen32 = torch.Generator(device=dev).manual_seed(32)
    kbar32 = torch.randn(P_MAIN, 32, 32, generator=gen32, device=dev)
    for name, fn, knames in (
            ("bwd_unfused", cov_vjp.cov_grads_tape,
             ("cov_tape_bwd_kernel", "reduce_tiles_kernel")),
            ("kernel7", cov_vjp.cov_grads,
             ("heap_tape_kernel", "cov_tape_bwd_kernel",
              "reduce_tiles_kernel"))):
        def run_given():
            return fn(nt, pt, kbar, ts, mask, D, masked=True)
        pb_g, nb_g = run_given()
        pb_g2, nb_g2 = run_given()
        torch.cuda.synchronize()
        if not (torch.equal(pb_g, pb_g2) and torch.equal(nb_g, nb_g2)):
            fail(f"{name}: two runs on the same inputs differ")
        outs[name] = (pb_g, nb_g)
        if name == "kernel7" and not (
                torch.equal(pb_g, outs["bwd_unfused"][0])
                and torch.equal(nb_g, outs["bwd_unfused"][1])):
            fail("kernel 7 is not bitwise 5b on the same cotangent")
        e_p = per_particle_rel(pb_g, pr)[ok_g]
        e_n = ((nb_g.double() - nr).abs() / nr.abs().clamp_min(1.0))[ok_g]
        if not (float(e_p.max()) <= 1e-3 and float(e_n.max()) <= 1e-5):
            fail(f"{name} vs f64 plain on the same cotangent: worst pbar "
                 f"{float(e_p.max()):.3e}, nbar {float(e_n.max()):.3e}")
        given[name] = (float((pb_g.double() - pr).abs()[ok_g].max()),
                       cuda_ms(torch, run_given, 5),
                       device_ms(torch, run_given, knames, 3))

        def run_32():
            return fn(nt, pt, kbar32, ts32, mask32, D, masked=True)
        ms_32 = (cuda_ms(torch, run_32, 200),
                 device_ms(torch, run_32, knames, 50))
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
              f"({given_bound[1]})"
              + ("; bitwise 5b on the same cotangent" if name == "kernel7"
                 else "")
              + f"; at [64, 32, 32] with 24 active, ms (wrapper, kernels "
              f"alone) ({ms_32[0]:.4f}, {ms_32[1]:.4f})")
    del kbar, pr, outs

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

    # ---- 13. greedy: config 3 ----------------------------------------
    launches_c3 = greedy_phase(A, np, torch)

    # ---- 14. decompose: the decomposition API on phase 8's model -------
    launches_decomp, f64_row = decompose_phase(A, np, torch, model8,
                                               ds_future, [.1, .5, .9])

    # ---- 15. depth: depth-annealed SMC on config 4's series ------------
    launches_depth = depth_phase(A, np, torch, t_days, y)

    # ---- 16. config2: HMC on a fixed structure ------------------------
    launches_c2 = config2_phase(A, np, torch)

    # ---- 17. mesh: config 4 as two ranks through GPModel(mesh=) --------
    launches_mesh = mesh_phase(A, np, torch, t_days, y, ds_future, sched)

    # ---- 18. tutorials: the five flows, iclaims at its full budget -----
    launches_tut = tutorials_phase(A, np, torch)

    # ---- 19. deep: depth caps above 8 through every tape kernel ---------
    launches_deep, deep_times = deep_phase(A, np, torch, t_days, y,
                                           ds_future, sched, fit_ms8)

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
    # Kernel 1's float64 entry: phase 14's decompose of phase 8's model.
    launches["cov_tape_f64"] = f64_row["launches"]

    def entry(name, src, replaces, err, ms, dev_ms, plain_ms, bnd, lib_ms):
        return {"name": name, "route": "cuda",
                "source": f"autogp_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms,
                "device_ms": None if math.isnan(dev_ms) else dev_ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "pipe": bnd[2], "library_ms": lib_ms,
                "launches_config3": launches_c3[name],
                "launches_predict_mvn_sum": launches_decomp[name],
                "launches_depth": launches_depth[name],
                "launches_config2": launches_c2[name],
                "launches_mesh_rank0": launches_mesh[name],
                "launches_tutorials": launches_tut[name],
                "launches_deep": launches_deep[name],
                "ms_cap5_cap10": deep_times.get(name)}

    kernels = [
        entry("cov_tape", "cov_tape.cu", "autogp_tpu/ops/cov_pallas.py:252",
              cov_err, cov_ms, cov_dev_ms, cov_plain_ms, cov_bound, None),
        entry("cov_tape_f64", "cov_tape_f64.cu",
              "autogp_tpu/ops/cov_pallas.py:252", f64_row["abs_err"],
              f64_row["ms"], f64_row["dev_ms"], f64_row["plain_ms"],
              f64_row["bound"], None),
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
