"""End-to-end times of the fits and predictions, for one or more source
trees of this repo, in turns A B B A on one card.

Each turn is a process of its own that imports `autogp_tpu_torch` from the
given tree (its kernels built there) and, after a warm-up fit, times with
CUDA events:

  - config 4's fit (utils/profile_fit.py's `config4` workload: 64
    particles, N = 1024, linear_schedule(1024, .25), n_mcmc=10, n_hmc=10);
  - on that fitted model, at 32 points: predict (3 quantiles),
    predict_mvn and predict_proba, each after one untimed call;
  - config 3's greedy fit (profile_fit's `config3` workload).

It prints the card line, one JSON object per turn, and then each tree's
times (the mean of its two turns) beside the first tree's, and whether
every turn's config-4 LMLs are bitwise the first tree's (a digest of
their bytes).

Usage:
    python3 -m autogp_tpu_torch.scripts.fit_ab TREE [TREE ...]
"""

import hashlib
import json
import os
import subprocess
import sys

CHILD = "--child"


def _child(root):
    sys.path = [root] + [p for p in sys.path[1:]]
    import numpy as np
    import torch
    import autogp_tpu_torch as A
    from autogp_tpu_torch.utils import profile_fit as PF
    assert os.path.dirname(os.path.dirname(A.__file__)) == root, A.__file__

    def events(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        out = fn()
        ev[1].record()
        ev[1].synchronize()
        return out, ev[0].elapsed_time(ev[1])

    c4 = PF._workload(A, "config4")
    PF._fit(A, c4, seed=0, n_mcmc=1, n_hmc=1)
    m, fit4 = events(lambda: PF._fit(A, c4, seed=1))
    ds = np.arange(1024, 1056, dtype=np.float64)
    y = np.zeros(32)
    preds = {
        "predict": lambda: A.predict(m, ds, quantiles=[.1, .5, .9]),
        "predict_mvn": lambda: A.predict_mvn(m, ds),
        "predict_proba": lambda: A.predict_proba(m, ds, y)}
    out = {"tree": root, "config4_fit_ms": fit4,
           "config4_lml_sha256": hashlib.sha256(
               m.particles.lml.cpu().numpy().tobytes()).hexdigest()}
    for name, fn in preds.items():
        fn()
        out[f"{name}_ms"] = events(fn)[1]
    c3 = PF._workload(A, "config3")
    out["config3_fit_ms"] = events(lambda: PF._fit(A, c3, seed=1))[1]
    print(json.dumps(out), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == [CHILD]:
        return _child(os.path.abspath(argv[1]))
    roots = [os.path.abspath(r) for r in argv]
    if not roots:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    order = list(range(len(roots))) + list(reversed(range(len(roots))))
    runs = [[] for _ in roots]
    for i in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), CHILD,
                            roots[i]], cwd=roots[i], capture_output=True,
                           text=True)
        if r.returncode != 0:
            sys.stderr.write(r.stdout + r.stderr)
            raise SystemExit(f"turn on {roots[i]} failed ({r.returncode})")
        line = r.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[i].append(json.loads(line))
    keys = [k for k in runs[0][0] if k.endswith("_ms")]
    for root, rs in zip(roots, runs):
        mean = {k: sum(x[k] for x in rs) / len(rs) for k in keys}
        base = {k: sum(x[k] for x in runs[0]) / len(runs[0]) for k in keys}
        same = all(x["config4_lml_sha256"] == runs[0][0]["config4_lml_sha256"]
                   for x in rs)
        print(f"{root}: " + ", ".join(
            f"{k} {mean[k]:.1f} ({mean[k] / base[k]:.3f}x)" for k in keys)
            + f"; config-4 LMLs bitwise the first tree's: {same}",
            flush=True)


if __name__ == "__main__":
    main()
