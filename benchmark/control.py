"""Readings that set the limits of `correct`: the program's and the
control's, seed after seed, in one process.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,...
                                 [--units N] [--pinned]

For each seed it runs the cell's units as a run does (`--units` of
them; for a stream, after the set-up fit), with the cell's pinned data,
fits and posteriors replaced by ones drawn from that seed (`drawn`), so
that a dozen seeds read a dozen series and posteriors (with --pinned,
the cell's own data, fits and posteriors, as its runs have them); then it
judges them with `check.readings`: the program's numbers against the
reference, and the control's, the reference computed in TF32 put in the
program's place on the same particles. One JSON line per seed, then the
largest program reading and the smallest control reading of each number.
The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from benchmark import run as R
from benchmark import workload as W


def drawn(traffic: dict, seed: int) -> dict:
    """The traffic with its pinned seeds replaced by ones from `seed`."""
    out = dict(traffic, series=dict(traffic["series"], seed=seed))
    if "fit_seeds" in out:
        out["fit_seeds"] = [W.derive_seed(seed, 1, i)
                            for i in range(len(out["fit_seeds"]))]
    if "posteriors" in out:
        out["posteriors"] = [seed]
    return out


def readings_for_seed(A, config, traffic, seed, units, device,
                      pinned=False):
    if not pinned:
        traffic = drawn(traffic, seed)
    unit = W.make_unit(A, config, traffic, seed, device)
    unit.setup()
    from benchmark import recorders as Rec
    picker = R.Picker(traffic, seed)
    keep = Rec.Keep()
    times = []
    for index in range(units):
        t0 = time.perf_counter()
        record = unit.run(index)
        unit.sync()
        times.append(time.perf_counter() - t0)
        picker.see(index, record, times[-1], keep.take())
    keep.close()
    del unit
    got, ctl = R.judge_units(picker.units(), config, traffic, device)
    got["failed_share"] = picker.failed / units
    return got, ctl, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, default=None)
    ap.add_argument("--pinned", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    _, _, config, traffic = R.load_cell(args.workload)
    traffic["check"] = dict(traffic["check"], control=True)
    units = args.units or traffic["check"]["among"]
    import autogp_tpu_torch as A
    seeds = [int(s) for s in args.seeds.split(",")]
    warm = W.make_unit(A, config, drawn(traffic, seeds[0]), seeds[0],
                       device)
    warm.setup()
    del warm
    worst, least = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        got, ctl, times = readings_for_seed(A, config, traffic, seed, units,
                                            device, args.pinned)
        for k, v in got.items():
            worst[k] = max(worst.get(k, -math.inf), v)
        for k, v in ctl.items():
            least[k] = min(least.get(k, math.inf), v)
        print(json.dumps({"seed": seed, "program": got, "control": ctl,
                          "unit_s": times,
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"program_max": worst, "control_min": least}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
