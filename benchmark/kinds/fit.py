"""A closed loop of whole fits: each from a fresh `GPModel` on the
traffic's series (its noise from the series' pinned "seed"), `fit_smc`
at the traffic's schedule, then the forecast. The fits are the traffic's
"fit_seeds", cycled from where --seed says, and a timed window ends with
a whole cycle: every run does the same fits in another order. Set-up is one warm-up fit at the traffic's "warmup"
MH steps and HMC sweeps, which touches every bucket of the schedule."""

import numpy as np

from benchmark import workload as W


# A traced run profiles one fit.
TRACE_SHARE = 0.0


def end_to_end(window_s, durations) -> dict:
    return {"fit_s": window_s / len(durations)}


class Unit(W.Unit):

    def __init__(self, A, config, traffic, seed, device):
        super().__init__(A, config, traffic, seed, device)
        self.t, self.y = W.series(traffic["series"],
                                  traffic["series"]["seed"])
        self.fit_seeds = list(traffic["fit_seeds"])
        self.cycle = len(self.fit_seeds)

    def setup(self):
        w = self.traffic["warmup"]
        self.fit(W.derive_seed(self.fit_seed(0), 0), w["n_mcmc"],
                 w["n_hmc"])

    def fit_seed(self, index: int) -> int:
        return self.fit_seeds[(self.seed + index) % len(self.fit_seeds)]

    def fit(self, seed, n_mcmc, n_hmc):
        A = self.A
        A.seed(seed)
        m = A.GPModel(self.t, self.y, n_particles=self.P,
                      config=self.gp_config, device=self.device)
        self.fit_smc(m, A.Schedule.linear_schedule(
            len(self.t), self.traffic["schedule_fraction"]), n_mcmc, n_hmc)
        n = len(self.t)
        ds = np.arange(n, n + self.n_future, dtype=np.float64)
        df = self.forecast(m, ds)
        self.sync()
        return m, ds, df

    def run(self, index: int) -> dict:
        m, ds, df = self.fit(W.derive_seed(self.fit_seed(index), 1),
                             self.cfg["n_mcmc"], self.cfg["n_hmc"])
        # The last reweight's earlier data is the shuffled prefix the
        # previous round held (`check.previous_data` takes the shuffle).
        return {"particles": m.particles, "t": self.t, "y": self.y,
                "t_fit": self.t, "y_fit": self.y, "future": ds, "df": df}
