"""Rolling windows over a fixed set of posteriors. The traffic's
"posteriors" are seeds: each gives a series (the traffic's "series" with
its noise from that seed) and a set-up fit of its first `window` points
(seeded from it), so that every run starts from the same posteriors.
Update k goes to posterior (--seed + k) mod their number: it drops that
posterior's oldest point, adds its next, resamples below the ESS
threshold, runs `mcmc_structure` and forecasts the next points. The next
observation arrives when the update is done; the updates' draws come
from --seed."""

import numpy as np

from benchmark import workload as W


# A traced run profiles the updates of a third of --seconds.
TRACE_SHARE = 1 / 3


def end_to_end(window_s, durations) -> dict:
    return {"update_ms": window_s / len(durations) * 1e3,
            "update_p85_ms": float(np.quantile(durations, 0.85)) * 1e3}


class Unit(W.Unit):

    def __init__(self, A, config, traffic, seed, device):
        super().__init__(A, config, traffic, seed, device)
        self.posteriors = list(traffic["posteriors"])
        self.data = [W.series(traffic["series"], s) for s in self.posteriors]
        self.W = int(traffic["window"])

    def setup(self):
        A, W_ = self.A, self.W
        if len(self.data[0][0]) < W_ + 1 + self.n_future:
            raise ValueError("the series is shorter than one update")
        self.models = []
        for s, (t, y) in zip(self.posteriors, self.data):
            A.seed(W.derive_seed(s, 0, 0))
            m = A.GPModel(t[:W_], y[:W_], n_particles=self.P,
                          config=self.gp_config, device=self.device)
            self.fit_smc(m, A.Schedule.linear_schedule(
                W_, self.traffic["setup_schedule_fraction"]),
                self.cfg["n_mcmc"], self.cfg["n_hmc"])
            self.models.append(m)
        self.steps = [0] * len(self.models)
        self.k = 0
        A.seed(W.derive_seed(self.seed, 1, 0))
        self.sync()

    def snapshot(self):
        return ([(m.particles, m.ds.copy(), m.y.copy()) for m in self.models],
                list(self.steps), self.k)

    def restore(self, state):
        models, steps, self.k = state
        for m, (p, ds, y) in zip(self.models, models):
            m.particles, m.ds, m.y = p, ds, y
        self.steps = list(steps)
        self.A.seed(W.derive_seed(self.seed, 1, self.k))

    def run(self, index: int) -> dict:
        A = self.A
        j = (self.seed + self.k) % len(self.models)
        m, (t, y), k = self.models[j], self.data[j], self.steps[j]
        i = self.W + k
        if i + 1 + self.n_future > len(t):
            raise RuntimeError("the series ran out: lengthen the traffic's "
                               "series")
        A.api.remove_data(m, t[k:k + 1])
        A.api.add_data(m, t[i:i + 1], y[i:i + 1])
        A.api.maybe_resample(m, self.P * self.traffic["ess_fraction"])
        A.api.mcmc_structure(m, self.cfg["n_mcmc"], self.cfg["n_hmc"],
                             hmc_config=self.hmc)
        ds = t[i + 1:i + 1 + self.n_future]
        df = self.forecast(m, ds)
        self.steps[j] = k + 1
        self.k += 1
        return {"particles": m.particles, "t": t[:self.W], "y": y[:self.W],
                "t_fit": t[k + 1:i + 1], "y_fit": y[k + 1:i + 1],
                "t_prev": t[k + 1:i], "y_prev": y[k + 1:i],
                "future": ds, "df": df}
