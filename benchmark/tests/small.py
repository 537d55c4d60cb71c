"""Cells cut to a size that a test run on the CPU can hold."""


from benchmark import workload as W

SEED = 2 ** 32 + 13


def small(n_particles=8, n_points=64, window=48, n_mcmc=2, n_hmc=2,
          traffic_file=None):
    """An override for `run.run_cell`: the cell's own loop and checks on
    a short series and a few particles; `traffic_file` runs another
    traffic file of `workloads/` (one with a forecast) in the cell's
    place."""
    def override(config, traffic):
        if traffic_file is not None:
            traffic = W.load_json(W.ROOT / "workloads"
                                  / f"{traffic_file}.json")
        config = dict(config, n_mcmc=n_mcmc, n_hmc=n_hmc)
        # Data, fits and posteriors of their own: at this size the cell's
        # pinned work may accept no move at all.
        traffic = dict(traffic, n_particles=n_particles)
        traffic["series"] = dict(traffic["series"], n=(
            n_points if traffic["kind"] == "fit" else window + 60), seed=SEED)
        if traffic["kind"] == "fit":
            traffic["fit_seeds"] = [SEED, SEED + 1]
        else:
            traffic["window"] = window
            traffic["posteriors"] = [SEED, SEED + 1]
        if traffic["forecast"]["points"]:
            traffic["forecast"] = dict(traffic["forecast"], points=8)
        traffic["check"] = dict(traffic["check"], block=4, among=2,
                                units=2)
        return config, traffic
    return override
