"""The comparison that decides `correct`: what the timed path produced,
judged by the plain reference (`reference/gp.py`).

Every number is a gap between the program's answer and the reference's,
worked out again from the benchmark's own inputs: the raw series, the
transforms AutoGP defines (time onto [0, 1] by min and max; values
centred by their mean and divided by their range), and the particles'
stored structures, whitened parameters and noise, which are the answers
being judged.

- `lml_gap`: the widest gap between a particle's stored log marginal
  likelihood and the reference's on the same data, per data point.
- `dead_share`: the share of particles whose stored likelihood is not
  finite (the program's mark for a failed factorization).
- `forecast_gap`: the widest gap between a forecast number (mean or
  quantile, each particle, each point) and the reference's, over the
  reference's predictive standard deviation there.
- `unmoved`: 1 when the last rejuvenation left every particle as it was
  (an exact check, limit 0).
- `grad_gap_med`, `grad_gap_max`: of one parameter-gradient call of
  parameter HMC on the unit's last data (the recorder keeps the batch,
  its parameters and the gradient dU/dz the leapfrog took), the median
  and the widest over the live particles of |program - reference| /
  max(|reference|, the median particle's |reference|), each a norm of the
  difference over the particle's active parameters (a gap of norms could
  not see a gradient of the wrong sign), the reference's gradient by
  autograd in float64.
- `weight_gap_med`, `weight_gap_max`: the median and the widest gap, per
  data point, between the change that the last reweight made to a
  particle's log weight and the change of the reference's LML from the
  data before it to the data after it.
  The earlier data of a shuffled fit is the prefix of the program's own
  shuffle (a permutation of the benchmark's series: its values are the
  benchmark's own).

A traffic's "limits" name the numbers that decide `correct`; the others
are read and left. `readings` with the traffic's check "control" on gives
the same numbers for the control too: the reference computed in TF32 put in the program's
place (`benchmark.control` reads it; the benchmark's runs do not).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import gp as ref

BAD_LML = -1e29    # the program stores -1e30 for a failed factorization


def transforms(t, y):
    """(time map, value map) as (slope, intercept) pairs: time onto [0, 1]
    by its min and max, values centred on their mean over their range."""
    t = np.asarray(t, np.float64)
    y = np.asarray(y, np.float64)
    ts = 1.0 / (t.max() - t.min())
    ys = 1.0 / (y.max() - y.min())
    return (ts, -ts * t.min()), (ys, -ys * y.mean())


class Context:
    """One unit's data as the reference sees it, on `device`."""

    def __init__(self, model: ref.Model, record, device):
        (ts, ti), (ys, yi) = transforms(record["t"], record["y"])
        f64 = torch.float64
        self.model, self.device = model, device
        self.ts = torch.as_tensor(ts * record["t_fit"] + ti, dtype=f64,
                                  device=device)
        self.xs = torch.as_tensor(ys * record["y_fit"] + yi, dtype=f64,
                                  device=device)
        self.tp = torch.as_tensor(ts * record["future"] + ti, dtype=f64,
                                  device=device)
        self.y_slope, self.y_icpt = ys, yi
        self.maps = (ts, ti), (ys, yi)
        p = record["particles"]
        self.node_type = p.node_type.to(device)
        self.params_z = p.params.to(device, f64)
        self.noise_z = p.noise_z.to(device, f64)
        self.lml = p.lml.to(device, f64)
        self.n_particles = self.node_type.shape[0]

    def points(self, t, y):
        """(ts, xs) of raw points under this unit's transforms."""
        (ts, ti), (ys, yi) = self.maps
        f64 = torch.float64
        return (torch.as_tensor(ts * np.asarray(t) + ti, dtype=f64,
                                device=self.device),
                torch.as_tensor(ys * np.asarray(y) + yi, dtype=f64,
                                device=self.device))

    def blocks(self, size, n=None):
        n = self.n_particles if n is None else n
        for i in range(0, n, size):
            yield slice(i, min(i + size, n))


def reference_lml(ctx: Context, block: int, precision="f64", p=None,
                  data=None):
    """[P] reference LMLs of the particles `p` (node_type, params_z,
    noise_z; the unit's stored ones by default) on `data` (ts, xs; the
    unit's data by default)."""
    nt, pz, nz = (ctx.node_type, ctx.params_z, ctx.noise_z) if p is None \
        else p
    ts, xs = (ctx.ts, ctx.xs) if data is None else data
    out = [ref.lml(ctx.model, nt[b], pz[b], nz[b], ts, xs, precision)
           for b in ctx.blocks(block, nt.shape[0])]
    return torch.cat(out)


def lml_readings(ctx: Context, lml_prog, lml_ref):
    """(lml_gap, dead_share, live mask) of stored likelihoods `lml_prog`."""
    live = torch.isfinite(lml_prog) & (lml_prog > BAD_LML)
    both = live & torch.isfinite(lml_ref)
    gap = ((lml_prog - lml_ref).abs()[both].max() / ctx.ts.shape[0]
           if bool(both.any()) else torch.tensor(math.inf))
    dead = 1.0 - float(live.to(torch.float64).mean())
    return float(gap), dead, both


def forecast_table(df, n_particles, n_points, quantiles):
    """[P, p, 1 + q] of the program's forecast: mean, then quantiles."""
    cols = ["y_mean"] + [f"y_{q}" for q in quantiles]
    a = np.array(df[cols].to_numpy(dtype=np.float64))
    return torch.as_tensor(a.reshape(n_particles, n_points, len(cols)))


def reference_forecast(ctx: Context, quantiles, block, precision="f64"):
    """([P, p, 1 + q] forecast in the data's units, [P, p] predictive std
    in the data's units) of the reference."""
    z = torch.tensor([0.0] + [math.sqrt(2) * torch.erfinv(
        torch.tensor(2 * q - 1, dtype=torch.float64)).item()
        for q in quantiles], dtype=torch.float64, device=ctx.device)
    means, stds = [], []
    for b in ctx.blocks(block):
        mu, sd = ref.posterior(ctx.model, ctx.node_type[b], ctx.params_z[b],
                               ctx.noise_z[b], ctx.ts, ctx.xs, ctx.tp,
                               precision)
        means.append(mu)
        stds.append(sd)
    mu, sd = torch.cat(means), torch.cat(stds)
    table = (mu[..., None] + sd[..., None] * z - ctx.y_icpt) / ctx.y_slope
    return table.cpu(), (sd / ctx.y_slope).cpu()


def forecast_gap(table_prog, table_ref, std_ref, rows):
    """The widest |program - reference| / reference std over the particles
    `rows` (a [P] bool tensor)."""
    rows = rows.cpu()
    if not bool(rows.any()):
        return math.inf
    gap = (table_prog - table_ref).abs() / std_ref[..., None]
    gap = gap[rows]
    return float(gap.max()) if bool(torch.isfinite(gap).all()) else math.inf


def unmoved(pair):
    """1 if the rejuvenation left every particle's structure and
    parameters as they were, else 0 (None without a rejuvenation)."""
    if pair is None:
        return None
    before, after = pair
    same = (torch.equal(before.node_type, after.node_type)
            and torch.equal(before.params, after.params)
            and torch.equal(before.noise_z, after.noise_z))
    return 1.0 if same else 0.0


def as_ref(particles, device):
    f64 = torch.float64
    return (particles.node_type.to(device), particles.params.to(device, f64),
            particles.noise_z.to(device, f64))


def live_lml(lml):
    return torch.isfinite(lml) & (lml > BAD_LML)


def spread(rel, live):
    """(median, widest) of the per-particle gaps `rel` over `live`; both
    infinite where no particle is live or a live one's gap is not
    finite."""
    if not bool(live.any()):
        return math.inf, math.inf
    rel = rel[live]
    if not bool(torch.isfinite(rel).all()):
        return math.inf, math.inf
    return float(rel.median()), float(rel.max())


def grad_readings(ctx: Context, call, block, precision="f64"):
    """(grad_gap_med, grad_gap_max) of a kept gradient call; with
    `precision` "tf32", the control's own gradient in the program's
    place, over the particles whose gram it could factor."""
    n_active = int(call["mask"].sum())
    if n_active != ctx.ts.shape[0] or call["grad"] is None:
        return math.inf, math.inf
    dev, f64 = ctx.device, torch.float64
    nt = call["node_type"].to(dev)
    pz = call["params"].to(dev, f64)
    nz = call["noise_z"].to(dev, f64)
    g_ref, l_ref, g_got, l_got = [], [], [], []
    for b in ctx.blocks(block, nt.shape[0]):
        g, v = ref.energy_grad(ctx.model, nt[b], pz[b], nz[b], ctx.ts,
                               ctx.xs)
        g_ref.append(g)
        l_ref.append(v)
        if precision != "f64":
            g, v = ref.energy_grad(ctx.model, nt[b], pz[b], nz[b], ctx.ts,
                                   ctx.xs, precision)
            g_got.append(g)
            l_got.append(v)
    g_ref, l_ref = torch.cat(g_ref), torch.cat(l_ref)
    if precision == "f64":
        got = call["grad"].to(dev, f64)
        l_got = call["lml"].to(dev, f64)
    else:
        got, l_got = torch.cat(g_got).to(f64), torch.cat(l_got)
    live = live_lml(l_got) & torch.isfinite(l_ref)
    pm = ref.param_mask(nt)
    got = torch.where(pm, got, torch.zeros_like(got))
    diff = (got - g_ref).flatten(1).norm(dim=1)
    size = g_ref.flatten(1).norm(dim=1)
    floor = float(size[live].median()) if bool(live.any()) else 0.0
    return spread(diff / torch.clamp(size, min=floor), live)


def previous_data(record, kept):
    """(t, y) raw points that the last reweight's earlier LMLs were on."""
    if "t_prev" in record:
        return record["t_prev"], record["y_prev"]
    perm, schedule = kept["anneal"]
    n = len(record["t_fit"])
    perm = np.arange(n) if perm is None else np.asarray(perm)
    idx = perm[:schedule[-2]] if len(schedule) > 1 else perm[:0]
    return np.asarray(record["t_fit"])[idx], np.asarray(record["y_fit"])[idx]


def weight_readings(ctx: Context, record, kept, block, control=False):
    """((weight_gap_med, weight_gap_max) of the kept reweight, the
    control's or None): with `control`, the control's own LMLs in TF32
    on both sides in the program's place."""
    before, after = kept["reweight"]
    p = as_ref(before, ctx.device)
    old_data = ctx.points(*previous_data(record, kept))
    new_ref = reference_lml(ctx, block, p=p)
    old_ref = reference_lml(ctx, block, p=p, data=old_data)
    f64 = torch.float64
    w0 = before.log_weights.to(ctx.device, f64)
    w1 = after.log_weights.to(ctx.device, f64)
    base = (torch.isfinite(w0) & live_lml(before.lml.to(ctx.device, f64))
            & torch.isfinite(new_ref) & torch.isfinite(old_ref))
    want = new_ref - old_ref
    n = ctx.ts.shape[0]

    def gap(change, live):
        return spread((change - want).abs() / n, live)

    got = gap(w1 - w0, base & torch.isfinite(w1))
    if not control:
        return got, None
    new_c = reference_lml(ctx, block, "tf32", p=p)
    old_c = reference_lml(ctx, block, "tf32", p=p, data=old_data)
    ch = new_c - old_c
    return got, gap(ch, base & torch.isfinite(ch))


def readings(model: ref.Model, record, kept, traffic, device):
    """The numbers of one unit, judged against the reference, and the
    control's on the same particles:
    ({name: program's reading}, {name: control's reading})."""
    chk = traffic["check"]
    ctx = Context(model, record, device)
    q = traffic["forecast"]["quantiles"]
    lml_ref = reference_lml(ctx, chk["block"])
    got, ctl = {}, {}
    got["lml_gap"], got["dead_share"], live = lml_readings(ctx, ctx.lml,
                                                           lml_ref)
    forecasts = record["df"] is not None
    if forecasts:
        table_ref, std_ref = reference_forecast(ctx, q, chk["block"])
        table = forecast_table(record["df"], ctx.n_particles,
                               len(record["future"]), q)
        got["forecast_gap"] = forecast_gap(table, table_ref, std_ref, live)
    kept = kept or {}
    u = unmoved(kept.get("rejuvenation"))
    if u is not None:
        got["unmoved"] = u
    control = chk.get("control", False)
    if kept.get("grad") is not None:
        got["grad_gap_med"], got["grad_gap_max"] = grad_readings(
            ctx, kept["grad"], chk["block"])
        if control:
            ctl["grad_gap_med"], ctl["grad_gap_max"] = grad_readings(
                ctx, kept["grad"], chk["block"], "tf32")
    # The weights are read where a limit names them, or for the control.
    weights = control or any(n.startswith("weight_gap")
                             for n in traffic["limits"])
    if weights and kept.get("reweight") is not None and (
            "t_prev" in record or "anneal" in kept):
        w, c = weight_readings(ctx, record, kept, chk["block"], control)
        got["weight_gap_med"], got["weight_gap_max"] = w
        if control:
            ctl["weight_gap_med"], ctl["weight_gap_max"] = c
    if control:
        lml_c = reference_lml(ctx, chk["block"], "tf32")
        ctl["lml_gap"], ctl["dead_share"], live_c = lml_readings(
            ctx, lml_c, lml_ref)
        if forecasts:
            table_c, _ = reference_forecast(ctx, q, chk["block"], "tf32")
            ctl["forecast_gap"] = forecast_gap(table_c, table_ref, std_ref,
                                               live_c & live)
    return got, ctl


def judge(values: dict, limits: dict):
    """(correct, lines): each number beside its limit; a number above its
    limit, one not finite, or one with no reading (its recorder found
    nothing to read) fails."""
    ok, lines = True, []
    for name, limit in limits.items():
        v = values.get(name)
        fine = v is not None and math.isfinite(v) and v <= limit
        ok &= fine
        lines.append((name, v, limit, fine))
    return ok, lines
