"""Plain reference of the benchmark: kernel-expression GPs in PyTorch.

Written from AutoGP.jl's definitions (src/GP.jl: the primitive kernels,
Plus, Times, ChangePoint; src/Model.jl: the parameter and noise
transforms; the Gaussian log marginal likelihood and the posterior
predictive), for the heap encoding the program stores its particles in:
slot 0 is the root, the children of slot i are 2i + 1 and 2i + 2, and a
slot's code is 0 (empty), 1 Constant, 2 Linear, 3 SquaredExponential,
4 GammaExponential, 5 Periodic, 6 Plus, 7 Times, 8 ChangePoint or
9 WhiteNoise. Each slot carries up to three whitened parameters.

It imports nothing of the program and takes no table the program made:
the prior's transform constants come from the configuration file. Every
quantity is computed in float64 by default. `precision="tf32"` is the
benchmark's control: each covariance entry rounded to TF32's 10-bit
mantissa, and the factorization and solves in float32, the step below the
IEEE float32 (TF32 off) that the program states. `energy_grad` gives the
gradient that parameter HMC's leapfrog takes, by autograd in the same
precision (the rounding passed straight through).
"""

from __future__ import annotations

import math

import torch

CONSTANT, LINEAR, SE, GE, PERIODIC = 1, 2, 3, 4, 5
PLUS, TIMES, CHANGEPOINT, WHITE_NOISE = 6, 7, 8, 9
OPERATORS = (PLUS, TIMES, CHANGEPOINT)
# Continuous parameters per code, in AutoGP.jl's field order.
ARITY = (0, 1, 3, 2, 3, 3, 0, 0, 1, 1)
# Which prior transform each (code, parameter) takes.
WILDCARD, PERIOD, GAMMA = "wildcard", "period", "gamma"
KINDS = {CONSTANT: (WILDCARD,), LINEAR: (WILDCARD,) * 3,
         SE: (WILDCARD,) * 2, GE: (WILDCARD, GAMMA, WILDCARD),
         PERIODIC: (WILDCARD, PERIOD, WILDCARD), CHANGEPOINT: (WILDCARD,),
         WHITE_NOISE: (WILDCARD,)}
LOG2PI = math.log(2.0 * math.pi)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa
    bits), halfway cases away from zero, as the tensor cores read them."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Model:
    """The prior's transforms of one configuration (its file's "prior",
    "model_jitter" and "changepoint_scale")."""

    def __init__(self, config: dict):
        self.prior = config["prior"]
        self.jitter = float(config["model_jitter"])
        self.cp_scale = float(config["changepoint_scale"])

    def constrained(self, node_type, params_z):
        """[P, M, 3] constrained parameters of whitened `params_z`:
        log-normal (wildcard, period) or scaled logit-normal (gamma)."""
        out = torch.zeros_like(params_z)
        for code, kinds in KINDS.items():
            sel = node_type == code
            if not bool(sel.any()):
                continue
            for j, kind in enumerate(kinds):
                p = self.prior[kind]
                lin = p["mu"] + p["sigma"] * params_z[..., j]
                val = (p["scale"] / (1.0 + torch.exp(-lin)) if kind == GAMMA
                       else torch.exp(lin))
                out[..., j] = torch.where(sel, val, out[..., j])
        return out

    def noise(self, noise_z):
        p = self.prior[WILDCARD]
        return torch.exp(p["mu"] + p["sigma"] * noise_z) + self.jitter


def _leaf(code, p, t1, t2):
    """[B, n1, n2] covariance of primitive kernels with parameters p
    [B, 3] (constrained) on the grids t1 [n1] x t2 [n2]."""
    a, b, c = (p[:, j, None, None] for j in range(3))
    d = t1[None, :, None] - t2[None, None, :]
    if code == CONSTANT:
        return a.expand(-1, d.shape[1], d.shape[2])
    if code == WHITE_NOISE:
        return a * (d == 0).to(d.dtype)
    if code == LINEAR:   # intercept, bias, amplitude
        return b + c * (t1[None, :, None] - a) * (t2[None, None, :] - a)
    if code == SE:       # lengthscale, amplitude
        return b * torch.exp(-0.5 * d * d / (a * a))
    if code == GE:       # lengthscale, gamma, amplitude
        r = torch.abs(d) / a     # 0 ** gamma is 0; its gradient kept finite
        pos = r > 0
        pw = torch.where(pos, torch.pow(torch.where(pos, r, 1.0), b), 0.0)
        return c * torch.exp(-pw)
    if code == PERIODIC:  # lengthscale, period, amplitude
        s = torch.sin(math.pi * torch.abs(d) / b)
        return c * torch.exp(-2.0 / (a * a) * s * s)
    raise ValueError(f"code {code} is not a primitive kernel")


def covariance(model: Model, node_type, params_z, t1, t2):
    """[P, n1, n2] covariance of each particle's tree on t1 x t2, without
    the observation noise. Particles are evaluated slot by slot, each slot
    grouped by its code, so a tree costs what its own slots do."""
    P, M = node_type.shape
    p_all = model.constrained(node_type, params_z)
    out_shape = (P, t1.shape[0], t2.shape[0])

    def rec(s, rows):
        """Values of the subtrees at slot s of the particles `rows`."""
        codes = node_type[rows, s]
        val = torch.zeros((rows.numel(),) + out_shape[1:], dtype=t1.dtype,
                          device=t1.device)
        for code in torch.unique(codes).tolist():
            sel = torch.nonzero(codes == code).flatten()
            sub = rows[sel]
            p = p_all[sub, s]
            if code in OPERATORS:
                left, right = rec(2 * s + 1, sub), rec(2 * s + 2, sub)
                if code == PLUS:
                    v = left + right
                elif code == TIMES:
                    v = left * right
                else:    # ChangePoint(location): left before, right after
                    loc = p[:, 0, None]
                    s1 = 0.5 * (1 + torch.tanh((loc - t1[None]) /
                                               model.cp_scale))
                    s2 = 0.5 * (1 + torch.tanh((loc - t2[None]) /
                                               model.cp_scale))
                    v = (s1[:, :, None] * left * s2[:, None, :]
                         + (1 - s1)[:, :, None] * right
                         * (1 - s2)[:, None, :])
            elif code == 0:
                raise ValueError(f"empty slot {s} reached in a tree")
            else:
                v = _leaf(code, p, t1, t2)
            val[sel] = v
        return val

    return rec(0, torch.arange(P, device=node_type.device))


def _as_precision(K, precision: str):
    if precision == "f64":
        return K
    if precision == "tf32":
        K = K.to(torch.float32)
        return K + (round_tf32(K.detach()) - K.detach())
    raise ValueError(f"unknown precision {precision!r}")


def _factor(model, node_type, params_z, noise_z, ts, precision):
    """(L, info) of K + noise I on the active points ts, per particle."""
    K = covariance(model, node_type, params_z, ts, ts)
    n = ts.shape[0]
    K = K + model.noise(noise_z)[:, None, None] * torch.eye(
        n, dtype=K.dtype, device=K.device)
    return torch.linalg.cholesky_ex(_as_precision(K, precision))


def lml(model: Model, node_type, params_z, noise_z, ts, xs,
        precision: str = "f64"):
    """[P] log N(xs; 0, K + noise I) of each particle on the active
    points (ts, xs), NaN where K + noise I is not positive definite in the
    precision used."""
    L, info = _factor(model, node_type, params_z, noise_z, ts, precision)
    x = xs.to(L.dtype).expand(L.shape[0], -1)[..., None]
    alpha = torch.linalg.solve_triangular(L, x, upper=False)[..., 0]
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    val = -0.5 * (ts.shape[0] * LOG2PI + 2 * torch.log(d).sum(-1)
                  + (alpha * alpha).sum(-1))
    val = val.to(torch.float64)
    return torch.where(info == 0, val, torch.full_like(val, float("nan")))


def posterior(model: Model, node_type, params_z, noise_z, ts, xs, tp,
              precision: str = "f64"):
    """Marginal posterior predictive (mean, std) [P, p] at tp given the
    active points (ts, xs), the particle's observation noise included."""
    L, info = _factor(model, node_type, params_z, noise_z, ts, precision)
    dt = L.dtype
    Kpt = _as_precision(covariance(model, node_type, params_z, tp, ts),
                        precision)
    x = xs.to(dt).expand(L.shape[0], -1)[..., None]
    alpha = torch.linalg.solve_triangular(L, x, upper=False)
    V = torch.linalg.solve_triangular(L, Kpt.mT, upper=False)
    mean = (V.mT @ alpha)[..., 0]
    kpp = torch.diagonal(covariance(model, node_type, params_z, tp, tp),
                         dim1=-2, dim2=-1)
    var = kpp.to(dt) + model.noise(noise_z).to(dt)[:, None] - (V * V).sum(-2)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    bad = (info != 0)[:, None]
    nan = torch.full_like(mean, float("nan"))
    return (torch.where(bad, nan, mean).to(torch.float64),
            torch.where(bad, nan, std).to(torch.float64))


def param_mask(node_type):
    """[P, M, 3] bool: the parameter slots each slot's code carries."""
    arity = torch.as_tensor(ARITY, device=node_type.device)[node_type]
    return torch.arange(3, device=node_type.device) < arity[..., None]


def energy_grad(model: Model, node_type, params_z, noise_z, ts, xs,
                precision: str = "f64"):
    """([P, M, 3] gradient of parameter HMC's potential, [P] LML) at the
    whitened parameters params_z: U = -(sum of the standard normal log
    densities of the active parameters + that of the noise + LML), so
    dU/dz = z - dLML/dz on the active slots, 0 off them."""
    pm = param_mask(node_type)
    with torch.enable_grad():
        q = params_z.detach().clone().requires_grad_(True)
        val = lml(model, node_type, q, noise_z, ts, xs, precision)
        (g,) = torch.autograd.grad(val.sum(), q)
    grad = torch.where(pm, params_z - g, torch.zeros_like(g))
    return grad.detach(), val.detach()
