"""Callback factory for monitoring SMC inference (reference: src/Callbacks.jl).

`make_smc_callback(fn, model)` wraps a user function so that at every SMC
step it receives a reconstructed intermediate `GPModel` over the observed
prefix plus step metadata (Callbacks.jl:98-152).
"""

from __future__ import annotations

import inspect
from typing import Callable


def validate_callback(fn: Callable, **kwargs):
    """Signature checks mirroring Callbacks.jl:29-56: no positional args,
    must accept **kwargs; extra kwargs must appear in the signature."""
    sig = inspect.signature(fn)
    has_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                     for p in sig.parameters.values())
    positional = [p for p in sig.parameters.values()
                  if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                inspect.Parameter.POSITIONAL_OR_KEYWORD)]
    if positional:
        raise ValueError(
            f"Callback {fn} must have no positional argnames, received "
            f"{[p.name for p in positional]}")
    if not has_var_kw:
        raise ValueError(f"Callback {fn} requires a **kwargs specifier")
    named = {p.name for p in sig.parameters.values()
             if p.kind == inspect.Parameter.KEYWORD_ONLY}
    unknown = [k for k in kwargs if k not in named]
    if unknown:
        raise ValueError(
            f"Unknown kwargs {unknown} in make_smc_callback for {fn}")


def make_smc_callback(fn: Callable, model, **kwargs) -> Callable:
    """Wrap `fn` into a fit_smc callback.

    At each step `fn` receives: model (intermediate GPModel on the observed
    prefix), ds_next/y_next (future data), step, permutation, schedule,
    rejuvenated, resampled, elapsed, verbose — plus the extra `kwargs`.
    """
    from autogp_tpu_torch.api import GPModel

    validate_callback(fn, **kwargs)

    def g(**kw):
        particles = kw["particles"]
        permutation = kw["permutation"]
        step = kw["step"]

        ds_perm = model.ds[permutation]
        y_perm = model.y[permutation]
        current = GPModel._from_state(
            particles, model.config, ds_perm[:step], y_perm[:step],
            model.ds_transform, model.y_transform)
        return fn(**kwargs,
                  model=current,
                  ds_next=ds_perm[step:],
                  y_next=y_perm[step:],
                  step=step,
                  permutation=permutation,
                  schedule=kw["schedule"],
                  rejuvenated=kw["rejuvenated"],
                  resampled=kw["resampled"],
                  elapsed=kw["elapsed"],
                  verbose=kw["verbose"])

    return g
