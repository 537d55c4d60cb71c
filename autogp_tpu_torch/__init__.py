"""autogp_tpu_torch -- the PyTorch + CUDA port of autogp_tpu.

Gaussian-process structure discovery by SMC over kernel-expression trees,
on one NVIDIA Hopper GPU. The JAX package `autogp_tpu` stays the reference:
module names mirror it, and tests/test_torch_*.py hold each ported function
to its JAX counterpart on the CPU in float64.

Ported so far: SMC with data annealing, parameter and noise HMC included
(prior, moves, reweight/resample, the batched LML and its gradient,
predict, to_dict/from_dict), on four hand-written CUDA kernels: the
covariance assembly (ops/cov.py), the panel Cholesky (ops/chol.py), the
K^-1 substitution (ops/kinv.py) and the assembly backward (ops/cov_vjp.py).
Entry points run on the card unless the caller passes device="cpu". This
package imports neither jax nor autogp_tpu.
"""

from autogp_tpu_torch.config import GPConfig  # noqa: F401
from autogp_tpu_torch.transforms import LinearTransform  # noqa: F401
from autogp_tpu_torch import kernels as GP  # noqa: F401
from autogp_tpu_torch import schedule as Schedule  # noqa: F401
from autogp_tpu_torch.api import (  # noqa: F401
    GPModel, covariance_kernels, effective_sample_size, fit_smc, from_dict,
    log_marginal_likelihood_estimate, observation_noise_variances,
    particle_weights, particles_from_numpy, predict, seed, to_dict)
