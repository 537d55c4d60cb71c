"""autogp_tpu_torch -- the PyTorch + CUDA port of autogp_tpu.

Gaussian-process structure discovery by SMC over kernel-expression trees,
on one NVIDIA Hopper GPU. The JAX package `autogp_tpu` stays the reference:
module names mirror it, and tests/test_torch_*.py hold each ported function
to its JAX counterpart on the CPU in float64.

Ported so far: SMC with data annealing, parameter and noise HMC included
(prior, moves, reweight/resample, the batched LML and its gradient on both
of the reference's routes, the predict family, to_dict/from_dict), the
MCMC-only fits, the greedy AIC search and the hybrid greedy/MCMC chain
(fit_greedy, fit_greedy_mcmc), the decomposition API (decompose,
extract_kernel, split_kernel_sop, gp_model_from_kernels, predict_sum,
predict_mvn_sum), the streaming API (add_data, remove_data,
maybe_resample, fit_smc's callback) and the online forecasting script
(`python3 -m autogp_tpu_torch.scripts.online`), on hand-written CUDA
kernels: the covariance assembly, tape-driven and per-slot (ops/cov.py),
the panel Cholesky (ops/chol.py), the K^-1 substitution (ops/kinv.py) and
the assembly backwards (ops/cov_vjp.py); depth-annealed SMC
(inference/smc_depth.py) and the fixed-structure HMC experiment of
BASELINE config 2 (`python3 -m autogp_tpu_torch.scripts.experiment_hmc`);
and the particle mesh (parallel/mesh.py): `GPModel(..., mesh=m)` shards
the particles over the ranks of a torch.distributed group, each rank
ending with its rows of the unsharded result. Entry points run on the
card unless the caller passes device="cpu". This package imports neither
jax nor autogp_tpu.
"""

from autogp_tpu_torch.config import GPConfig  # noqa: F401
from autogp_tpu_torch.transforms import (  # noqa: F401
    LinearTransform, LogTransform)
from autogp_tpu_torch import kernels as GP  # noqa: F401
from autogp_tpu_torch import schedule as Schedule  # noqa: F401
from autogp_tpu_torch import callbacks as Callbacks  # noqa: F401
from autogp_tpu_torch.api import (  # noqa: F401
    GPModel, add_data, covariance_kernels, decompose, effective_sample_size,
    extract_kernel, fit_greedy, fit_greedy_mcmc, fit_mcmc, fit_smc,
    from_dict, gp_model_from_kernels, log_marginal_likelihood_estimate,
    maybe_resample, mcmc_parameters, mcmc_structure, num_particles,
    observation_noise_variances, particle_weights, particles_from_numpy,
    predict, predict_mvn, predict_mvn_sum, predict_proba, predict_quantile,
    predict_sum, remove_data, seed, split_kernel_sop, to_dict)
