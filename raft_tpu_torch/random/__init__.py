"""Random number generation and dataset generators: the port of
``raft_tpu/random``. Every draw comes from an explicit ``torch.Generator``
on the output's device (``cuda`` unless asked otherwise)."""

from raft_tpu_torch.random.rng_state import GeneratorType, RngState
from raft_tpu_torch.random.rng import (
    uniform,
    uniformInt,
    normal,
    normalInt,
    lognormal,
    laplace,
    gumbel,
    logistic,
    exponential,
    rayleigh,
    bernoulli,
    scaled_bernoulli,
    discrete,
    rng_fill,
    sample_without_replacement,
    permute,
    multi_variable_gaussian,
)
from raft_tpu_torch.random.make_blobs import make_blobs
from raft_tpu_torch.random.make_regression import make_regression
from raft_tpu_torch.random.rmat import rmat_rectangular_gen

__all__ = [
    "GeneratorType", "RngState",
    "uniform", "uniformInt", "normal", "normalInt", "lognormal", "laplace",
    "gumbel", "logistic", "exponential", "rayleigh", "bernoulli",
    "scaled_bernoulli", "discrete", "rng_fill",
    "sample_without_replacement", "permute", "multi_variable_gaussian",
    "make_blobs", "make_regression", "rmat_rectangular_gen",
]
