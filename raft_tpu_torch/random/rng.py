"""Distribution sampling over an ``RngState``.

Port of ``raft_tpu/random/rng.py``: the seventeen draws of ``rng.cuh``
(``uniform`` ... ``multi_variable_gaussian``). Each draw takes the
reference's arguments and a ``device`` keyword: a tensor argument keeps
its device, anything else goes to ``device`` (``cuda`` when None). Every
draw comes from a ``torch.Generator`` on the output's device, made by
``state.next_generator``, so one call advances the state by one, as one
``next_key`` does in the reference. The numbers differ from the
reference's; the distributions are the same. The inverse-CDF transforms
(laplace, gumbel, logistic, exponential, rayleigh) follow the ones
``jax.random`` uses, each on a uniform draw kept off the point where its
log would be infinite. float64 maps to float32, as ``core.mdarray``
maps it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import torch_dtype
from raft_tpu_torch.core.resources import DeviceLike, as_tensor, resolve_device
from raft_tpu_torch.matrix.select_k import stable_top_k
from raft_tpu_torch.random.rng_state import RngState

Shape = Union[int, Tuple[int, ...]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _dtype(dtype) -> torch.dtype:
    dt = torch_dtype(dtype)
    return torch.float32 if dt == torch.float64 else dt


def _draw(state: RngState, device: DeviceLike):
    dev = resolve_device(device)
    return state.next_generator(dev), dev


def _uniform(g, dev, shape, low, high) -> torch.Tensor:
    """f32 draws in [low, high)."""
    return torch.empty(_shape(shape), dtype=torch.float32,
                       device=dev).uniform_(low, high, generator=g)


def uniform(state: RngState, shape: Shape, low=0.0, high=1.0,
            dtype=torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """U[low, high)."""
    g, dev = _draw(state, device)
    return torch.empty(_shape(shape), dtype=_dtype(dtype),
                       device=dev).uniform_(low, high, generator=g)


def uniformInt(state: RngState, shape: Shape, low, high, dtype=torch.int32,
               device: DeviceLike = None) -> torch.Tensor:
    """Integers in [low, high)."""
    g, dev = _draw(state, device)
    return torch.randint(int(low), int(high), _shape(shape), generator=g,
                         dtype=torch_dtype(dtype), device=dev)


def normal(state: RngState, shape: Shape, mu=0.0, sigma=1.0,
           dtype=torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """N(mu, sigma^2)."""
    g, dev = _draw(state, device)
    z = torch.randn(_shape(shape), generator=g, dtype=_dtype(dtype),
                    device=dev)
    return mu + sigma * z


def normalInt(state: RngState, shape: Shape, mu, sigma, dtype=torch.int32,
              device: DeviceLike = None) -> torch.Tensor:
    """A normal draw rounded half to even."""
    g, dev = _draw(state, device)
    z = torch.randn(_shape(shape), generator=g, dtype=torch.float32,
                    device=dev)
    return torch.round(mu + sigma * z).to(torch_dtype(dtype))


def lognormal(state: RngState, shape: Shape, mu=0.0, sigma=1.0,
              dtype=torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """exp(N(mu, sigma^2))."""
    return torch.exp(normal(state, shape, mu, sigma, dtype, device))


def laplace(state: RngState, shape: Shape, mu=0.0, scale=1.0,
            dtype=torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """Laplace(mu, scale): -sign(u) log1p(-|u|), u in [-1 + eps, 1)."""
    g, dev = _draw(state, device)
    u = _uniform(g, dev, shape, -1.0 + torch.finfo(torch.float32).eps, 1.0)
    x = -torch.sign(u) * torch.log1p(-torch.abs(u))
    return (mu + scale * x).to(_dtype(dtype))


def gumbel(state: RngState, shape: Shape, mu=0.0, beta=1.0,
           dtype=torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """Gumbel(mu, beta): -log(-log(u)), u in [tiny, 1)."""
    g, dev = _draw(state, device)
    u = _uniform(g, dev, shape, torch.finfo(torch.float32).tiny, 1.0)
    return (mu + beta * -torch.log(-torch.log(u))).to(_dtype(dtype))


def logistic(state: RngState, shape: Shape, mu=0.0, scale=1.0,
             dtype=torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """Logistic(mu, scale): log(u / (1 - u)), u in [tiny, 1)."""
    g, dev = _draw(state, device)
    u = _uniform(g, dev, shape, torch.finfo(torch.float32).tiny, 1.0)
    return (mu + scale * torch.log(u / (1.0 - u))).to(_dtype(dtype))


def exponential(state: RngState, shape: Shape, lam=1.0,
                dtype=torch.float32, device: DeviceLike = None
                ) -> torch.Tensor:
    """Exponential with rate ``lam``: -log1p(-u) / lam, u in [0, 1)."""
    g, dev = _draw(state, device)
    u = _uniform(g, dev, shape, 0.0, 1.0)
    return (-torch.log1p(-u) / lam).to(_dtype(dtype))


def rayleigh(state: RngState, shape: Shape, sigma=1.0, dtype=torch.float32,
             device: DeviceLike = None) -> torch.Tensor:
    """Rayleigh(sigma) by inverse CDF: sigma sqrt(-2 log u), u in
    [tiny, 1)."""
    g, dev = _draw(state, device)
    dt = _dtype(dtype)
    u = torch.empty(_shape(shape), dtype=dt, device=dev).uniform_(
        torch.finfo(dt).tiny, 1.0, generator=g)
    return sigma * torch.sqrt(-2.0 * torch.log(u))


def bernoulli(state: RngState, shape: Shape, prob=0.5,
              device: DeviceLike = None) -> torch.Tensor:
    """Bernoulli(prob) as bool: u < prob."""
    g, dev = _draw(state, device)
    return _uniform(g, dev, shape, 0.0, 1.0) < prob


def scaled_bernoulli(state: RngState, shape: Shape, prob=0.5, scale=1.0,
                     dtype=torch.float32, device: DeviceLike = None
                     ) -> torch.Tensor:
    """+-scale: -scale where u > prob, else +scale (the reference's
    ``ScaledBernoulliDistParams`` rule)."""
    g, dev = _draw(state, device)
    dt = _dtype(dtype)
    u = torch.empty(_shape(shape), dtype=dt, device=dev).uniform_(
        generator=g)
    return torch.where(u > prob, -scale, scale).to(dt)


def discrete(state: RngState, shape: Shape, weights, dtype=torch.int32,
             device: DeviceLike = None) -> torch.Tensor:
    """Indices drawn with probability proportional to ``weights``: the
    inverse of their float64 CDF at a uniform draw (a zero weight is never
    drawn)."""
    w = as_tensor(weights, device=device).double()
    g, dev = _draw(state, w.device)
    cdf = torch.cumsum(w, 0)
    cdf = cdf / cdf[-1]
    u = torch.rand(_shape(shape), generator=g, dtype=torch.float64,
                   device=dev)
    idx = torch.searchsorted(cdf, u.reshape(-1), right=True)
    idx = torch.clamp_max(idx, w.shape[0] - 1)
    return idx.reshape(u.shape).to(torch_dtype(dtype))


def rng_fill(state: RngState, shape: Shape, val, dtype=torch.float32,
             device: DeviceLike = None) -> torch.Tensor:
    """A constant fill through the RNG API (draws nothing)."""
    del state
    return torch.full(_shape(shape), val, dtype=_dtype(dtype),
                      device=resolve_device(device))


def sample_without_replacement(state: RngState, n: int, n_samples: int,
                               weights=None, inputs=None,
                               device: DeviceLike = None
                               ) -> Tuple[Optional[torch.Tensor],
                                          torch.Tensor]:
    """Weighted sampling without replacement by the Gumbel-top-k trick:
    the ``n_samples`` largest of log(weight) + Gumbel noise, ties to the
    lowest index. Returns ``(inputs[indices] or None, int32 indices)``."""
    expects(n_samples <= n, "sampledLen must be <= len")
    if isinstance(weights, torch.Tensor):
        device = weights.device
    elif isinstance(inputs, torch.Tensor):
        device = inputs.device
    dev = resolve_device(device)
    if weights is None:
        logw = torch.zeros((n,), dtype=torch.float32, device=dev)
    else:
        logw = torch.log(as_tensor(weights, device=dev).to(dev).float())
    noise = gumbel(state, (n,), device=dev)
    _, idx = stable_top_k(logw + noise, n_samples, select_min=False)
    idx = idx.to(torch.int32)
    out = None
    if inputs is not None:
        out = as_tensor(inputs, device=dev).to(dev)[idx.long()]
    return out, idx


def permute(state: RngState, n: int, inputs=None, rows: bool = True,
            device: DeviceLike = None):
    """A random permutation of ``n`` (int32); with ``inputs``, also its
    rows (or columns) in that order: ``(permuted, perm)``."""
    if isinstance(inputs, torch.Tensor):
        device = inputs.device
    g, dev = _draw(state, device)
    perm = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    if inputs is None:
        return perm
    x = as_tensor(inputs, device=dev)
    return (x[perm.long()] if rows else x[:, perm.long()]), perm


def multi_variable_gaussian(state: RngState, mean, cov, n_samples: int,
                            method: str = "cholesky",
                            device: DeviceLike = None) -> torch.Tensor:
    """``n_samples`` rows drawn from N(mean, cov): z L^T with L the
    Cholesky factor of cov + 1e-6 I (``"cholesky"``) or V sqrt(max(w, 0))
    from its eigendecomposition (``"jacobi"``). Returns (n_samples,
    dim) float32."""
    mean = as_tensor(mean, device=device).float()
    cov = as_tensor(cov, device=mean.device).to(mean.device).float()
    dim = mean.shape[0]
    g, dev = _draw(state, mean.device)
    z = torch.randn((n_samples, dim), generator=g, dtype=torch.float32,
                    device=dev)
    return mean[None, :] + z @ _mvg_factor(cov, method).T


def _mvg_factor(cov: torch.Tensor, method: str) -> torch.Tensor:
    """The factor F of ``cov`` = F F^T that :func:`multi_variable_gaussian`
    multiplies its normal draws by."""
    dim = cov.shape[0]
    if method == "cholesky":
        return torch.linalg.cholesky(
            cov + 1e-6 * torch.eye(dim, dtype=cov.dtype, device=cov.device))
    w, v = torch.linalg.eigh(cov)
    return v * torch.sqrt(torch.clamp_min(w, 0))[None, :]
