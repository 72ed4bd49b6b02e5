"""raft_tpu_torch.solver (the auction LAP) against raft_tpu.solver.

Mirrors tests/test_graph.py's TestLap and tests/test_random_properties.py's
LAP cases. Both packages run the same f32 auction (the same epsilon
schedule, bids, tie rules and round caps), so on the same costs:

* the assignments agree bit for bit, float and integer costs;
* the objectives within rtol 1e-6 (the two sum the n chosen costs in
  different orders);
* each slice of ``LinearAssignmentProblem`` equals ``lap`` on that slice
  bit for bit (a finished problem is frozen, as under the reference's
  ``vmap``);
* with ``max_rounds`` too small to finish, the host repair gives the
  reference's permutation;
* on integer costs in [0, 100), n * eps_floor < 1, so the objective equals
  scipy's optimum exactly.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from raft_tpu.solver import LinearAssignmentProblem as JLap
from raft_tpu.solver import lap as j_lap
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.solver import LinearAssignmentProblem, lap
from raft_tpu_torch.solver import linear_assignment as la
from test_torch_common import n, t


def _costs(rng, shape, kind):
    if kind == "int":
        return rng.integers(0, 100, shape).astype(np.float32)
    return rng.random(shape).astype(np.float32)


def _is_perm(a):
    return np.array_equal(np.sort(a), np.arange(a.shape[-1]))


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("size", [1, 2, 12, 40, 96])
def test_lap_bit_for_bit(rng, size, kind):
    c = _costs(rng, (size, size), kind)
    ja, jt = j_lap(c)
    ta, tt = lap(t(c))
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(n(ta), n(ja))
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    assert _is_perm(n(ta))


@pytest.mark.parametrize("kind", ["float", "int"])
def test_batched_class_equals_lap_per_slice(rng, kind):
    costs = _costs(rng, (4, 24, 24), kind)
    p = LinearAssignmentProblem(24, batchsize=4)
    p.solve(t(costs))
    jp = JLap(24, batchsize=4)
    jp.solve(costs)
    for b in range(4):
        got = n(p.getAssignmentVector(b))
        np.testing.assert_array_equal(got, n(lap(t(costs[b]))[0]))
        np.testing.assert_array_equal(got, n(jp.getAssignmentVector(b)))
        assert p.getPrimalObjectiveValue(b) == pytest.approx(
            jp.getPrimalObjectiveValue(b), rel=1e-6)


def test_batched_class_takes_one_problem(rng):
    c = _costs(rng, (10, 10), "float")
    p = LinearAssignmentProblem(10)
    p.solve(t(c))
    np.testing.assert_array_equal(n(p.getAssignmentVector()),
                                  n(lap(t(c))[0]))
    with pytest.raises(LogicError):
        p.solve(t(_costs(rng, (2, 10, 10), "float")))


@pytest.mark.parametrize("max_rounds", [1, 3, 7])
def test_max_rounds_repair(rng, max_rounds):
    """A round cap that leaves rows unassigned: the host repair matches
    them to the free columns as the reference's does."""
    c = _costs(rng, (30, 30), "float")
    ja, jt = j_lap(c, max_rounds=max_rounds)
    ta, tt = lap(t(c), max_rounds=max_rounds)
    np.testing.assert_array_equal(n(ta), n(ja))
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    assert _is_perm(n(ta))
    assert bool((la._auction(t(c)[None], max_rounds) < 0).any())


def test_frozen_problem_keeps_its_state(rng):
    """One problem hits its round cap while the other finishes: each
    equals its own solve with the same cap."""
    costs = _costs(rng, (2, 20, 20), "float")
    costs[1] = np.eye(20, dtype=np.float32)      # finishes in few rounds
    got = n(la._auction(t(costs), 5))
    for b in range(2):
        np.testing.assert_array_equal(got[b],
                                      n(la._auction(t(costs[b:b + 1]), 5))[0])


@pytest.mark.parametrize("seed", range(4))
def test_integer_costs_are_optimal(seed):
    rng = np.random.default_rng(seed)
    size = int(rng.integers(20, 80))
    c = _costs(rng, (size, size), "int")
    ta, tt = lap(t(c))
    r, col = linear_sum_assignment(c)
    assert float(tt) == float(c[r, col].sum())
    assert float(c[np.arange(size), n(ta)].sum()) == float(tt)


def test_float_costs_within_the_bound(rng):
    """Float costs: within the reference's 4e-6 n span of scipy's (both
    objectives summed in float64)."""
    c = _costs(rng, (64, 64), "float")
    ta, _ = lap(t(c))
    r, col = linear_sum_assignment(c)
    c64 = c.astype(np.float64)
    want = float(c64[r, col].sum())
    got = float(c64[np.arange(64), n(ta)].sum())
    assert want <= got <= want + 4e-6 * 64 * 1.0


def test_eps_schedule_matches_the_reference():
    import jax
    import jax.numpy as jnp

    for span in (1.0, 0.9999, 57.3, 99.0):
        want = jax.jit(lambda s: jnp.maximum(
            s / 2.0 / (6.0 ** jnp.arange(12)), s * 4e-6))(jnp.float32(span))
        got = la._eps_schedule(torch.tensor([span], dtype=torch.float32))[0]
        np.testing.assert_array_equal(n(got), np.asarray(want))


def test_refusals_and_inputs(rng):
    with pytest.raises(LogicError):
        lap(torch.zeros((3, 4)))
    c = rng.integers(0, 9, (6, 6))
    a, tot = lap(torch.as_tensor(c))                 # integer costs -> f32
    np.testing.assert_array_equal(n(a), n(j_lap(c.astype(np.float32))[0]))
    assert tot.dtype == torch.float32
