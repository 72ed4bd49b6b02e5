"""Parity of raft_tpu_torch.parallel.routing (the list placement's bin
packing and router, host numpy in both packages) with raft_tpu's.

No world and no tensors: the same seeded numpy inputs go to both modules,
and placements, route plans and routing telemetry must be EQUAL, array
for array and field for field (the placements' process-local ``key``
aside).
"""

import dataclasses

import numpy as np
import pytest

import raft_tpu.parallel.routing as jr
import raft_tpu_torch.parallel.routing as pr

SEEDS = range(6)


def _same(a, b, skip=("key",)):
    """Two dataclass instances (or plain values) with equal fields."""
    if dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(b):
            if f.name not in skip:
                _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _same(a[k], b[k])
    else:
        assert a == b and type(a) is type(b), (a, b)


def _placements(rng, n_lists, n_dev, replicas: bool):
    """The same placement built by both modules, with about a third of
    the lists replicated when ``replicas``."""
    owner = rng.integers(0, n_dev, n_lists)
    kw = {}
    if replicas and n_dev > 1:
        rep_o = np.full(n_lists, -1, np.int32)
        rep_s = np.full(n_lists, -1, np.int32)
        nxt = np.bincount(owner, minlength=n_dev)   # first free slots
        for g in rng.choice(n_lists, n_lists // 3, replace=False):
            s = int((owner[g] + 1 + rng.integers(0, n_dev - 1)) % n_dev)
            rep_o[g], rep_s[g] = s, nxt[s]
            nxt[s] += 1
        kw = dict(replica_owner=rep_o, replica_slot=rep_s,
                  min_slots=int(2 ** np.ceil(np.log2(nxt.max() + 1))))
    return (pr.build_placement(owner, n_dev, **kw),
            jr.build_placement(owner, n_dev, **kw))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_assign_lists(seed, n_dev):
    rng = np.random.default_rng(seed)
    n_lists = int(rng.integers(n_dev, 40))
    weights = rng.integers(0, 50, n_lists)
    centers = rng.standard_normal((n_lists, 6)).astype(np.float32)
    for w in (weights, weights.astype(np.float64) + rng.random(n_lists),
              np.ones(n_lists)):
        _same(pr.assign_lists(w, n_dev), jr.assign_lists(w, n_dev))
        _same(pr.assign_lists(w, n_dev, centers=centers),
              jr.assign_lists(w, n_dev, centers=centers))
    active = sorted(rng.choice(n_dev, max(1, n_dev - 1), replace=False))
    _same(pr.assign_lists(weights, n_dev, centers=centers, active=active),
          jr.assign_lists(weights, n_dev, centers=centers, active=active))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("replicas", [False, True])
def test_build_placement(seed, replicas):
    rng = np.random.default_rng(seed)
    for n_dev in (1, 2, 4, 5):
        p, j = _placements(rng, int(rng.integers(n_dev, 30)), n_dev,
                           replicas)
        _same(p, j)
        _same(p.lists_owned(), j.lists_owned())
        assert p.empty_slot == j.empty_slot and p.n_lists == j.n_lists
        serving = np.where(rng.random(p.n_lists) < 0.5, p.owner,
                           np.maximum(p.replica_owner, 0))
        _same(p.serving_slot(serving), j.serving_slot(serving))
    _same(pr.build_placement([0, 1, 1, 0], 2, min_slots=16),
          jr.build_placement([0, 1, 1, 0], 2, min_slots=16))


def _masks(rng, n_dev):
    live = rng.random(n_dev) < 0.7
    live[rng.integers(0, n_dev)] = True
    return live, rng.random(n_dev) < 0.4


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_dev", [1, 2, 4, 5])
@pytest.mark.parametrize("replicas", [False, True])
def test_plan_route(seed, n_dev, replicas):
    """Healthy, live, suspect and padded (n_valid) routing, the shapes and
    participants, and the all-padding plan."""
    rng = np.random.default_rng(seed)
    n_lists = int(rng.integers(max(n_dev, 4), 24))
    p, j = _placements(rng, n_lists, n_dev, replicas)
    n_q = int(rng.integers(1, 40))
    n_probes = int(rng.integers(1, min(n_lists, 6) + 1))
    probe = np.stack([rng.choice(n_lists, n_probes, replace=False)
                      for _ in range(n_q)]).astype(np.int32)
    sizes = rng.integers(0, 30, n_lists)
    live, suspect = _masks(rng, n_dev)
    n_valid = int(rng.integers(0, n_q + 1))
    for kw in (dict(), dict(live_mask=live, list_sizes=sizes),
               dict(suspect_mask=suspect),
               dict(live_mask=live, list_sizes=sizes, suspect_mask=suspect,
                    n_valid=n_valid),
               dict(n_valid=n_valid)):
        plan = pr.plan_route(probe, p, **kw)
        ref = jr.plan_route(probe, j, **kw)
        _same(plan, ref)
        _same(pr.participant_ranks(plan), jr.participant_ranks(ref))
        assert (plan.qg, plan.pb) in pr.route_shapes(n_q, n_probes)
    _same(pr.route_shapes(n_q, n_probes), jr.route_shapes(n_q, n_probes))
    for qg, pb in pr.route_shapes(n_q, n_probes)[::3]:
        _same(pr.empty_plan(p, n_q, qg, pb), jr.empty_plan(j, n_q, qg, pb))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_routing_stats(seed):
    """The telemetry of a run of plans: snapshots and per-list loads, per
    placement generation, with suppressed records dropped."""
    rng = np.random.default_rng(seed)
    ps, js = pr.RoutingStats(), jr.RoutingStats()
    gens = [_placements(rng, 12, 4, True) for _ in range(2)]
    for step in range(6):
        p, j = gens[step % 2]
        probe = rng.integers(0, 12, (9, 3)).astype(np.int32)
        valid = None if step % 3 else 5
        for stats, pm, mod in ((ps, p, pr), (js, j, jr)):
            plan = mod.plan_route(probe, pm, n_valid=valid)
            ids = probe if valid is None else probe[:valid]
            stats.record(plan, pm, probe_ids=ids)
            with stats.suppress():
                stats.record(plan, pm, probe_ids=ids)
        _same(ps.snapshot(), js.snapshot())
        for (p, j) in gens:
            _same(ps.list_loads(p), js.list_loads(j))
    ps.reset()
    js.reset()
    _same(ps.snapshot(), js.snapshot())
