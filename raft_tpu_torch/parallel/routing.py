"""List-owned IVF placement and probe-locality query routing.

Port of ``raft_tpu/parallel/routing.py``, host numpy by design, as in the
reference. The row placement (parallel/ivf.py) slices every IVF list
over every rank, so each query fans out to every shard. The list
placement assigns WHOLE lists to ranks (size-balanced bin packing over
the post-build list sizes; the coarse quantizer stays replicated), and a
search becomes route -> dispatch -> sparse merge: the router maps each
query's probed lists to the ranks that own them, groups the routed
queries and their local probe slots into power-of-two buckets (the
closed shape set of :func:`route_shapes`), each rank scans only its
locally probed lists for its routed queries, and the merge accounting
covers only the participating ranks.

Liveness (``ShardHealth.live_mask``) is a routing input: a dead rank
receives no queries, a list replicated on a second rank keeps serving
through its live copy, and a list with no live copy is reported as
per-query ``coverage`` loss.

Under SPMD every rank would compute its own plan; a plan that differs
by one replica choice leaves ranks waiting in different collectives.
So the sharded entry points (parallel/ivf.py) plan on rank 0 and
broadcast the plan; this module only computes.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.sentinels import PAD_ID
from raft_tpu_torch.util.pow2 import next_pow2
from raft_tpu_torch.util.telemetry import SuppressibleStats

_placement_keys = itertools.count()

#: Placement generations whose per-list probe loads ``routing_stats``
#: retains (most recently dispatched): bounds the process singleton —
#: periodic rebalances mint a fresh placement each, and a retired
#: generation's loads would otherwise be held forever.
_MAX_PLACEMENTS = 8


@dataclass(frozen=True)
class ListPlacement:
    """Host-side map of which shard owns (and optionally replicates)
    each IVF list under ``placement="list"``.

    ``owner``/``slot`` — each global list's primary shard and its local
    slot index there.  ``replica_owner``/``replica_slot`` — an optional
    second copy (−1 = none); replicas hold bit-identical list content
    (extend appends to both, delete masks both), so serving from either
    copy returns identical results and the router is free to pick by
    liveness and load.  ``slot_to_list`` — the per-shard inverse map
    (−1 = empty slot); slot ``n_slots − 1`` is empty on EVERY shard by
    construction — the padding target invalid probe entries point at
    (its list size is 0, so padded probes score only sentinels).
    """

    owner: np.ndarray            # (n_lists,) int32
    slot: np.ndarray             # (n_lists,) int32
    slot_to_list: np.ndarray     # (n_dev, n_slots) int32, -1 = empty
    n_slots: int
    n_dev: int
    replica_owner: np.ndarray    # (n_lists,) int32, -1 = none
    replica_slot: np.ndarray
    # Process-unique identity of this placement generation: the
    # telemetry key that keeps two routed indexes (or two placement
    # generations of one index) from cross-polluting the per-list
    # probe loads the balancer migrates by.  Not serialized — a reload
    # starts a fresh load history.
    key: int = field(default_factory=lambda: next(_placement_keys))     # (n_lists,) int32

    @property
    def n_lists(self) -> int:
        return int(self.owner.shape[0])

    @property
    def empty_slot(self) -> int:
        """The always-empty local slot padded probe entries point at."""
        return self.n_slots - 1

    def lists_owned(self) -> np.ndarray:
        """Primary lists per shard — the obs gauge feed."""
        return np.bincount(self.owner, minlength=self.n_dev)

    def serving_slot(self, serving: np.ndarray) -> np.ndarray:
        """Per-list local slot on the shard ``serving`` selected (the
        primary slot where serving == owner, else the replica slot)."""
        return np.where(serving == self.owner, self.slot,
                        self.replica_slot).astype(np.int32)


def assign_lists(weights, n_dev: int, centers=None,
                 active=None) -> np.ndarray:
    """Size-balanced bin packing of whole lists onto shards.

    Without ``centers``: LPT greedy — lists in descending weight order,
    each to the least-loaded shard (ties to the lowest shard id, so the
    assignment is deterministic).  ``weights`` is any per-list load
    proxy: post-build list sizes at build time, observed probe loads
    when the compactor rebalances.

    With ``centers`` (the coarse quantizer's (n_lists, dim) centroids):
    AFFINITY-AWARE packing — recursive principal-direction bisection of
    the centroid cloud, each cut splitting the weight as evenly as the
    shard split allows.  Lists whose centroids are close land on the
    same shard, which is what makes probe LOCALITY pay: a query's
    top-n_probes lists are centroid-neighbors by construction, so a
    clustered query's probes concentrate on one or two shards instead
    of scattering size-balanced across all of them (the fan-out /
    exchange-bytes win the routed placement exists for).  Deterministic
    (power iteration from a fixed start; stable sorts).

    ``active`` restricts the packing to a subset of shard ids (owners
    are drawn only from it; the returned array still indexes the full
    ``n_dev`` id space), for packing onto a serving set smaller than
    the mesh."""
    w = np.asarray(weights, np.float64).reshape(-1)
    expects(n_dev >= 1, "need at least one shard, got %s", n_dev)
    if active is not None:
        ranks = np.asarray(sorted(int(s) for s in active), np.int32)
        expects(ranks.size >= 1, "active shard set must be non-empty")
        expects(ranks.size == np.unique(ranks).size
                and ranks[0] >= 0 and ranks[-1] < n_dev,
                "active shards must be unique ids in [0, %s), got %s",
                n_dev, ranks.tolist())
        sub = assign_lists(w, int(ranks.size), centers=centers)
        return ranks[sub]
    if centers is None:
        owner = np.zeros(w.shape[0], np.int32)
        loads = np.zeros(n_dev, np.float64)
        # Stable sort on -w keeps equal-weight lists in id order — the
        # deterministic tie-break the round-trip tests rely on.
        for g in np.argsort(-w, kind="stable"):
            s = int(np.argmin(loads))
            owner[g] = s
            loads[s] += w[g]
        return owner
    C = np.asarray(centers, np.float64)
    expects(C.shape[0] == w.shape[0],
            "centers must be (n_lists, dim) matching weights")
    owner = np.zeros(w.shape[0], np.int32)

    def principal_order(idx):
        X = C[idx] - C[idx].mean(axis=0)
        v = np.ones(X.shape[1])
        for _ in range(8):                  # power iteration on X^T X
            v = X.T @ (X @ v)
            nrm = np.linalg.norm(v)
            if nrm < 1e-12:
                break
            v = v / nrm
        # Ties (and the degenerate all-equal cloud) break by list id.
        return idx[np.argsort(X @ v, kind="stable")]

    def bisect(idx, shards):
        if len(shards) == 1 or idx.size <= 1:
            owner[idx] = shards[0]
            return
        k1 = len(shards) // 2
        order = principal_order(idx)
        cum = np.cumsum(w[order])
        target = cum[-1] * (k1 / len(shards))
        # Cut at the weight boundary, keeping both halves non-empty.
        cut = int(np.clip(np.searchsorted(cum, target) + 1, 1,
                          idx.size - 1))
        bisect(order[:cut], shards[:k1])
        bisect(order[cut:], shards[k1:])

    bisect(np.arange(w.shape[0]), list(range(n_dev)))
    return owner


def build_placement(owner, n_dev: int, min_slots: int = 0,
                    replica_owner=None, replica_slot=None
                    ) -> ListPlacement:
    """Materialize a :class:`ListPlacement` from a per-list owner
    assignment.  Local slots are dealt in ascending global list id
    (deterministic); ``n_slots`` is the pow2 bucket of the fullest
    shard's count + 1, so every shard keeps at least one always-empty
    padding slot and small migrations usually land in the SAME shape
    class.  ``min_slots`` pins the slot count (a migration that keeps
    the predecessor's shapes keeps its warmed kernel shapes)."""
    owner = np.asarray(owner, np.int32).reshape(-1)
    n_lists = owner.shape[0]
    expects(n_lists >= 1, "placement needs at least one list")
    expects(owner.min() >= 0 and owner.max() < n_dev,
            "owner entries must be in [0, %s)", n_dev)
    slot = np.zeros(n_lists, np.int32)
    counts = np.zeros(n_dev, np.int64)
    for g in range(n_lists):
        slot[g] = counts[owner[g]]
        counts[owner[g]] += 1
    n_slots = max(next_pow2(int(counts.max()) + 1), int(min_slots), 2)
    if replica_owner is None:
        replica_owner = np.full(n_lists, PAD_ID, np.int32)
        replica_slot = np.full(n_lists, PAD_ID, np.int32)
    else:
        replica_owner = np.asarray(replica_owner, np.int32).reshape(-1)
        replica_slot = np.asarray(replica_slot, np.int32).reshape(-1)
    slot_to_list = np.full((n_dev, n_slots), PAD_ID, np.int32)
    slot_to_list[owner, slot] = np.arange(n_lists, dtype=np.int32)
    rep = replica_owner >= 0
    slot_to_list[replica_owner[rep], replica_slot[rep]] = \
        np.flatnonzero(rep).astype(np.int32)
    return ListPlacement(owner=owner, slot=slot,
                         slot_to_list=slot_to_list,
                         n_slots=int(n_slots), n_dev=int(n_dev),
                         replica_owner=replica_owner,
                         replica_slot=replica_slot)


@dataclass(frozen=True)
class RoutePlan:
    """One batch's routing decision (host arrays, pow2-bucketed shapes).

    ``q_rows[s]`` — the global query rows routed to shard ``s``, padded
    with ``n_queries`` (out of range → the scatter back to global query
    positions drops them).  ``probe_slots[s, j]`` — query ``j``'s
    locally-probed slots on shard ``s``, padded with the placement's
    always-empty slot (size 0 → sentinels only).  ``qg``/``pb`` are the
    pow2 group/probe-width buckets — the ONLY batch-dependent shapes
    of the per-rank scans, both from closed ladders
    (:func:`route_shapes`).
    ``coverage`` is the per-query fraction of probed candidate rows
    with a live owner (None when liveness was not consulted).
    """

    q_rows: np.ndarray         # (n_dev, qg) int32
    probe_slots: np.ndarray    # (n_dev, qg, pb) int32
    qg: int
    pb: int
    n_queries: int
    participants: int          # shards with >= 1 routed query
    fanout_mean: float         # mean shards per query
    replica_hits: int          # probe occurrences served by a replica
    coverage: Optional[np.ndarray] = None   # (n_queries,) float32
    # Real (non-padding) rows of a shape-bucketed batch; None = all.
    n_valid: Optional[int] = None
    # Probe occurrences steered off a suspect primary onto a healthy
    # replica (suspect_mask routing input; 0 when not consulted).
    suspect_avoided: int = 0


def route_shapes(n_queries: int, n_probes: int
                 ) -> Tuple[Tuple[int, int], ...]:
    """The closed (qg, pb) shape set routed dispatches of an
    ``n_queries``-wide batch at ``n_probes`` can produce — what
    ``serve.bucketing.warmup`` runs once each for routed searchers."""
    qgs, b = [], 1
    while b < next_pow2(max(n_queries, 1)):
        qgs.append(b)
        b *= 2
    qgs.append(next_pow2(max(n_queries, 1)))
    pbs, b = [], 1
    while b < next_pow2(max(n_probes, 1)):
        pbs.append(b)
        b *= 2
    pbs.append(next_pow2(max(n_probes, 1)))
    return tuple((qg, pb) for qg in qgs for pb in pbs)


def empty_plan(placement: ListPlacement, n_queries: int, qg: int,
               pb: int) -> RoutePlan:
    """An all-padding plan of the given bucket shape — the warmup
    vehicle: dispatching it runs the per-rank scans at exactly the
    shapes a real plan of that bucket gives them, and scores only
    sentinels."""
    return RoutePlan(
        q_rows=np.full((placement.n_dev, qg), n_queries, np.int32),
        probe_slots=np.full((placement.n_dev, qg, pb),
                            placement.empty_slot, np.int32),
        qg=qg, pb=pb, n_queries=n_queries, participants=0,
        fanout_mean=0.0, replica_hits=0)


def plan_route(probe_ids: np.ndarray, placement: ListPlacement,
               live_mask=None, list_sizes=None,
               n_valid: Optional[int] = None,
               suspect_mask=None) -> RoutePlan:
    """Map a batch's probe assignments to per-shard query groups.

    ``probe_ids`` — host (n_queries, n_probes) int32, the SAME coarse
    top-n_probes the single-host search computes (the replicated
    quantizer), read back by the routed entry point.  ``live_mask``
    makes liveness a routing input: each probed list serves from a live
    owner (primary preferred; a live replica when the primary is dead;
    when both are live the batch's probe occurrences go to the less
    loaded of the two — whole-list, so the decision is deterministic),
    and a list with no live owner drops out as coverage loss.
    ``list_sizes`` (host (n_lists,) rows per list) prices the coverage
    fractions; required when ``live_mask`` is given.

    ``suspect_mask`` makes LATENCY a routing input
    (comms.health.ShardHealth.suspect_mask): a suspect primary with a
    live non-suspect replica serves this batch through the replica,
    and both-live read balancing only spreads across pairs where both
    copies are healthy (one suspect copy pins the list to the healthy
    one).  A suspect shard with no stand-in still serves — suspect is
    a preference, never a coverage loss.

    ``n_valid`` marks a shape-bucketed batch: rows at or past it are
    the scheduler's zero padding — they are routed NOWHERE (no shard
    scans them, they never count toward fan-out / participants /
    probe-load telemetry, and their coverage reads 1.0) while the plan
    keeps the padded batch's scatter width, so the shape set
    is unchanged.
    """
    probe_ids = np.asarray(probe_ids)
    n_q, n_probes = probe_ids.shape
    n_real = n_q if n_valid is None else min(max(int(n_valid), 0), n_q)
    n_dev = placement.n_dev
    serving = placement.owner.copy()
    unreachable = np.zeros(placement.n_lists, bool)
    replica_hits = 0
    occ = np.bincount(probe_ids[:n_real].reshape(-1),
                      minlength=placement.n_lists)
    if live_mask is not None:
        live = np.asarray(live_mask, bool)
        expects(live.shape == (n_dev,),
                "live_mask must be (%s,), got %s", n_dev, live.shape)
        prim_live = live[placement.owner]
        rep = placement.replica_owner
        rep_live = (rep >= 0) & live[np.maximum(rep, 0)]
        unreachable = ~prim_live & ~rep_live
        serving = np.where(~prim_live & rep_live, rep, serving)
    else:
        prim_live = np.ones(placement.n_lists, bool)
        rep = placement.replica_owner
        rep_live = rep >= 0
    if suspect_mask is not None:
        suspect = np.asarray(suspect_mask, bool)
        expects(suspect.shape == (n_dev,),
                "suspect_mask must be (%s,), got %s", n_dev,
                suspect.shape)
    else:
        suspect = np.zeros(n_dev, bool)
    prim_susp = prim_live & suspect[placement.owner]
    rep_susp = rep_live & suspect[np.maximum(rep, 0)]
    # Suspect avoidance: a live-but-slow primary with a healthy live
    # replica serves through the replica (suspect != unreachable — a
    # suspect-only copy still serves at full coverage).
    prefer_rep = prim_susp & rep_live & ~rep_susp
    serving = np.where(prefer_rep, rep, serving)
    suspect_avoided = int(occ[prefer_rep].sum())
    # Replica read balancing: lists live on BOTH copies route this
    # batch's occurrences to the lighter shard — hot lists are why the
    # replica exists.  Descending-occurrence greedy, deterministic.
    # Only both-HEALTHY pairs balance: one suspect copy pins the list
    # to the other.
    both = np.flatnonzero(prim_live & ~prim_susp & rep_live & ~rep_susp
                          & (occ > 0))
    if both.size:
        loads = np.zeros(n_dev, np.int64)
        single = np.ones(placement.n_lists, bool)
        single[both] = False
        np.add.at(loads, serving[single & ~unreachable],
                  occ[single & ~unreachable])
        for g in both[np.argsort(-occ[both], kind="stable")]:
            a, b = int(placement.owner[g]), int(rep[g])
            serving[g] = a if loads[a] <= loads[b] else b
            loads[serving[g]] += occ[g]
    replica_hits = int(occ[(serving != placement.owner)
                           & ~unreachable].sum())

    sslot = placement.serving_slot(serving)
    sel = serving[probe_ids]                       # (n_q, n_probes)
    reach = ~unreachable[probe_ids]
    reach[n_real:, :] = False                      # padding routes nowhere
    part = np.zeros((n_dev, n_q), bool)
    counts = np.zeros((n_dev, n_q), np.int32)
    masks = []
    for s in range(n_dev):
        m = (sel == s) & reach
        masks.append(m)             # reused by the scatter loop below
        counts[s] = m.sum(axis=1)
        part[s] = counts[s] > 0
    qg = min(next_pow2(max(int(part.sum(axis=1).max()), 1)),
             next_pow2(max(n_q, 1)))
    pb = min(next_pow2(max(int(counts.max()), 1)),
             next_pow2(max(n_probes, 1)))
    q_rows = np.full((n_dev, qg), n_q, np.int32)
    probe_slots = np.full((n_dev, qg, pb), placement.empty_slot,
                          np.int32)
    local = sslot[probe_ids]                       # (n_q, n_probes)
    for s in range(n_dev):
        qs = np.flatnonzero(part[s])
        q_rows[s, :qs.size] = qs
        if not qs.size:
            continue
        m = masks[s]
        # One vectorized scatter per shard (the serving hot path —
        # a per-query Python loop here dominated routed dispatch):
        # row-major nonzero keeps each query's slots in probe-rank
        # order; the running cumsum is each occurrence's position in
        # its query's local probe list.
        gpos = np.full(n_q, PAD_ID, np.int64)
        gpos[qs] = np.arange(qs.size)
        qq, pp = np.nonzero(m)
        rank = (np.cumsum(m, axis=1) - 1)[qq, pp]
        probe_slots[s, gpos[qq], rank] = local[qq, pp]
    coverage = None
    if live_mask is not None:
        expects(list_sizes is not None,
                "plan_route needs list_sizes to price coverage under "
                "a live_mask")
        sz = np.asarray(list_sizes, np.float64)
        total = sz[probe_ids].sum(axis=1)
        livec = (sz[probe_ids] * reach).sum(axis=1)
        coverage = (livec / np.maximum(total, 1.0)).astype(np.float32)
        coverage[n_real:] = 1.0       # padding: nothing to cover
    return RoutePlan(
        q_rows=q_rows, probe_slots=probe_slots, qg=int(qg), pb=int(pb),
        n_queries=n_q, participants=int(part.any(axis=1).sum()),
        fanout_mean=float(part.sum()) / max(n_real, 1),
        replica_hits=replica_hits, coverage=coverage,
        n_valid=None if n_valid is None else n_real,
        suspect_avoided=suspect_avoided)


def participant_ranks(plan: RoutePlan) -> np.ndarray:
    """The shard ranks a plan routes >= 1 query to — the per-dispatch
    participation set the Searcher attributes latency observations to
    (``ShardHealth.observe_latency``) and hands chaos rank hooks."""
    return np.flatnonzero((plan.q_rows < plan.n_queries).any(axis=1))


class RoutingStats(SuppressibleStats):
    """Host-side routing telemetry the routed entry points feed — the
    probe-locality analog of ``MergeDispatchStats``: per-shard routed
    query / probe-occurrence loads, fan-out, replica hits, and the
    per-LIST probe loads the compactor's placement balancer consumes
    (``sharded_migrate_lists`` over ``assign_lists``).  One lock +
    numpy adds per host dispatch.  Every rank records the same plan
    (the plan is rank 0's, broadcast), so every rank's counts agree.
    ``suppress`` (util/telemetry.py) drops a thread's shadow traffic —
    the recall probe's exact scans and serve warmup's synthetic
    dispatches would otherwise skew the loads the balancer migrates
    real lists by."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._shard_queries: Dict[int, int] = {}
        self._shard_probes: Dict[int, int] = {}
        # Per-PLACEMENT probe loads (keyed by ListPlacement.key): two
        # routed indexes served in one process — or two placement
        # generations across a migration — must not cross-pollute the
        # weights the balancer migrates real lists by.  Insertion order
        # tracks recency; superseded generations are pruned past
        # ``_MAX_PLACEMENTS`` (a retired placement's loads would
        # otherwise be retained forever by this process singleton).
        self._list_load: Dict[int, np.ndarray] = {}
        self._lists_owned: Dict[int, int] = {}
        self._lists_owned_key: Optional[int] = None
        self.dispatches = 0
        self.queries = 0
        self.fanout_sum = 0.0
        self.replica_hits = 0
        self.suspect_avoided = 0

    def record(self, plan: RoutePlan, placement: ListPlacement,
               probe_ids=None) -> None:
        if self._suppressed():
            return
        real = (plan.n_valid if plan.n_valid is not None
                else plan.n_queries)
        with self._lock:
            self.dispatches += 1
            self.queries += real
            self.fanout_sum += plan.fanout_mean * real
            self.replica_hits += plan.replica_hits
            self.suspect_avoided += plan.suspect_avoided
            empty = placement.empty_slot
            for s in range(placement.n_dev):
                routed = int((plan.q_rows[s] < plan.n_queries).sum())
                probes = int((plan.probe_slots[s] != empty).sum())
                self._shard_queries[s] = \
                    self._shard_queries.get(s, 0) + routed
                self._shard_probes[s] = \
                    self._shard_probes.get(s, 0) + probes
            if self._lists_owned_key != placement.key:
                # lists_owned is constant per placement generation —
                # an O(n_lists) bincount per dispatch would tax the
                # routed hot path for an unchanging gauge.
                self._lists_owned = {
                    s: int(n)
                    for s, n in enumerate(placement.lists_owned())}
                self._lists_owned_key = placement.key
            if probe_ids is not None:
                occ = np.bincount(np.asarray(probe_ids).reshape(-1),
                                  minlength=placement.n_lists
                                  ).astype(np.int64)
                prev = self._list_load.pop(placement.key, None)
                if prev is not None:
                    prev += occ
                    occ = prev
                # re-insert last: dict order is the recency order the
                # prune below evicts from.
                self._list_load[placement.key] = occ
                while len(self._list_load) > _MAX_PLACEMENTS:
                    self._list_load.pop(next(iter(self._list_load)))

    def list_loads(self, placement: ListPlacement) -> np.ndarray:
        """THIS placement's observed per-list probe loads — the
        balancer's weight vector.  Loads start fresh for each placement
        generation (a migration publishes a new placement), so a
        historical skew never drives a second migration."""
        with self._lock:
            out = np.zeros(placement.n_lists, np.int64)
            got = self._list_load.get(placement.key)
            if got is not None:
                n = min(out.shape[0], got.shape[0])
                out[:n] = got[:n]
            return out

    def snapshot(self) -> dict:
        with self._lock:
            mean = (self.fanout_sum / self.queries) if self.queries else 0.0
            return {
                "dispatches": self.dispatches,
                "queries": self.queries,
                "fanout_mean": mean,
                "replica_hits": self.replica_hits,
                "suspect_avoided": self.suspect_avoided,
                "shard_queries": dict(self._shard_queries),
                "shard_probes": dict(self._shard_probes),
                "lists_owned": dict(self._lists_owned),
            }

    def reset(self) -> None:
        with self._lock:
            self._shard_queries.clear()
            self._shard_probes.clear()
            self._lists_owned.clear()
            self._lists_owned_key = None
            self._list_load.clear()
            self.dispatches = 0
            self.queries = 0
            self.fanout_sum = 0.0
            self.replica_hits = 0
            self.suspect_avoided = 0


#: Process-wide recorder the routed entry points feed (reset() is
#: test-only).
routing_stats = RoutingStats()
