"""Compaction: reclaim tombstones, split hot lists, recluster drifted ones.

Port of ``raft_tpu/lifecycle/compact.py``. A pass:

1. reclaims tombstoned slots: live rows repack per list in their relative
   order, so pure reclamation leaves search results bit-identical;
2. (IVF-Flat) splits lists whose live occupancy exceeds ``split_above``
   times the mean, at the median of the members' principal-direction
   projection: the list keeps one child center, the other is appended;
3. (IVF-Flat) reclusters lists whose center drifted more than
   ``drift_threshold`` times the median nearest-center gap from their
   live-member mean: the center moves to the mean.

After a split or a recluster every live row is relabelled against the new
centers with ``kmeans_balanced.predict`` (kernel B1 on ``cuda``).

Publication is copy-on-write: the pass returns a successor index at
``epoch + 1`` and never writes the input, so a pass that raises leaves
nothing half done. IVF-PQ codes are residuals against their list's center
and cannot move lists without the source vectors, so IVF-PQ compaction
reclaims only, and drops the decode caches whose slot layout moved.

``shrink_capacity=False`` (the default) keeps the list capacity; True fits
it to the fullest list.

A sharded index (``ShardedIvfFlat`` / ``ShardedIvfPq``, with ``mesh=``)
compacts collectively: each rank repacks its own lists at one common
capacity (the current one, or with ``shrink_capacity`` the MAX allreduce
of every rank's fullest list), and the model pass is ignored (it would
move rows between ranks' lists). With ``balance_placement`` a pass over
a list-placed index doubles as the placement balancer: rank 0 weighs the
lists by its observed probe loads (``routing_stats``; the stored sizes
before any traffic), and when the hottest rank's load is past the
trigger and ``assign_lists`` lowers it, the pass migrates lists to rank
0's assignment (``sharded_migrate_lists``), under the one epoch bump of
the pass. It is deferred while a rank is dead.

:class:`Compactor` drives passes over a serving ``Searcher``
(``serve/searcher.py``): it fires at the policy's tombstone fraction, on
a drift signal or (balance policies) on a placement imbalance, and
publishes through ``Searcher.compact``, by hand
(:meth:`Compactor.run_once`) or from a background loop on its injected
``sleep``. Over a sharded searcher every rank runs the same passes: rank
0's trigger evaluation is broadcast, and the daemon's passes go through
the command channel of the ``BatchScheduler`` front rank
(``serve/scheduler.py``), so they never issue collectives out of order
with the batches.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.comms.agree import root_value
from raft_tpu_torch.comms.comms import Comms, OpT
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.logger import logger
from raft_tpu_torch.core.resources import as_float
from raft_tpu_torch.core.sentinels import worst_value
from raft_tpu_torch.lifecycle.delete import _check_index, _is_sharded
from raft_tpu_torch.neighbors import ivf_flat as _flat
from raft_tpu_torch.neighbors import ivf_pq as _pq
from raft_tpu_torch.parallel.ivf import (ShardedIvfPq, _agreed_live,
                                         _routed_sizes_h,
                                         sharded_migrate_lists)
from raft_tpu_torch.parallel.routing import assign_lists, routing_stats


@dataclass(frozen=True)
class CompactionPolicy:
    """Knobs of one pass. ``trigger_frac``: :class:`Compactor` runs a pass
    once this fraction of stored slots is tombstoned. ``shrink_capacity``:
    fit the list capacity to the fullest list. ``split_above`` /
    ``drift_threshold`` / ``min_split_rows``: the IVF-Flat model pass
    (None = off). ``balance_placement``: list-placed sharded indexes
    only; when the hottest rank's probe load (observed per-list traffic
    from ``parallel.routing.routing_stats``, the stored row counts before
    any traffic) exceeds this multiple of the mean rank load, the pass
    migrates lists to a re-balanced owner assignment (None = off)."""

    trigger_frac: float = 0.25
    shrink_capacity: bool = False
    split_above: Optional[float] = None
    drift_threshold: Optional[float] = None
    min_split_rows: int = 16
    balance_placement: Optional[float] = None

    def __post_init__(self):
        expects(0.0 < self.trigger_frac <= 1.0,
                "trigger_frac must be in (0, 1], got %s", self.trigger_frac)
        expects(self.split_above is None or self.split_above > 1.0,
                "split_above must be > 1 (a multiple of the mean load)")
        expects(self.drift_threshold is None or self.drift_threshold > 0,
                "drift_threshold must be > 0")
        expects(self.balance_placement is None
                or self.balance_placement >= 1.0,
                "balance_placement must be >= 1 (a multiple of the mean "
                "shard load)")


@dataclass(frozen=True)
class CompactionReport:
    """What one pass did."""

    reclaimed_slots: int
    live_rows: int
    lists_split: int
    lists_reclustered: int
    n_lists_before: int
    n_lists_after: int
    cap_before: int
    cap_after: int
    epoch: int            # the successor index's epoch
    # The placement balancer's migrations (list-placed sharded indexes).
    lists_migrated: int = 0


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: the mean of the two middle values
    of an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _repack(flat_rows, labels, flat_ids, n_lists: int, min_cap: int):
    """Scatter rows into capacity-padded lists; rows labelled ``n_lists``
    (dead slots) drop out. Stable in the flat slot order, so pure
    reclamation keeps each list's row order. Returns ``(store, ids,
    sizes, cap)``."""
    keep = labels < n_lists
    store, ids, sizes = _flat._pack_lists(flat_rows[keep], labels[keep],
                                          flat_ids[keep], n_lists, min_cap)
    return store, ids, sizes, store.shape[1]


def _live_slots(index) -> torch.Tensor:
    """Per-slot liveness: below the fill line and not tombstoned."""
    slot = torch.arange(index.indices.shape[-1], device=index.indices.device)
    live = slot < index.list_sizes[:, None]
    if index.deleted is not None:
        live &= ~index.deleted
    return live


def _reclaim_labels(live, n_lists: int) -> torch.Tensor:
    """Flat repack labels of pure reclamation: a live slot keeps its list,
    a dead one is labelled ``n_lists``."""
    lists = torch.arange(n_lists, device=live.device)[:, None]
    return torch.where(live, lists, n_lists).reshape(-1)


def _dense_live(store, indices, live):
    """The live rows and ids in slot order (one row at least, as the
    reference gathers)."""
    flat_live = live.reshape(-1)
    n_live = int(flat_live.sum())
    order = torch.argsort((~flat_live).to(torch.uint8),
                          stable=True)[:max(n_live, 1)]
    rows = store.reshape((-1,) + tuple(store.shape[2:]))[order]
    return rows, indices.reshape(-1)[order], n_live


def _split_two(rows):
    """Two child centers of one list's members, split at the median of
    their projection on the principal direction (8 power iterations from
    the ones vector): deterministic and about 50/50."""
    mean = torch.mean(rows, dim=0)
    X = rows - mean
    v = torch.ones((rows.shape[1],), dtype=rows.dtype, device=rows.device)
    for _ in range(8):
        v = X.T @ (X @ v)
        v = v / torch.clamp_min(torch.linalg.norm(v), 1e-12)
    proj = X @ v
    left = (proj <= _median(proj))[:, None].to(rows.dtype)
    n_left = torch.clamp_min(torch.sum(left), 1.0)
    n_right = torch.clamp_min(rows.shape[0] - torch.sum(left), 1.0)
    c0 = torch.sum(rows * left, dim=0) / n_left
    c1 = torch.sum(rows * (1.0 - left), dim=0) / n_right
    return c0, c1


def _flat_model_pass(index, policy: CompactionPolicy, live):
    """Recluster and split for IVF-Flat. Returns ``(centers, changed,
    n_split, n_reclustered, rows, ids)``, with the dense live rows and ids
    when the model changed."""
    centers = index.centers
    n_lists = index.n_lists
    dataf = as_float(index.data)
    livef = live.to(dataf.dtype)
    cnt = torch.sum(livef, dim=1)
    n_reclustered = 0
    changed = False

    if policy.drift_threshold is not None and n_lists > 1:
        sums = torch.einsum("lc,lcd->ld", livef, dataf)
        means = sums / torch.clamp_min(cnt, 1.0)[:, None]
        drift = torch.linalg.norm(centers - means, dim=1)
        cd = torch.linalg.norm(centers[:, None] - centers[None, :], dim=2)
        # Self-distance ranks last in the nearest-center minimum.
        cd = torch.where(torch.eye(n_lists, dtype=torch.bool,
                                   device=cd.device), worst_value(True), cd)
        scale = _median(torch.amin(cd, dim=1))
        drifted = (drift > policy.drift_threshold * scale) & (cnt > 0)
        n_reclustered = int(drifted.sum())
        if n_reclustered:
            centers = torch.where(drifted[:, None], means, centers)
            changed = True

    rows = ids = None
    n_split = 0
    if policy.split_above is not None or changed:
        rows, ids, n_live = _dense_live(index.data, index.indices, live)
        rowsf = as_float(rows)
        if policy.split_above is not None and n_live:
            kb = KMeansBalancedParams(metric=index.metric)
            labels = kmeans_balanced._predict(kb, centers, rowsf).long()
            counts = torch.bincount(labels,
                                    minlength=centers.shape[0]).cpu().numpy()
            mean_live = max(1.0, n_live / centers.shape[0])
            hot = np.flatnonzero((counts > policy.split_above * mean_live)
                                 & (counts >= policy.min_split_rows))
            for l in hot.tolist():
                c0, c1 = _split_two(rowsf[labels == l])
                centers = torch.cat([centers[:l], c0[None], centers[l + 1:],
                                     c1[None]])
            n_split = int(hot.size)
            changed = changed or n_split > 0
    return centers, changed, n_split, n_reclustered, rows, ids


def _compact_flat(index, policy: CompactionPolicy):
    live = _live_slots(index)
    cap = index.data.shape[1]
    min_cap = 0 if policy.shrink_capacity else cap
    centers, changed, n_split, n_recl, rows, ids = _flat_model_pass(
        index, policy, live)
    if changed:
        labels = kmeans_balanced._predict(
            KMeansBalancedParams(metric=index.metric), centers,
            as_float(rows)).long()
        data, idx, sizes, new_cap = _repack(rows.to(index.data.dtype), labels,
                                            ids, centers.shape[0], min_cap)
    else:
        data, idx, sizes, new_cap = _repack(
            index.data.reshape((-1,) + tuple(index.data.shape[2:])),
            _reclaim_labels(live, index.n_lists), index.indices.reshape(-1),
            index.n_lists, min_cap)
    new = dataclasses.replace(
        index, centers=centers, data=data, indices=idx, list_sizes=sizes,
        deleted=None, n_deleted=0, epoch=index.epoch + 1)
    return new, n_split, n_recl, cap, new_cap


def _warn_model_pass(policy: CompactionPolicy, what: str) -> None:
    if policy.split_above is not None or policy.drift_threshold is not None:
        logger.trace("split/recluster are IVF-Flat single-host passes (PQ "
                     "codes are residuals against their list's center and "
                     "cannot move lists without re-encoding) — ignored for "
                     "%s", what)


def _compact_pq(index, policy: CompactionPolicy):
    _warn_model_pass(policy, "IVF-PQ")
    live = _live_slots(index)
    cap = index.pq_codes.shape[1]
    min_cap = 0 if policy.shrink_capacity else cap
    codes, idx, sizes, new_cap = _repack(
        index.pq_codes.reshape(-1, index.pq_codes.shape[2]),
        _reclaim_labels(live, index.n_lists), index.indices.reshape(-1),
        index.n_lists, min_cap)
    new = dataclasses.replace(
        index, pq_codes=codes, indices=idx, list_sizes=sizes, deleted=None,
        n_deleted=0, epoch=index.epoch + 1, _recon=None, _scan_ops=None,
        _scan_ops_i8=None)
    return new, cap, new_cap


def _compact_sharded(mesh, index, policy: CompactionPolicy):
    """This rank's reclamation at the capacity common to every rank (the
    current one; with ``shrink_capacity`` the MAX allreduce of every
    rank's fullest live list). Returns ``(successor, cap, new cap)``."""
    _warn_model_pass(policy, "sharded indexes")
    is_pq = isinstance(index, ShardedIvfPq)
    store = index.pq_codes if is_pq else index.data
    n_slots, cap = index.indices.shape
    live = _live_slots(index)
    common = cap
    if policy.shrink_capacity:
        most = Comms(mesh).allreduce(live.sum(1).max().reshape(1).cpu(),
                                     OpT.MAX)
        common = max(int(most[0]), 1)
    st, idx, sizes, new_cap = _repack(
        store.reshape((-1,) + tuple(store.shape[2:])),
        _reclaim_labels(live, n_slots), index.indices.reshape(-1), n_slots,
        common)
    fields = dict(indices=idx, list_sizes=sizes, deleted=None, n_deleted=0,
                  n_rows=index.n_rows - index.n_deleted,
                  epoch=index.epoch + 1, _route_sizes=None)
    if is_pq:
        fields.update(pq_codes=st, _scan_cache=None)
    else:
        fields.update(data=st)
    return dataclasses.replace(index, **fields), cap, new_cap


def _balance_weights(index, sizes) -> np.ndarray:
    """Per-list migration weights: this placement generation's observed
    probe loads when the router has seen traffic, else the stored row
    counts ``sizes`` (the build-time packing criterion)."""
    loads = routing_stats.list_loads(index.placement_map).astype(np.float64)
    if loads.sum() == 0:
        loads = np.asarray(sizes, np.float64)
    return loads


def _owner_imbalance(owner, loads, n_dev: int) -> float:
    """The hottest rank's load as a multiple of the mean rank load under
    an owner assignment."""
    shard = np.zeros(n_dev, np.float64)
    np.add.at(shard, owner, np.asarray(loads, np.float64))
    mean = float(shard.mean())
    return float(shard.max()) / mean if mean > 0 else 1.0


def _placement_imbalance(index, loads) -> float:
    pm = index.placement_map
    return _owner_imbalance(pm.owner, loads, pm.n_dev)


def _balance_owner(mesh, index, policy: CompactionPolicy, live_mask):
    """The placement balancer's verdict, the same on every rank
    (collective): rank 0's re-balanced owner assignment when its loads
    put the hottest rank past ``policy.balance_placement`` and
    ``assign_lists`` lowers that (the improvement guard: a load the
    packing cannot balance below the trigger would otherwise migrate on
    every tick), else None. Deferred (None) while rank 0's ``live_mask``
    shows a dead rank: assigning lists onto it would trade load for
    coverage."""
    comms = Comms(mesh)
    pm = index.placement_map
    live = _agreed_live(comms, live_mask, pm.n_dev)
    if not live.all():
        logger.trace("placement balance deferred: %s dead shard(s)",
                     int((~live).sum()))
        return None
    sizes = _routed_sizes_h(comms, index)
    owner = None
    if mesh.rank == 0:
        loads = _balance_weights(index, sizes)
        cur = _owner_imbalance(pm.owner, loads, pm.n_dev)
        if cur >= policy.balance_placement:
            cand = assign_lists(loads, pm.n_dev,
                                centers=index.centers.float().cpu().numpy())
            if _owner_imbalance(cand, loads, pm.n_dev) < cur:
                owner = cand
    return root_value(comms, owner)


def compact(index, policy: Optional[CompactionPolicy] = None, mesh=None,
            live_mask=None):
    """Run one compaction pass: returns ``(successor at epoch + 1,
    report)``, or ``(index, None)`` when there is nothing to do (no
    tombstones, no model pass, no shrink, no re-balance). The input index
    is never written.

    A sharded index takes its ``mesh`` (collective: the same arguments on
    every rank). With ``balance_placement`` over a list placement the
    pass also migrates lists to rank 0's re-balanced assignment, under
    the same single epoch bump, so routed results are unchanged;
    ``live_mask`` (rank 0's is used; ``Searcher.compact`` passes its
    health's) defers the re-balance while a rank is dead."""
    policy = policy or CompactionPolicy()
    _check_index(index, mesh)
    wants_model = (policy.split_above is not None
                   or policy.drift_threshold is not None)
    bal_owner = None
    if (policy.balance_placement is not None and _is_sharded(index)
            and index.placement == "list"):
        bal_owner = _balance_owner(mesh, index, policy, live_mask)
    if (index.n_deleted == 0 and not wants_model
            and not policy.shrink_capacity and bal_owner is None):
        return index, None
    n_split = n_recl = n_migrated = 0
    if _is_sharded(index):
        if (bal_owner is not None and index.n_deleted == 0
                and not policy.shrink_capacity):
            # Balance only: a repack would rebuild the same tensors for
            # the migration to rewrite.
            new, cap = index, index.indices.shape[-1]
            new_cap = cap
        else:
            new, cap, new_cap = _compact_sharded(mesh, index, policy)
        if bal_owner is not None:
            new, n_migrated = sharded_migrate_lists(mesh, new, bal_owner,
                                                    live_mask=live_mask)
            # One published epoch bump for the whole pass.
            new = dataclasses.replace(new, epoch=index.epoch + 1)
        live_rows = new.size
    elif isinstance(index, _pq.Index):
        new, cap, new_cap = _compact_pq(index, policy)
        live_rows = int(torch.sum(new.list_sizes))
    else:
        new, n_split, n_recl, cap, new_cap = _compact_flat(index, policy)
        live_rows = int(torch.sum(new.list_sizes))
    report = CompactionReport(
        reclaimed_slots=index.n_deleted,
        live_rows=live_rows,
        lists_split=n_split,
        lists_reclustered=n_recl,
        n_lists_before=index.n_lists,
        n_lists_after=new.n_lists,
        cap_before=cap,
        cap_after=new_cap,
        epoch=new.epoch,
        lists_migrated=n_migrated,
    )
    return new, report


class Compactor:
    """Threshold-triggered compaction loop over a
    :class:`~raft_tpu_torch.serve.searcher.Searcher`.

    Deterministic surface first: tests (and schedulers that own their
    cadence) call :meth:`run_once`; :meth:`start` spawns the optional
    daemon loop (injectable ``sleep`` so the loop is still testable).
    ``pre_publish`` runs after the successor index is built but before
    the swap, so an injected fault there proves the no-partial-publish
    contract: the serving index and its epoch are untouched.

    The loop's passes issue CUDA work from their own thread on PyTorch's
    default stream, beside the serving thread's; the publish stays one
    reference swap, so in-flight batches keep their dispatch-time index.
    Over a sharded searcher the passes are collective (see
    :meth:`run_once` and :meth:`start`).
    """

    def __init__(self, searcher, policy: Optional[CompactionPolicy] = None,
                 interval: float = 5.0,
                 sleep: Callable[[float], None] = time.sleep,
                 pre_publish: Optional[Callable[[], None]] = None,
                 drift_signal: Optional[Callable[[], bool]] = None):
        self.searcher = searcher
        self.policy = policy or CompactionPolicy()
        self.interval = interval
        self._sleep = sleep
        self._pre_publish = pre_publish
        # Query-aware drift feed (typically a recall probe's drift flag):
        # forces a pass even below the tombstone trigger. EDGE-triggered:
        # one forced pass per drift episode — a level trigger would
        # rebuild the whole index every ``interval`` for as long as the
        # flag stays tripped; the flag must clear and re-trip to force
        # another.
        self._drift_signal = drift_signal
        self._drift_armed = True
        # balance_placement is edge-triggered like drift: one fired
        # evaluation per imbalance episode, re-armed when it clears.
        self._balance_armed = True
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.passes = 0
        self.skipped = 0
        self.failures = 0
        # Scrape surface: the last published report, the last failure
        # repr, and the last trigger evaluation (host values only).
        self.last_report: Optional[CompactionReport] = None
        self.last_error: Optional[str] = None
        self.last_should_run = False
        self.last_trigger_frac = 0.0

    def _mesh(self):
        """The sharded searcher's mesh, or None."""
        index = getattr(self.searcher, "_index", None)
        mesh = getattr(self.searcher, "mesh", None)
        return mesh if mesh is not None and _is_sharded(index) else None

    def _evaluate(self, index, sizes) -> None:
        """The trigger evaluation of :meth:`should_run` on this process's
        signals; ``sizes`` (the routed list sizes) when a balance policy
        watches a list placement, else None."""
        from raft_tpu_torch.lifecycle.delete import tombstone_frac

        frac = (tombstone_frac(index)
                if index is not None and getattr(index, "n_deleted", 0)
                else 0.0)
        raw_drift = (self._drift_signal is not None
                     and bool(self._drift_signal()))
        if not raw_drift:
            self._drift_armed = True        # episode over: re-arm
        drifted = raw_drift and self._drift_armed
        raw_imbal = False
        if sizes is not None:
            health = getattr(self.searcher, "health", None)
            # compact() would defer the migration while a rank is dead;
            # not firing keeps the edge armed for when it recovers.
            if health is None or health.all_live():
                raw_imbal = (_placement_imbalance(
                    index, _balance_weights(index, sizes))
                    >= self.policy.balance_placement)
        if not raw_imbal:
            self._balance_armed = True
        imbalanced = raw_imbal and self._balance_armed
        self.last_trigger_frac = frac
        self.last_should_run = (index is not None
                                and (drifted or imbalanced
                                     or frac >= self.policy.trigger_frac))
        if self.last_should_run and drifted:
            self._drift_armed = False       # one forced pass per episode
        if self.last_should_run and imbalanced:
            self._balance_armed = False     # one evaluation per episode

    def should_run(self) -> bool:
        """Tombstone fraction at or past the policy trigger, the
        ``drift_signal`` tripped, or (``balance_placement`` over a
        list-placed index) the observed probe load past the imbalance
        trigger; the last two once per episode (edge-triggered: the flag
        must clear to re-arm). Records the evaluation
        (``last_should_run`` / ``last_trigger_frac``). Over a sharded
        searcher it is collective: rank 0 evaluates and broadcasts its
        verdict and trigger state, which every rank adopts."""
        index = getattr(self.searcher, "_index", None)
        mesh = self._mesh()
        if mesh is None:     # a list placement is always sharded
            self._evaluate(index, None)
            return self.last_should_run
        comms = Comms(mesh)
        sizes = (_routed_sizes_h(comms, index)
                 if self.policy.balance_placement is not None
                 and index.placement == "list" else None)
        state = torch.zeros(4, dtype=torch.float64)
        if mesh.rank == 0:
            self._evaluate(index, sizes)
            state = torch.tensor([self.last_should_run, self._drift_armed,
                                  self._balance_armed,
                                  self.last_trigger_frac],
                                 dtype=torch.float64)
        run, drift_armed, balance_armed, frac = comms.bcast(state).tolist()
        self.last_should_run = bool(run)
        self._drift_armed, self._balance_armed = (bool(drift_armed),
                                                  bool(balance_armed))
        self.last_trigger_frac = frac
        return self.last_should_run

    def _front(self):
        """The ``BatchScheduler`` front rank serving this sharded
        searcher on this process (rank 0), or None."""
        return (getattr(self.searcher, "_front", None)
                if self._mesh() is not None else None)

    def run_once(self, force: bool = False) -> Optional[CompactionReport]:
        """One trigger check + (maybe) one pass; returns the report or
        None when below the trigger (``force`` skips the check). A
        raising pass counts ``failures`` and records ``last_error``
        before re-raising (the daemon loop additionally survives it).

        Over a sharded searcher it is collective. When a front rank's
        ``BatchScheduler`` serves it, call it on rank 0 only, from the
        thread that pumps: the scheduler's command channel brings the
        followers (``BatchScheduler.follow``) into the pass."""
        front = self._front()
        if front is not None:
            front._command_pass(self, force)
        if not force and not self.should_run():
            self.skipped += 1
            return None
        try:
            report = self.searcher.compact(self.policy,
                                           pre_publish=self._pre_publish)
        except Exception as err:
            self.failures += 1
            self.last_error = repr(err)
            raise
        if report is not None:
            self.passes += 1
            self.last_report = report
            self.last_error = None
        return report

    def start(self) -> None:
        """Spawn the background loop (daemon; idempotent). Over a sharded
        searcher the loop needs the ``BatchScheduler`` front rank: on rank
        0 each tick posts a pass that the scheduler's next ``pump`` runs
        (so its collectives never interleave with a batch's); the other
        ranks run no loop, their ``BatchScheduler.follow`` joins each
        pass."""
        if self._thread is not None:
            return
        mesh = self._mesh()
        front = self._front()
        if mesh is not None:
            expects(mesh.rank != 0 or front is not None,
                    "a Compactor daemon over a sharded searcher runs its "
                    "passes through the command channel of a "
                    "BatchScheduler on rank 0: build it first")
            if mesh.rank != 0:
                return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if front is not None:
                    front._post_pass(self)
                else:
                    try:
                        self.run_once()
                    except Exception:
                        # A failed pass published nothing — the daemon
                        # must survive to retry, not die silently while
                        # tombstones accumulate. run_once already counted
                        # ``failures`` and stamped ``last_error``.
                        logger.warning("compaction pass failed; daemon "
                                       "continues", exc_info=True)
                self._sleep(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="raft-tpu-torch-compactor")
        self._thread.start()

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        """Signal and join the background loop (idempotent). If the loop
        is mid-pass past ``timeout``, the handle is kept so a later
        ``start()`` cannot spawn a second concurrent loop."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                logger.warning(
                    "compactor loop still mid-pass after %.1fs join "
                    "timeout; keeping the handle (call stop() again)",
                    -1.0 if timeout is None else timeout)
                return
            self._thread = None
