"""Uniform search facade for the serving runtime.

Port of ``raft_tpu/serve/searcher.py``. The serving runtime needs one
object that hides which index family and which deployment (one device,
or sharded over a ``torch.distributed`` mesh) sits underneath, because
the scheduler (serve/scheduler.py) batches requests against an opaque
``search(q, k)``. :class:`Searcher` is that facade over
``brute_force.knn``, ``ivf_flat.search`` and ``ivf_pq.search``, and with
``mesh=`` over ``parallel.sharded_knn``, ``parallel.sharded_ivf_flat_search``
(a ``ShardedIvfFlat``) and ``parallel.sharded_ivf_pq_search`` (a
``ShardedIvfPq``), on either placement:

* ``device`` — every search runs on the device of the database or index
  (or an explicit ``device=``, which must match it), or the mesh's;
  numpy queries move there, and nothing carries on elsewhere when that
  device is missing;
* ``merge_engine`` — the top-k merge engine of every sharded search
  (comms/topk_merge.py);
* ``ShardHealth`` — when a rank is dead, sharded searches pass its
  ``live_mask`` (rank 0's, broadcast) and serve DEGRADED: exact over the
  survivors, with the per-query ``coverage`` in the result. A
  list-placed (routed) index takes liveness as a routing input, steers
  replicated lists off SUSPECT ranks (rank 0's ``suspect_mask``), and
  feeds each dispatch's wall time back to every participating rank
  (``ShardHealth.observe_latency``);
* ``dispatch_hook`` — called after each routed dispatch with its
  participating ranks (the chaos seam);
* ``HedgePolicy`` — a routed dispatch that outlives its per-bucket
  budget while a participant has newly gone SUSPECT is re-dispatched
  around it, and the faster answer by the injected clock serves
  (``SearchResult.hedged``);
* ``RetryPolicy`` — transient host-side failures retry with the
  deterministic backoff of ``core/retry.py``;
* ``epoch`` — the cache-invalidation key (serve/cache.py): bumped by
  every mutation (extend / delete / upsert / compact), so cached results
  can never outlive the index state they were computed against.

Write side (raft_tpu_torch/lifecycle): ``delete`` tombstones rows
(exact over the survivors at once), ``upsert`` replaces rows under one
epoch bump, ``compact`` publishes a copy-on-write successor index by
swapping one reference — in-flight batches keep searching their
dispatch-time snapshot. Mutations work on a shallow copy of the served
index and publish it with one reference swap; an ``extend`` that fits
the list capacity writes its rows in place, into slots past the served
snapshot's fill line, which that snapshot never reads. Mutations
serialize on an internal lock; searches never take it.

A sharded searcher is collective: every rank of the mesh builds it with
the same arguments and makes the same calls in the same order. Its
``extend``, ``delete``, ``upsert`` and ``compact`` are the sharded ones.
Every decision that one rank makes from its own clock or errors is
agreed before a collective depends on it (``comms/agree.py``): a failed
attempt is agreed after its collectives, so every rank retries together
or raises the same error; rank 0's clock and suspect mask decide a hedge
and pick its answer; ``shadow_probe`` returns rank 0's elapsed time; a
``pre_publish`` fault on any rank publishes nothing on every rank.

Durability (raft_tpu_torch/lifecycle/wal.py): with a ``wal`` attached
(sharded IVF kinds only), every mutation appends its record, fsynced,
BEFORE the serving reference swaps (write-ahead order: a record exists
iff the epoch it stamps was ever observable), and publishes run the
log's snapshot cadence. On a sharded searcher the log's one writer is
rank 0 and the append's outcome is agreed before any rank publishes: a
failed append publishes nowhere. ``writable=False`` builds a read-only
follower endpoint: searches serve, mutations raise until a
``PromotionManager`` flips the flag. :meth:`publish_index` publishes an
externally built successor (elastic resize, follower catch-up).
"""

from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_float, as_vectors, resolve_device
from raft_tpu_torch.core.retry import RetryPolicy, with_retry

_KINDS = ("brute_force", "ivf_flat", "ivf_pq")


@dataclass(frozen=True)
class SearchResult:
    """One request's answer: host arrays.

    ``coverage`` is all-ones on healthy serves; under degraded sharded
    serving it is the per-query fraction of candidate rows searched, and
    ``degraded`` flags that a live mask was applied. ``hedged`` flags
    that the answer came from a hedged re-dispatch. The degradation-ladder
    fields: ``quality`` is the served-quality class
    ("full" — the configured n_probes; "reduced" — a middle ladder rung;
    "brownout" — the deepest rung), ``degrade_reason`` names what forced
    the rung ("queue_pressure" / "deadline_budget"; None at full
    quality).
    """

    distances: np.ndarray   # (n_queries, k)
    indices: np.ndarray     # (n_queries, k)
    coverage: np.ndarray    # (n_queries,)
    degraded: bool = False
    hedged: bool = False
    quality: str = "full"
    degrade_reason: Optional[str] = None


def _host(x) -> np.ndarray:
    """A mutation's input as host numpy, as the log records it."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``a`` and ``b`` name one device (``cuda`` is the current card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)


class Searcher:
    """One serving endpoint over a brute-force / IVF-Flat / IVF-PQ index,
    on one device or sharded over a mesh. Build with the classmethods:

    >>> s = Searcher.brute_force(db, mesh=mesh, health=health)   # doctest: +SKIP
    >>> s = Searcher.ivf_flat(index, sp)                         # doctest: +SKIP
    >>> res = s.search(queries, k=10)                            # doctest: +SKIP
    """

    def __init__(self, kind: str, *, mesh=None, db=None, index=None,
                 search_params=None, merge_engine: str = "auto",
                 health=None, retry: Optional[RetryPolicy] = None,
                 wal=None, writable: bool = True,
                 hedge=None, dispatch_hook=None,
                 sleep: Callable[[float], None] = time.sleep,
                 monotonic: Callable[[], float] = time.monotonic,
                 device=None):
        expects(kind in _KINDS, "kind must be one of %s, got %r", _KINDS,
                kind)
        expects((db is not None) == (kind == "brute_force"),
                "brute_force takes db; IVF kinds take index")
        if kind != "brute_force":
            expects(index is not None and search_params is not None,
                    "IVF searchers need index + search_params")
        expects(health is None or mesh is not None,
                "ShardHealth only applies to sharded (mesh) searchers "
                "(ROADMAP A.4)")
        expects(wal is None or (mesh is not None
                                and kind != "brute_force"),
                "a MutationLog records sharded IVF mutations (brute-"
                "force rows are positional — nothing stable to replay)")
        expects(hedge is None or health is not None,
                "hedging needs a sharded searcher with a ShardHealth "
                "(ROADMAP A.4): the hedge re-routes around SUSPECT shards")
        expects(dispatch_hook is None or mesh is not None,
                "dispatch_hook observes the routed dispatches of a sharded "
                "searcher (ROADMAP A.4)")
        if mesh is not None:
            from raft_tpu_torch.parallel.ivf import (ShardedIvfFlat,
                                                     ShardedIvfPq)
            from raft_tpu_torch.parallel.knn import _check_mesh

            _check_mesh(mesh)
            expects(kind != "ivf_flat" or isinstance(index, ShardedIvfFlat),
                    "a sharded IVF-Flat searcher takes a ShardedIvfFlat")
            expects(kind != "ivf_pq" or isinstance(index, ShardedIvfPq),
                    "a sharded IVF-PQ searcher takes a ShardedIvfPq")
            expects(health is None or health.n_ranks == mesh.size,
                    "ShardHealth over %s ranks, mesh of %s",
                    getattr(health, "n_ranks", None), mesh.size)
            expects(wal is None or mesh.size == 1
                    or getattr(wal, "mesh", None) is not None,
                    "the MutationLog of a sharded searcher takes its mesh "
                    "(MutationLog(..., mesh=mesh)): rank 0 writes it")
        self.kind = kind
        self.mesh = mesh
        self.merge_engine = merge_engine
        self.health = health
        self.retry = retry
        self.wal = wal
        self.writable = writable
        self._dispatch_hook = dispatch_hook
        from raft_tpu_torch.serve.hedge import HedgeStats
        from raft_tpu_torch.serve.stats import ServeStats

        self.hedge = hedge
        self.hedge_stats = HedgeStats()
        # Per-dispatch-shape latency windows, the hedge budget's evidence
        # (apart from a scheduler's ServeStats, whose windows include
        # queueing).
        self._dispatch_stats = ServeStats()
        # The BatchScheduler front rank serving this sharded searcher on
        # this process, if any (its command channel carries the
        # Compactor daemon's passes).
        self._front = None
        self._sleep = sleep
        self._monotonic = monotonic
        self._params = search_params
        self._base_epoch = 0
        if mesh is not None:
            # Sharded: this rank's shard, placed once on the mesh's device.
            dev = mesh.device
            if kind == "brute_force":
                from raft_tpu_torch.parallel.knn import shard_database

                db = shard_database(mesh, db)
        elif kind == "brute_force":
            # Placed once: the scheduler searches per batch, and a
            # host-to-device copy of the database per request would
            # dominate serving latency. A tensor stays where it is.
            db = as_float(db, device=device)
            dev = db.device
        else:
            dev = index.centers.device
        expects(device is None or _same_device(resolve_device(device), dev),
                "device %s differs from the %s's device %s", device,
                "database" if kind == "brute_force" else "index", dev)
        self.device = dev
        self._db = db
        self._index = index
        # Serializes mutations (extend/delete/upsert/compact) against
        # each other — a compaction racing an extend would publish a
        # successor missing the extend's rows.  Searches never take it.
        self._lock = threading.Lock()
        self._invalidation_hooks: List[Callable[[], None]] = []

    # -- constructors ------------------------------------------------------
    @classmethod
    def brute_force(cls, db, mesh=None, **kw) -> "Searcher":
        """Exact kNN endpoint (``brute_force.knn``)."""
        return cls("brute_force", mesh=mesh, db=db, **kw)

    @classmethod
    def ivf_flat(cls, index, search_params, mesh=None, **kw) -> "Searcher":
        """IVF-Flat endpoint over a built ``ivf_flat.Index``."""
        return cls("ivf_flat", mesh=mesh, index=index,
                   search_params=search_params, **kw)

    @classmethod
    def ivf_pq(cls, index, search_params, mesh=None, **kw) -> "Searcher":
        """IVF-PQ endpoint over a built ``ivf_pq.Index``."""
        return cls("ivf_pq", mesh=mesh, index=index,
                   search_params=search_params, **kw)

    # -- identity ----------------------------------------------------------
    @property
    def dim(self) -> int:
        """Query dimensionality (what warmup's dummy queries must have)."""
        if self.kind == "brute_force":
            return int(self._db.shape[1])
        return int(self._index.centers.shape[1])

    @property
    def id_dtype(self) -> torch.dtype:
        """The dtype of the ids this endpoint answers with (int32 for
        brute force; the index's for IVF kinds), part of the result
        cache's key."""
        if self.kind == "brute_force":
            return torch.int32
        return self._index.indices.dtype

    @property
    def epoch(self) -> int:
        """Monotonic index-content version — the cache-invalidation key.
        IVF indexes carry their own counter, bumped by every extend even
        when called outside this facade; brute-force extends count in
        ``_base_epoch``."""
        return self._base_epoch + int(getattr(self._index, "epoch", 0))

    def add_invalidation_hook(
            self, hook: Callable[[], None]) -> Callable[[], None]:
        """Run ``hook()`` after every mutation (the scheduler registers
        its ResultCache.invalidate here). Returns an idempotent
        unsubscribe callable — a Searcher outlives its schedulers, so
        an unremovable hook would retain every retired cache forever."""
        with self._lock:
            self._invalidation_hooks.append(hook)

        def remove() -> None:
            with self._lock:
                try:
                    self._invalidation_hooks.remove(hook)
                except ValueError:
                    pass

        return remove

    def _fire_hooks(self) -> None:
        """Invoke the invalidation hooks OUTSIDE the mutation lock (a
        hook may take its own lock; holding ours across foreign code
        invites lock-order inversions)."""
        with self._lock:
            hooks = list(self._invalidation_hooks)
        for hook in hooks:
            hook()

    # -- durability --------------------------------------------------------
    def _require_writable(self) -> None:
        expects(self.writable,
                "read-only follower endpoint — mutations are rejected "
                "until promotion (lifecycle.wal.PromotionManager)")

    def _wal_append(self, kind: str, new_index, payload: dict) -> None:
        """Durably log one mutation at its POST-mutation epoch, with the
        successor built but not yet published: the write-ahead order (a
        crash after the append replays the mutation, a crash before it
        loses a mutation no reader saw). Collective on a sharded
        searcher: a failed append raises on every rank."""
        if self.wal is not None:
            self.wal.append(kind, int(new_index.epoch), payload)

    def _published(self) -> None:
        """Post-publish duties: invalidation hooks (outside the lock),
        then the log's snapshot cadence (a snapshot rides the epoch the
        swap just committed; collective, on agreed epochs)."""
        self._fire_hooks()
        if self.wal is not None:
            self.wal.maybe_snapshot(self._index, self.mesh)

    def publish_index(self, new_index, *, record=None,
                      expect_base_epoch: Optional[int] = None) -> None:
        """Publish an externally built copy-on-write successor under the
        snapshot-swap contract (elastic join / leave cutover, follower
        catch-up). ``record=(kind, payload)`` logs the mutation
        write-ahead; ``expect_base_epoch`` asserts no concurrent mutation
        slipped in while the successor was being built instead of
        silently dropping it."""
        with self._lock:
            cur = int(getattr(self._index, "epoch", 0))
            if expect_base_epoch is not None:
                expects(cur == expect_base_epoch,
                        "concurrent mutation during publish: index "
                        "moved %s -> %s while the successor was built",
                        expect_base_epoch, cur)
            expects(int(new_index.epoch) > cur,
                    "publish must advance the epoch (%s -> %s)", cur,
                    int(new_index.epoch))
            if record is not None:
                kind, payload = record
                self._wal_append(kind, new_index, payload)
            self._index = new_index
        self._published()

    # -- serving -----------------------------------------------------------
    def _queries(self, queries) -> torch.Tensor:
        """The queries as a tensor on this searcher's device: numpy moves
        there; a tensor must already be there."""
        q = as_vectors(queries, device=self.device)
        expects(q.device == self.device,
                "queries on %s, searcher on %s", q.device, self.device)
        return q

    def _resolve_live(self, degraded: Optional[bool]):
        """The live mask to pass, or None for the healthy search.
        ``degraded=True`` forces the masked search while every rank is
        live; None masks once the registry reports a dead rank. Every rank
        holds its own registry, so rank 0's mask decides for all (one
        broadcast a search, :func:`check_live_mask`): the ranks take the
        same path."""
        if self.health is None or degraded is False:
            return None
        from raft_tpu_torch.comms.comms import Comms
        from raft_tpu_torch.parallel.degraded import check_live_mask

        live = check_live_mask(self.health.live_mask, Comms(self.mesh))
        if degraded or not live.all():
            return live
        return None

    def _is_routed(self) -> bool:
        return (self.mesh is not None
                and getattr(self._index, "placement", "row") == "list")

    def _dispatch(self, q: torch.Tensor, k: int, params, live=None,
                  valid_rows=None, suspect=None, plan_cb=None):
        if self.mesh is not None:
            # ``live`` is already agreed (_resolve_live): the bodies
            # skip the entry points' second broadcast of it.
            from raft_tpu_torch.parallel.ivf import (_sharded_ivf_flat_search,
                                                     _sharded_ivf_pq_search)
            from raft_tpu_torch.parallel.knn import _sharded_knn

            if self.kind == "brute_force":
                return _sharded_knn(self.mesh, self._db, q, k, False,
                                    self.merge_engine, live, 0)
            body = (_sharded_ivf_flat_search if self.kind == "ivf_flat"
                    else _sharded_ivf_pq_search)
            return body(self.mesh, params, self._index, q, k,
                        self.merge_engine, live, 0, valid_rows=valid_rows,
                        suspect=suspect, plan_cb=plan_cb)
        if self.kind == "brute_force":
            from raft_tpu_torch.neighbors import brute_force

            return brute_force.knn(self._db, q, k)
        if self.kind == "ivf_flat":
            from raft_tpu_torch.neighbors import ivf_flat

            return ivf_flat.search(params, self._index, q, k)
        from raft_tpu_torch.neighbors import ivf_pq

        return ivf_pq.search(params, self._index, q, k)

    def search(self, queries, k: int,
               degraded: Optional[bool] = None,
               span=None, valid_rows: Optional[int] = None,
               n_probes: Optional[int] = None
               ) -> SearchResult:
        """One synchronous search, already shaped (the scheduler owns
        bucketing/padding). Retries under ``self.retry`` when set. On a
        sharded searcher with a ``ShardHealth``, ``degraded=None`` serves
        the healthy search while every rank is live and the masked one
        (exact over the survivors, with ``coverage``) once a rank is dead;
        True / False force either. ``valid_rows`` marks the real rows
        of a zero-padded batch: the list placement's router routes the
        others nowhere.

        A routed (list-placed) searcher with a ``ShardHealth`` routes
        replicated lists off SUSPECT ranks (rank 0's mask: rank 0 plans)
        and, after each dispatch, hands the plan's participating ranks to
        ``dispatch_hook`` and the dispatch's wall time to
        ``health.observe_latency`` of each of them; with a ``hedge``
        policy, a dispatch that outlived its budget is hedged
        (:meth:`_maybe_hedge`).

        On a sharded searcher ``retry`` is agreed: after each attempt the
        ranks agree on its outcome (``comms/agree.with_agreed_retry``),
        so they retry together under the same backoff or all raise the
        original exception type.

        ``n_probes`` overrides the configured probe count for THIS call
        (IVF kinds) — the degradation ladder's knob
        (serve/scheduler.DegradePolicy). Warm its rungs ahead of traffic
        with ``serve.bucketing.warmup(degrade_ladder=...)``.

        ``span`` (an :class:`raft_tpu_torch.obs.trace.Span`) attaches the
        two device-boundary child spans — ``device_dispatch`` (fenced with
        a CUDA synchronise on a card, so the measured interval is device
        time, not enqueue time) and ``device_get`` (the copy of the
        distances and ids to the host). With no recording span the fence
        is SKIPPED: tracing off must not serialize the dispatch."""
        from raft_tpu_torch.obs.trace import NULL_SPAN

        sp = span if span is not None else NULL_SPAN
        q = self._queries(queries)
        expects(q.ndim == 2, "queries must be (n, dim), got %s",
                tuple(q.shape))
        expects(q.shape[1] == self.dim, "query dim %s != index dim %s",
                q.shape[1], self.dim)
        expects(k >= 1, "k must be >= 1, got %s", k)
        params = self._params
        if n_probes is not None and self.kind != "brute_force":
            import dataclasses

            params = dataclasses.replace(self._params,
                                         n_probes=int(n_probes))

        live = self._resolve_live(degraded)
        routed = self._is_routed()
        suspect = None
        if routed and self.health is not None:
            sus = self.health.suspect_mask
            if sus.any():
                suspect = sus
        track = routed and (self.health is not None
                            or self._dispatch_hook is not None)
        plan_box: list = []

        def attempt():
            return self._dispatch(q, k, params, live, valid_rows=valid_rows,
                                  suspect=suspect,
                                  plan_cb=plan_box.append if track else None)

        hedged = False
        with sp.child("device_dispatch", kind=self.kind,
                      engine=self.merge_engine,
                      sharded=self.mesh is not None) as dd:
            t0 = self._monotonic()
            if self.retry is not None and self.mesh is not None:
                from raft_tpu_torch.comms.agree import with_agreed_retry
                from raft_tpu_torch.comms.comms import Comms

                out = with_agreed_retry(attempt, self.retry,
                                        Comms(self.mesh), sleep=self._sleep,
                                        monotonic=self._monotonic)
            elif self.retry is not None:
                out = with_retry(attempt, self.retry, sleep=self._sleep,
                                 monotonic=self._monotonic)
            else:
                out = attempt()
            if track and plan_box:
                ranks, elapsed = self._after_dispatch(plan_box[-1], t0)
                if self.hedge is not None and self.health is not None:
                    out, hedged, elapsed = self._maybe_hedge(
                        out, q, k, live, params, valid_rows, suspect, ranks,
                        elapsed)
                self._dispatch_stats.observe_latency(
                    (int(q.shape[0]), int(k)), elapsed)
            if dd.recording and self.device.type == "cuda":
                # Fence so the span closes when the DEVICE finishes, not
                # when the launches were enqueued.
                torch.cuda.synchronize(self.device)
        with sp.child("device_get"):
            host = [t.cpu().numpy() for t in out]
        if len(host) == 3:
            d, i, cov = host
            return SearchResult(d, i, cov, degraded=True, hedged=hedged)
        d, i = host
        return SearchResult(d, i, np.ones(q.shape[0], np.float32),
                            hedged=hedged)

    def _after_dispatch(self, plan, t0: float):
        """Health plumbing of one routed dispatch: the plan's
        participating ranks go to ``dispatch_hook`` (a scripted straggler
        advances the injected clock here), then the elapsed time to
        ``health.observe_latency`` of each (the SUSPECT feed). Returns
        ``(participant ranks, elapsed seconds)``."""
        from raft_tpu_torch.parallel.routing import participant_ranks

        ranks = participant_ranks(plan)
        if self._dispatch_hook is not None:
            self._dispatch_hook(ranks)
        elapsed = self._monotonic() - t0
        if self.health is not None:
            for r in ranks:
                self.health.observe_latency(int(r), elapsed)
        return ranks, elapsed

    def _maybe_hedge(self, out, q, k: int, live, params, valid_rows,
                     suspect, ranks, elapsed: float):
        """The hedge decision for one completed routed dispatch: when the
        elapsed time outlived the per-bucket budget AND a participant has
        newly gone suspect, re-dispatch with the fresh suspect mask
        (every replicated list steers onto its healthy copy) and serve
        the faster answer by the clock. Collective: rank 0's clock,
        budget and suspect mask decide, and rank 0's clock picks the
        answer (two broadcasts), so ``hedged`` and ``hedge_stats`` are
        the same on every rank. Returns ``(result, hedged, elapsed of the
        served answer)``, the elapsed time rank 0's."""
        from raft_tpu_torch.comms.comms import Comms

        comms = Comms(self.mesh)
        n = self.health.n_ranks
        head = torch.zeros(2 + n, dtype=torch.float64)
        if comms.get_rank() == 0:
            budget = self.hedge.budget(self._dispatch_stats.latency_quantile(
                (int(q.shape[0]), int(k)), self.hedge.quantile,
                min_samples=self.hedge.min_samples))
            now = self.health.suspect_mask
            code = 0                       # within budget
            if budget is not None and elapsed > budget:
                prev = (np.asarray(suspect, bool) if suspect is not None
                        else np.zeros(n, bool))
                # Over budget: hedge only with a NEW suspect participant
                # to steer around; else re-planning repeats the route.
                code = 2 if any(now[int(r)] and not prev[int(r)]
                                for r in ranks) else 1
            head = torch.as_tensor(np.concatenate(
                [[code, elapsed], now.astype(np.float64)]))
        head = comms.bcast(head).numpy()
        code, elapsed = int(head[0]), float(head[1])
        if code == 0:
            return out, False, elapsed
        if code == 1:
            self.hedge_stats.record(suppressed=True)
            return out, False, elapsed
        self.hedge_stats.record(fired=True)
        plan_box: list = []
        t1 = self._monotonic()
        out2 = self._dispatch(q, k, params, live, valid_rows=valid_rows,
                              suspect=head[2:] > 0.5,
                              plan_cb=plan_box.append)
        elapsed2 = elapsed
        if plan_box:
            _, elapsed2 = self._after_dispatch(plan_box[-1], t1)
        won, elapsed2 = (float(v) for v in comms.bcast(torch.tensor(
            [float(elapsed2 < elapsed), elapsed2], dtype=torch.float64)))
        if won:
            self.hedge_stats.record(won=True)
            return out2, True, elapsed2
        return out, True, elapsed

    def shadow_probe(self, rank: int, queries, k: int) -> float:
        """One off-the-hot-path probe of a dead or suspect rank, the
        recovery prober's tool: the degraded search with ``rank`` forced
        live in (rank 0's) live mask, under suppressed merge and routing
        telemetry (shadow traffic must not skew the serving scrapes or the
        placement balancer's loads). Its latency does not feed
        ``health.observe_latency``: the candidate's slowness is the
        prober's verdict to make. ``dispatch_hook`` sees the plan's
        participants and the probed rank. Collective: a failure on any
        rank raises the same error on every rank, and the return value is
        rank 0's elapsed seconds on its injected clock."""
        expects(self.health is not None and self.mesh is not None,
                "shadow_probe needs a sharded searcher with a ShardHealth "
                "(ROADMAP A.4)")
        from raft_tpu_torch.comms.agree import agreed
        from raft_tpu_torch.comms.comms import Comms
        from raft_tpu_torch.comms.topk_merge import merge_dispatch_stats
        from raft_tpu_torch.parallel.degraded import check_live_mask
        from raft_tpu_torch.parallel.routing import (participant_ranks,
                                                     routing_stats)

        comms = Comms(self.mesh)
        q = self._queries(queries)
        expects(q.ndim == 2 and q.shape[1] == self.dim,
                "probe queries must be (n, %s), got %s", self.dim,
                tuple(q.shape))
        live = check_live_mask(self.health.live_mask, comms)
        live[int(rank)] = True
        plan_box: list = []
        t0 = self._monotonic()
        with agreed(comms):
            with merge_dispatch_stats.suppress(), routing_stats.suppress():
                self._dispatch(q, k, self._params, live,
                               plan_cb=plan_box.append if self._is_routed()
                               else None)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if self._dispatch_hook is not None:
                ranks = (participant_ranks(plan_box[-1]) if plan_box
                         else np.arange(self.health.n_ranks))
                # The probed rank always counts: a delay scripted against
                # it must slow the probe even when the plan routed every
                # query elsewhere, or a vacuous probe would read clean.
                self._dispatch_hook(np.union1d(ranks, [int(rank)]))
        elapsed = self._monotonic() - t0
        return float(comms.bcast(torch.tensor([elapsed],
                                              dtype=torch.float64))[0])

    # -- lifecycle ---------------------------------------------------------
    def extend(self, new_vectors, new_indices=None) -> None:
        """Grow the underlying index and bump the epoch (invalidating
        every cached result written against the old contents)."""
        self._require_writable()
        with self._lock:
            self._extend_locked(new_vectors, new_indices)
        self._published()

    def _mutable_snapshot(self):
        """Shallow copy of the served index for a mutate-then-swap
        publish: the lifecycle functions replace the COPY's fields, the
        served object stays internally consistent for lock-free readers,
        and one reference assignment commits the whole mutation."""
        return copy.copy(self._index)

    def _extend_locked(self, new_vectors, new_indices=None) -> None:
        if self.kind == "brute_force":
            X = as_float(new_vectors, device=self.device)
            expects(X.device == self.device, "new_vectors on %s, searcher "
                    "on %s", X.device, self.device)
            expects(X.ndim == 2 and X.shape[1] == self.dim,
                    "new_vectors must be (n, %s), got shape %s", self.dim,
                    tuple(X.shape))
            if self.mesh is None:
                self._db = torch.cat([self._db, X.to(self._db.dtype)], dim=0)
            else:
                # The rows are re-dealt over the ranks, as the reference
                # re-shards the grown database: gather, append, re-shard.
                from raft_tpu_torch.comms.comms import Comms
                from raft_tpu_torch.parallel.knn import shard_database

                rows = self._db.rows
                full = torch.cat([Comms(self.mesh).allgather(rows),
                                  X.to(rows.dtype)], dim=0)
                expects(full.shape[0] % self.mesh.size == 0,
                        "extend would leave %s total rows, not divisible "
                        "by the %s-way mesh; pad the increment upstream",
                        full.shape[0], self.mesh.size)
                self._db = shard_database(self.mesh, full)
            self._base_epoch += 1
            return
        if self.mesh is not None:
            from raft_tpu_torch.parallel.ivf import (sharded_ivf_flat_extend,
                                                     sharded_ivf_pq_extend)

            extend = (sharded_ivf_flat_extend if self.kind == "ivf_flat"
                      else sharded_ivf_pq_extend)
            # Copy-on-write: readers may hold the current tensors.
            tmp = self._mutable_snapshot()
            if self.wal is not None:
                new_vectors = _host(new_vectors)
                if new_indices is None:
                    # Pin the auto-assigned ids so the record holds the
                    # ids this extend assigns: replay after a compaction
                    # (which drops tombstoned ids) would derive others.
                    from raft_tpu_torch.neighbors.ivf_flat import \
                        _auto_id_base

                    base = _auto_id_base(tmp)
                    new_indices = np.arange(
                        base, base + new_vectors.shape[0],
                        dtype=_np_dtype(tmp.indices.dtype))
            extend(self.mesh, tmp, new_vectors, new_indices, donate=False)
            if self.wal is not None:
                self._wal_append("extend", tmp, dict(
                    vectors=new_vectors, ids=_host(new_indices)))
            self._index = tmp
            return
        from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

        mod = ivf_flat if self.kind == "ivf_flat" else ivf_pq
        # extend bumps the Index's own .epoch (the counter this facade's
        # ``epoch`` property reads) — no _base_epoch bump, or every
        # extend would count twice.
        tmp = self._mutable_snapshot()
        mod.extend(tmp, new_vectors, new_indices)
        self._index = tmp

    def delete(self, ids) -> int:
        """Tombstone rows by stored id (raft_tpu_torch/lifecycle): exact
        over the survivors at once. Returns how many slots were newly
        tombstoned; bumps the epoch (invalidating cached results) only
        when that count is non-zero. IVF endpoints only — the brute-force
        database has no id-stable delete."""
        expects(self.kind != "brute_force",
                "delete needs an IVF index (brute-force rows are "
                "positional; rebuild the endpoint instead)")
        self._require_writable()
        from raft_tpu_torch.lifecycle import delete as _delete

        with self._lock:
            tmp = self._mutable_snapshot()
            n = _delete(tmp, ids, mesh=self.mesh)
            if n:
                # Log only committed deletes: an all-miss delete bumps no
                # epoch, so a record of it could never replay.
                self._wal_append("delete", tmp, dict(ids=_host(ids)))
                self._index = tmp     # snapshot-swap publish
        if n:
            self._published()
        return n

    def upsert(self, new_vectors, new_indices) -> None:
        """Replace-or-insert rows by explicit id under ONE epoch bump
        (tombstone + extend; raft_tpu_torch/lifecycle.upsert) — no reader
        observes the half-applied state as a committed epoch."""
        expects(self.kind != "brute_force",
                "upsert needs an IVF index (brute-force rows are "
                "positional; rebuild the endpoint instead)")
        self._require_writable()
        from raft_tpu_torch.lifecycle import upsert as _upsert

        with self._lock:
            tmp = self._mutable_snapshot()
            _upsert(tmp, new_vectors, new_indices, mesh=self.mesh,
                    donate=False)
            self._wal_append("upsert", tmp, dict(
                vectors=_host(new_vectors), ids=_host(new_indices)))
            self._index = tmp
        self._published()

    def compact(self, policy=None, pre_publish=None):
        """Run one compaction pass (raft_tpu_torch/lifecycle/compact.py)
        and publish its copy-on-write successor index by swapping ONE
        reference under the mutation lock — in-flight batches keep
        searching their dispatch-time snapshot, whose cache entries die
        with the old epoch. Returns the
        :class:`~raft_tpu_torch.lifecycle.compact.CompactionReport`, or
        None when there was nothing to do. ``pre_publish`` runs after the
        successor is built, before the swap (a fault there publishes
        nothing; on a sharded searcher, nothing on any rank). The
        health's live mask gates the placement balancer."""
        expects(self.kind != "brute_force",
                "compact applies to IVF indexes (brute-force holds no "
                "tombstones)")
        self._require_writable()
        from raft_tpu_torch.lifecycle import CompactionPolicy
        from raft_tpu_torch.lifecycle import compact as _compact

        policy = policy or CompactionPolicy()
        with self._lock:
            # Liveness gates the placement balancer (a re-balance must not
            # assign lists onto a dead rank).
            live = (self.health.live_mask if self.health is not None
                    else None)
            new, report = _compact(self._index, policy, mesh=self.mesh,
                                   live_mask=live)
            if report is None:
                return None
            from raft_tpu_torch.comms.agree import agreed
            from raft_tpu_torch.comms.comms import Comms

            # A fault on any rank publishes nothing on every rank.
            with agreed(None if self.mesh is None else Comms(self.mesh)):
                if pre_publish is not None:
                    pre_publish()
            if self.wal is not None:
                from raft_tpu_torch.lifecycle.wal import _policy_payload

                payload = _policy_payload(policy)
                old_pm = getattr(self._index, "placement_map", None)
                new_pm = getattr(new, "placement_map", None)
                if new_pm is not None and new_pm is not old_pm:
                    # The pass balanced the placement off process-local
                    # traffic: record the OUTCOME, so replay migrates to
                    # it (compact() used rank 0's live mask; the record
                    # is rank 0's).
                    payload["owner"] = np.asarray(new_pm.owner, np.int32)
                    payload["live"] = (np.asarray(live, bool)
                                       if live is not None else
                                       np.ones(new_pm.n_dev, bool))
                self._wal_append("compact", new, payload)
            self._index = new
        self._published()
        return report

    @property
    def tombstone_frac(self) -> float:
        """Fraction of stored slots tombstoned (the Compactor trigger
        statistic); 0.0 for brute-force endpoints."""
        if self.kind == "brute_force":
            return 0.0
        from raft_tpu_torch.lifecycle import tombstone_frac as _frac

        return _frac(self._index)

    def __repr__(self) -> str:
        return ("Searcher(kind=%r, sharded=%s, epoch=%s, engine=%r)"
                % (self.kind, self.mesh is not None, self.epoch,
                   self.merge_engine))
