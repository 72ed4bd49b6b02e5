"""Dynamic micro-batching query scheduler for online serving.

Port of ``raft_tpu/serve/scheduler.py``, host logic on the injected clock
as it is: requests of arbitrary size arrive asynchronously, a bounded
queue absorbs bursts, and a max-batch-size / max-wait-time policy
coalesces them into the padded shapes of the bucket grid
(serve/bucketing.py) — the classic dynamic-batching tier (the
TF-Serving / Triton BatchScheduler shape).

Disciplines:

* **Injectable monotonic clock** — every timing decision (wait ripeness,
  deadlines, latency stats) reads the injected clock, never wall time,
  matching ``core/retry.py``; tests drive the scheduler tick by tick
  and assert exact shed/flush behavior.
* **Typed admission control** — a full queue sheds NEW work with
  :class:`Overloaded` at submit time (clients can back off / hedge)
  instead of letting latency collapse for everything already queued.
* **Deadline-aware, degrade-don't-fail** — a request whose deadline is
  at risk flushes its batch immediately rather than waiting for fill;
  under queue or deadline pressure the degradation ladder shrinks
  ``n_probes`` (:class:`DegradePolicy`), and a missed deadline is a
  counter, never an exception. Reduced answers are never cached.

Over a sharded ``Searcher`` (SPMD, one process per rank) the scheduler
runs on rank 0, the front rank, unchanged: bucketing, cache, shedding,
the degrade ladder and stats are rank 0's alone. Each batch it
dispatches is first broadcast as one command (the padded queries, ``k``,
``valid_rows``, ``n_probes``, ``degraded``), and every other rank runs
:meth:`BatchScheduler.follow`, which receives the commands and makes the
same ``Searcher.search`` call, so every rank makes the searcher's
collective calls in the same order; ``close`` sends the stop command.
A ``Compactor`` over the searcher sends its passes through the same
channel, and so does a ``RecallProbe`` its truth searches. This is the
SPMD form of the reference's scheduler, whose one controller drives
every device: ``follow`` is the one call that the reference does not
have.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

import torch

from raft_tpu_torch.core.error import RaftError, expects
from raft_tpu_torch.core.logger import logger
from raft_tpu_torch.obs.trace import NULL_SPAN, NULL_TRACER, Tracer
from raft_tpu_torch.serve.bucketing import BucketGrid, pad_queries
from raft_tpu_torch.serve.cache import ResultCache
from raft_tpu_torch.serve.searcher import SearchResult, Searcher
from raft_tpu_torch.serve.stats import ServeStats


# The front rank's commands: a header of int64s, then for a search the
# padded float32 queries.
_STOP, _SEARCH, _COMPACT, _TRUTH = 0, 1, 2, 3
_HEAD = 8       # op, rows, dim, k, valid_rows, n_probes, degraded, force


def _tri(flag: Optional[bool]) -> int:
    return -1 if flag is None else int(bool(flag))


class Overloaded(RaftError):
    """Admission control: the request queue is at ``max_queue`` — shed
    this request now (the client backs off) instead of queueing into
    certain deadline misses."""


@dataclass(frozen=True)
class BatchPolicy:
    """When to stop waiting and dispatch.

    A batch dispatches as soon as ANY of: its bucket holds
    ``max_batch`` queued rows; its oldest request has waited
    ``max_wait`` seconds; a member's deadline could not survive another
    full wait. ``max_queue`` bounds queued REQUESTS — submit #max_queue+1
    sheds with :class:`Overloaded`, deterministically.
    """

    max_batch: int = 64
    max_wait: float = 0.002
    max_queue: int = 1024

    def __post_init__(self):
        expects(self.max_batch >= 1, "max_batch must be >= 1")
        expects(self.max_wait >= 0.0, "max_wait must be >= 0")
        expects(self.max_queue >= 1, "max_queue must be >= 1")


@dataclass(frozen=True)
class DegradePolicy:
    """Deadline degradation ladder: shrink ``n_probes`` before shedding.

    When queue pressure or a batch's remaining deadline budget undercuts
    the per-bucket latency model (:meth:`ServeStats.latency_quantile`),
    the scheduler steps down a ladder of probe fractions instead of
    letting the batch miss its deadline at full depth — degrade, don't
    drop (docs/fault_tolerance.md).  ``ladder`` is a descending tuple of
    probe fractions; rung 0 MUST be 1.0 (full quality).  Rung quality
    classes: rung 0 = ``"full"``, the last rung = ``"brownout"``,
    everything between = ``"reduced"`` — every degraded answer carries
    its class and ``degrade_reason`` on the :class:`SearchResult`.

    The ladder only ever shrinks ``n_probes`` to values from a closed
    set — warm them ahead of traffic with
    ``warmup(..., degrade_ladder=policy.ladder)`` so brownout meets warm
    plan caches.
    """

    ladder: tuple = (1.0, 0.5, 0.25)
    queue_high: float = 0.5     # queue fill fraction that forces rung >= 1
    queue_full: float = 0.9     # queue fill fraction that forces the deepest rung
    latency_quantile: float = 0.95  # per-bucket quantile the latency model reads
    min_samples: int = 16       # observations before the model is trusted
    min_probes: int = 1         # never shrink n_probes below this

    def __post_init__(self):
        expects(len(self.ladder) >= 2,
                "ladder needs >= 2 rungs, got %s", self.ladder)
        expects(float(self.ladder[0]) == 1.0,
                "ladder rung 0 must be 1.0 (full quality), got %s",
                self.ladder[0])
        expects(all(0.0 < float(f) <= 1.0 for f in self.ladder),
                "ladder fractions must be in (0, 1]: %s", self.ladder)
        expects(all(float(a) > float(b) for a, b in
                    zip(self.ladder, self.ladder[1:])),
                "ladder must be strictly descending: %s", self.ladder)
        expects(0.0 < self.queue_high <= self.queue_full <= 1.0,
                "need 0 < queue_high <= queue_full <= 1, got %s / %s",
                self.queue_high, self.queue_full)
        expects(0.0 < self.latency_quantile <= 1.0,
                "latency_quantile must be in (0, 1], got %s",
                self.latency_quantile)
        expects(self.min_samples >= 1, "min_samples must be >= 1")
        expects(self.min_probes >= 1, "min_probes must be >= 1")

    def probes_at(self, base: int, rung: int) -> int:
        """The ladder's ``n_probes`` for ``rung`` given the configured
        full depth ``base`` (floored at ``min_probes``)."""
        return max(self.min_probes, int(base * float(self.ladder[rung])))

    def quality_at(self, rung: int) -> str:
        if rung <= 0:
            return "full"
        return ("brownout" if rung == len(self.ladder) - 1 else "reduced")


class Ticket:
    """A submitted request's handle. The scheduler completes it from
    :meth:`BatchScheduler.pump`; ``result()`` returns the
    :class:`~raft_tpu_torch.serve.searcher.SearchResult` (or re-raises the
    serving error) once done."""

    __slots__ = ("_result", "_error", "_done", "seq", "span")

    def __init__(self, seq: int):
        self.seq = seq
        self._result: Optional[SearchResult] = None
        self._error: Optional[BaseException] = None
        self._done = False
        # The request's trace root (raft_tpu_torch/obs/trace.py) — NULL_SPAN
        # unless the scheduler was built with a recording tracer; the
        # full tree (queue_wait, batch_assembly, device spans, merge)
        # is finalized when the root lands in ``tracer.take()``.
        self.span = NULL_SPAN

    @property
    def done(self) -> bool:
        return self._done

    def result(self) -> SearchResult:
        expects(self._done, "request %s still queued — pump the scheduler",
                self.seq)
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, result: SearchResult) -> None:
        self._result, self._done = result, True

    def _fail(self, err: BaseException) -> None:
        self._error, self._done = err, True


class _Pending:
    __slots__ = ("queries", "k", "k_bucket", "deadline", "t_submit",
                 "ticket", "span", "qwait", "priority")

    def __init__(self, queries, k, k_bucket, deadline, t_submit, ticket,
                 span=NULL_SPAN, qwait=NULL_SPAN, priority=0):
        self.queries = queries
        self.k = k
        self.k_bucket = k_bucket
        self.deadline = deadline
        self.t_submit = t_submit
        self.ticket = ticket
        self.span = span          # request trace root
        self.qwait = qwait        # open queue_wait child (ends at dispatch)
        self.priority = priority  # shed class: low sheds before high

    @property
    def rows(self) -> int:
        return self.queries.shape[0]


class BatchScheduler:
    """Bounded-queue micro-batcher over one :class:`Searcher`.

    Step-driven core: ``submit()`` enqueues (or answers from cache /
    sheds), ``pump()`` runs one scheduling pass at the injected clock's
    now. A pump loop (``run_until_idle`` for tests and batch jobs, or
    a thread calling ``pump``) owns the cadence; the scheduler itself
    never sleeps and never reads wall time. Queue admission and batch
    selection are mutex-guarded, so request threads may submit while
    one pump thread runs — the ``max_queue`` bound stays exact; the
    searcher call itself runs outside the lock.

    Over a sharded searcher this is the front rank (build it on rank 0;
    the other ranks call :meth:`follow`).
    """

    def __init__(self, searcher: Searcher, grid: BucketGrid,
                 policy: BatchPolicy = BatchPolicy(),
                 cache: Optional[ResultCache] = None,
                 stats: Optional[ServeStats] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tracer: Optional[Tracer] = None,
                 probe=None,
                 degrade: Optional[DegradePolicy] = None):
        mesh = getattr(searcher, "mesh", None)
        from raft_tpu_torch.comms.agree import agreed
        from raft_tpu_torch.comms.comms import Comms

        # A sharded front rank's checks are agreed with the followers'
        # ``follow`` (its first collective), so a refused scheduler raises
        # on every rank instead of leaving them waiting.
        with agreed(None if mesh is None else Comms(mesh)):
            expects(mesh is None or mesh.rank == 0,
                    "a BatchScheduler over a sharded Searcher runs on rank "
                    "0, the front rank; rank %s calls BatchScheduler.follow",
                    None if mesh is None else mesh.rank)
            expects(policy.max_batch <= grid.max_batch,
                    "policy.max_batch=%s exceeds the bucket grid's largest "
                    "query bucket %s — full batches would run out-of-grid "
                    "shapes", policy.max_batch, grid.max_batch)
        self.searcher = searcher
        self.grid = grid
        self.policy = policy
        self.cache = cache
        self.stats = stats if stats is not None else ServeStats()
        # Observability is opt-in and zero-cost when off: the default
        # NULL_TRACER hands out NULL_SPAN (one enabled-check per
        # request). Inject the SAME clock into a recording tracer so span
        # timestamps and latency stats share a timeline.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # The shadow recall probe (obs/recall.py): a None probe is one
        # is-None test per completion.
        self.probe = probe
        self.degrade = degrade
        # The ladder rung the most recent dispatch served at (0 = full
        # quality) — the brownout gauge of a metrics scrape.
        self.brownout_level = 0
        self._clock = clock
        self._queue: List[_Pending] = []
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._unhook = (searcher.add_invalidation_hook(cache.invalidate)
                        if cache is not None else None)
        # The front rank's command channel (sharded searchers): the
        # followers' broadcasts, and one pending Compactor pass.
        self._comms = None if mesh is None else Comms(mesh)
        self._pass = None
        if mesh is not None:
            searcher._front = self

    # -- the front rank's command channel ----------------------------------
    def _command(self, op: int, queries=None, k: int = 0,
                 valid_rows: int = 0, n_probes=None, degraded=None,
                 force: bool = False) -> None:
        """Broadcast one command to the followers (collective with their
        :meth:`follow`); a search command carries its queries."""
        rows, dim = (0, 0) if queries is None else queries.shape
        self._comms.bcast(torch.tensor(
            [op, rows, dim, k, valid_rows,
             -1 if n_probes is None else int(n_probes), _tri(degraded),
             int(force)], dtype=torch.int64))
        if queries is not None:
            self._comms.bcast(torch.as_tensor(queries, dtype=torch.float32))

    def _command_pass(self, compactor, force: bool) -> None:
        """Bring the followers into a Compactor pass (called by
        ``Compactor.run_once`` on rank 0): the command, then its policy."""
        from raft_tpu_torch.comms.agree import root_value

        self._command(_COMPACT, force=force)
        root_value(self._comms, compactor.policy)

    def _command_truth(self, queries, k: int) -> None:
        """Bring the followers into a recall probe's truth search (called
        by ``RecallProbe.run_pending`` on rank 0, from the pump thread)."""
        self._command(_TRUTH, queries, k)

    def _post_pass(self, compactor) -> None:
        """A Compactor daemon's tick (another thread): the next ``pump``
        runs the pass, between batches. One pass pends at most."""
        with self._lock:
            self._pass = compactor

    def _run_posted_pass(self) -> None:
        with self._lock:
            comp, self._pass = self._pass, None
        if comp is None:
            return
        try:
            comp.run_once()
        except Exception:
            # run_once counted the failure; the pass published nothing.
            logger.warning("compaction pass failed; serving continues",
                           exc_info=True)

    @staticmethod
    def follow(searcher: Searcher) -> int:
        """The other ranks' half of a scheduler over a sharded
        ``searcher`` (call on ranks 1..n-1 while rank 0 runs the
        ``BatchScheduler``): receive each command of the front rank and
        make the same call, until the front rank closes. A search that
        raises (the same error on every rank: the searcher agrees its
        failures) is logged and the loop goes on, as the front rank's
        ticket fails. A Compactor pass runs this rank's Compactor on rank
        0's policy (its trigger is rank 0's); a recall probe's truth search
        runs the same search as rank 0's probe. The first collective is the
        front rank's constructor checks: a refused scheduler raises here
        too. Returns the number of batches served."""
        from raft_tpu_torch.comms.agree import raise_agreed, root_value
        from raft_tpu_torch.comms.comms import Comms

        mesh = getattr(searcher, "mesh", None)
        expects(mesh is not None and mesh.rank != 0,
                "follow runs on ranks 1..n-1 of a sharded searcher's mesh")
        comms = Comms(mesh)
        raise_agreed(comms, None)      # the front rank's constructor checks
        served, compactor = 0, None
        while True:
            op, rows, dim, k, valid, n_probes, degraded, force = (
                int(v) for v in comms.bcast(torch.zeros(_HEAD,
                                                        dtype=torch.int64)))
            if op == _STOP:
                return served
            if op == _COMPACT:
                policy = root_value(comms)
                if compactor is None or compactor.policy != policy:
                    from raft_tpu_torch.lifecycle.compact import Compactor

                    compactor = Compactor(searcher, policy)
                try:
                    compactor.run_once(force=bool(force))
                except Exception:
                    logger.warning("compaction pass failed; serving "
                                   "continues", exc_info=True)
                continue
            q = comms.bcast(torch.zeros((rows, dim), dtype=torch.float32))
            if op == _TRUTH:
                from raft_tpu_torch.comms.topk_merge import \
                    merge_dispatch_stats
                from raft_tpu_torch.obs.recall import _truth_search
                from raft_tpu_torch.parallel.routing import routing_stats

                with merge_dispatch_stats.suppress(), \
                        routing_stats.suppress():
                    _truth_search(searcher, q.to(searcher.device), k)
                continue
            try:
                searcher.search(q.to(searcher.device), k,
                                degraded=None if degraded < 0
                                else bool(degraded),
                                valid_rows=valid,
                                n_probes=None if n_probes < 0 else n_probes)
            except Exception as err:
                logger.warning("serve batch %sx%s failed: %r", rows, k, err)
            served += 1

    # -- admission ---------------------------------------------------------
    def submit(self, queries, k: int,
               deadline: Optional[float] = None,
               priority: int = 0) -> Ticket:
        """Enqueue one request; returns its :class:`Ticket`.

        ``deadline`` is an ABSOLUTE time on the scheduler's clock (e.g.
        ``clock() + 0.05`` for a 50 ms budget). Cache hits complete the
        ticket immediately without queueing. Raises :class:`Overloaded`
        when ``max_queue`` requests are already pending; requests larger
        than the query-bucket grid raise at submit (chunk client-side —
        silently splitting would reorder against smaller requests).

        ``priority`` is the request's shed class (higher = more
        important).  A full queue sheds the NEWCOMER when everything
        queued is at least as important; when a strictly
        lower-priority request is queued, that victim is evicted (its
        ticket fails with :class:`Overloaded`, counted as ``shed`` +
        ``priority_evictions``) and the newcomer is admitted — low
        sheds before high.  Uniform priorities shed the newcomer.
        """
        q = np.ascontiguousarray(np.asarray(queries, dtype=np.float32))
        expects(q.ndim == 2, "queries must be (n, dim), got %s", q.shape)
        expects(q.shape[0] >= 1, "empty request")
        expects(q.shape[0] <= self.grid.max_batch,
                "request of %s rows exceeds the bucket grid (max %s): "
                "chunk client-side", q.shape[0], self.grid.max_batch)
        # Dim checked at admission, not dispatch: a bad request co-batched
        # with good ones would otherwise fail the whole batch.
        expects(q.shape[1] == self.searcher.dim,
                "query dim %s != index dim %s", q.shape[1],
                self.searcher.dim)
        expects(k >= 1, "k must be >= 1, got %s", k)
        now = self._clock()
        ticket = Ticket(next(self._seq))
        bucket = self.grid.bucket_for(q.shape[0], k) or (q.shape[0], k)
        # One enabled-check on the admission path: the attr formatting
        # must not run for the default NULL_TRACER (ticket.span is
        # already NULL_SPAN).
        root = NULL_SPAN
        if self.tracer.enabled:
            root = self.tracer.request(
                "serve.request", rows=int(q.shape[0]), k=int(k),
                bucket="%dx%d" % bucket, seq=ticket.seq)
            ticket.span = root

        if self.cache is not None:
            with root.child("cache_lookup"):
                hit = self.cache.get(self.searcher.epoch, q, k,
                                     self._id_dtype())
            if hit is not None:
                self.stats.count(bucket, "requests")
                self.stats.count(bucket, "cache_hits")
                self.stats.observe_latency(bucket, 0.0)
                ticket._complete(hit)
                root.finish(cache="hit")
                return ticket

        kb = self.grid.bucket_k(k)
        qwait = root.child("queue_wait")
        victim: Optional[_Pending] = None
        with self._lock:       # atomic bound check + append: the shed
            pending = len(self._queue)      # point stays exact under
            admitted = pending < self.policy.max_queue  # threaded submits
            if not admitted and self._queue:
                # Priority shed: evict the lowest class first, and
                # within a class the youngest member (least sunk queue
                # wait) — only when the newcomer strictly outranks it.
                cand = min(self._queue,
                           key=lambda r: (r.priority, -r.t_submit,
                                          -r.ticket.seq))
                if cand.priority < priority:
                    victim = cand
                    self._queue.remove(cand)
                    admitted = True
            if admitted:
                self._queue.append(_Pending(
                    q, k, kb if kb is not None else k, deadline, now,
                    ticket, span=root, qwait=qwait, priority=priority))
        if victim is not None:
            vbucket = (self.grid.bucket_for(victim.rows, victim.k)
                       or (victim.rows, victim.k))
            self.stats.count(vbucket, "shed")
            self.stats.count(vbucket, "priority_evictions")
            victim.qwait.finish()
            victim.span.finish(shed=True, evicted_by=ticket.seq)
            victim.ticket._fail(Overloaded(
                "evicted while queued: priority %s request arrived with "
                "the queue full (max_queue=%s)"
                % (priority, self.policy.max_queue)))
        self.stats.count(bucket, "requests")
        if not admitted:
            self.stats.count(bucket, "shed")
            qwait.finish()
            root.finish(shed=True)
            raise Overloaded(
                "queue full (%s pending >= max_queue=%s)"
                % (pending, self.policy.max_queue))
        if kb is None:  # out-of-grid k: served, at its own shape
            self.stats.count(bucket, "out_of_grid")
        self.stats.count(bucket, "queued")
        if self.cache is not None:
            self.stats.count(bucket, "cache_misses")
        return ticket

    def _id_dtype(self):
        """The searcher's id dtype, a part of the cache key (None for a
        searcher without one, such as a test double)."""
        return getattr(self.searcher, "id_dtype", None)

    def pending(self) -> int:
        with self._lock:   # len() is GIL-atomic, but the lock keeps the
            return len(self._queue)   # read ordered against rebuilds

    def now(self) -> float:
        """The scheduler's clock (deadlines are absolute on THIS clock:
        ``sched.submit(q, k, deadline=sched.now() + 0.05)``)."""
        return self._clock()

    # -- scheduling --------------------------------------------------------
    def _ripe(self, group: List[_Pending], now: float) -> bool:
        rows = sum(r.rows for r in group)
        if rows >= self.policy.max_batch:
            return True
        oldest = min(r.t_submit for r in group)
        if now - oldest >= self.policy.max_wait:
            return True
        # Deadline pressure: if waiting out the full window would push a
        # member past its deadline, dispatch now (smaller batch, kept SLO).
        return any(r.deadline is not None
                   and r.deadline <= now + self.policy.max_wait
                   for r in group)

    def pump(self, force: bool = False) -> int:
        """One scheduling pass at ``clock()``'s now: dispatch every ripe
        k-bucket group (``force=True`` dispatches everything queued).
        Returns the number of requests completed. A front rank first runs
        a Compactor pass its daemon posted."""
        if self._comms is not None:
            self._run_posted_pass()
        now = self._clock()
        plan: List[tuple] = []               # (batch, k_bucket, rows)
        with self._lock:                     # select under the lock …
            if not self._queue:
                return 0
            groups: Dict[int, List[_Pending]] = {}
            for r in self._queue:
                groups.setdefault(r.k_bucket, []).append(r)
            # Oldest-first across groups: a ripe group with the oldest
            # request dispatches before younger groups (FIFO fairness).
            for kb in sorted(groups, key=lambda g: min(r.t_submit
                                                       for r in groups[g])):
                group = groups[kb]
                start = 0                    # consumed prefix (FIFO)
                while start < len(group) and (
                        force or self._ripe(group[start:], now)):
                    batch: List[_Pending] = []
                    rows = 0
                    while (start < len(group) and
                           rows + group[start].rows <= self.policy.max_batch):
                        batch.append(group[start])
                        rows += group[start].rows
                        start += 1
                    if not batch:  # head larger than max_batch alone:
                        batch = [group[start]]   # dispatch it solo anyway
                        rows = batch[0].rows
                        start += 1
                    plan.append((batch, kb, rows))
            dispatched = {id(r) for batch, _, _ in plan for r in batch}
            # One O(n) rebuild instead of per-request list.remove.
            self._queue = [r for r in self._queue
                           if id(r) not in dispatched]
        for batch, kb, rows in plan:         # … search outside the lock
            self._dispatch(batch, kb, rows)
        return sum(len(batch) for batch, _, _ in plan)

    def flush(self) -> int:
        """Dispatch everything queued regardless of ripeness (drain on
        shutdown / end of test)."""
        return self.pump(force=True)

    def run_until_idle(self) -> int:
        """Drain the queue completely; returns requests completed."""
        total = 0
        while self.pending():
            total += self.flush()
        return total

    def close(self) -> None:
        """Drain, then detach from the searcher (unregisters the cache
        invalidation hook — a retired scheduler must not keep its cache
        alive through the long-lived Searcher; a front rank stops its
        followers). Idempotent."""
        self.run_until_idle()
        if self._unhook is not None:
            self._unhook()
            self._unhook = None
        if self._comms is not None:
            # The followers leave their loop.
            self._command(_STOP)
            self._comms = None
            self.searcher._front = None

    # -- dispatch ----------------------------------------------------------
    def _pick_rung(self, batch: List[_Pending], bucket) -> tuple:
        """The degradation-ladder decision for one batch: returns
        ``(rung, reason, n_probes)`` — rung 0 / reason None / n_probes
        None means serve at full quality.

        Two pressure signals, worst wins: queue fill (``queue_high``
        forces rung >= 1, ``queue_full`` the deepest rung) and deadline
        budget — the tightest member deadline vs the bucket's observed
        ``latency_quantile`` scaled by each rung's probe fraction
        (latency ~ probes scanned); the shallowest rung that fits
        serves, and when NONE fits the deepest rung serves anyway:
        degrade before drop.
        """
        dp = self.degrade
        base_np = getattr(getattr(self.searcher, "_params", None),
                          "n_probes", None)
        if dp is None or base_np is None:
            return 0, None, None
        rung, reason = 0, None
        fill = self.pending() / self.policy.max_queue
        if fill >= dp.queue_full:
            rung, reason = len(dp.ladder) - 1, "queue_pressure"
        elif fill >= dp.queue_high:
            rung, reason = 1, "queue_pressure"
        budgets = [r.deadline - self._clock() for r in batch
                   if r.deadline is not None]
        if budgets and rung < len(dp.ladder) - 1:
            q_lat = self.stats.latency_quantile(
                bucket, dp.latency_quantile, min_samples=dp.min_samples)
            if q_lat is not None:
                remaining = min(budgets)
                fitted = next(
                    (i for i in range(rung, len(dp.ladder))
                     if q_lat * float(dp.ladder[i]) <= remaining),
                    len(dp.ladder) - 1)   # nothing fits: deepest, not drop
                if fitted > rung:
                    rung, reason = fitted, "deadline_budget"
        if rung == 0:
            return 0, None, None
        n_probes = dp.probes_at(int(base_np), rung)
        if n_probes >= int(base_np):   # min_probes floor made the shrink
            return 0, None, None       # a no-op: serve full, don't relabel
        return rung, reason, n_probes

    def _dispatch(self, batch: List[_Pending], kb: int, rows: int) -> None:
        qb = self.grid.bucket_queries(rows) or rows
        bucket = (qb, kb)
        rung, reason, n_probes = self._pick_rung(batch, bucket)
        self.brownout_level = rung
        # One measurement per batch, attached to every member request's
        # tree below (child_at): queue_wait ends here, then assembly,
        # the searcher's fenced device spans, and result merge.
        rec = self.tracer.enabled
        bspan = NULL_SPAN
        if rec:
            for r in batch:
                r.qwait.finish()
            t_asm0 = self.tracer.now()
            bspan = self.tracer.request(
                "serve.batch", bucket="%dx%d" % bucket,
                requests=len(batch), rows=rows, padded=qb - rows)
        big = np.concatenate([r.queries for r in batch], axis=0)
        padded = pad_queries(big, qb)
        if rec:
            t_asm1 = self.tracer.now()
        # Epoch captured BEFORE the search: an extend landing mid-search
        # bumps it, and caching the pre-extend result under the new
        # epoch would be a permanently-stale hit. Under the captured
        # (old) epoch the entry is unreachable by construction.
        epoch = self.searcher.epoch
        id_dtype = self._id_dtype()
        try:
            # valid_rows: routed (placement="list") searchers must not
            # route / meter the bucket's zero-pad rows as traffic.
            # n_probes: the ladder's rung (None = full depth) — a value
            # from the closed, pre-warmed set (DegradePolicy docstring).
            if self._comms is not None:
                self._command(_SEARCH, padded, kb, rows, n_probes)
            res = self.searcher.search(padded, kb, span=bspan,
                                       valid_rows=rows, n_probes=n_probes)
        except Exception as err:   # complete, never wedge the queue
            now = self._clock()
            for r in batch:
                r.ticket._fail(err)
                rbucket = (self.grid.bucket_for(r.rows, r.k)
                           or (r.rows, r.k))
                # Failures must show on the scrape surface, not only in
                # a log line — an outage with healthy-looking stats is
                # the worst observability failure mode.
                self.stats.count(rbucket, "failed")
                if r.deadline is not None and now > r.deadline:
                    self.stats.count(rbucket, "deadline_misses")
                r.span.finish(error=repr(err))
            bspan.finish(error=repr(err))
            logger.warning("serve batch %sx%s failed: %r", qb, kb, err)
            return
        now = self._clock()
        # Batch-shape counters key on the DISPATCHED bucket; per-request
        # counters below key on each request's own bucket, matching its
        # submit-side rows (ServeStats docstring).
        self.stats.count(bucket, "batches")
        self.stats.count(bucket, "batched_requests", len(batch))
        self.stats.count(bucket, "batched_rows", rows)
        self.stats.count(bucket, "padded_slots", qb - rows)
        if rung > 0:
            self.stats.count(bucket, "probes_shrunk")
        quality = (self.degrade.quality_at(rung) if self.degrade is not None
                   else "full")
        if rec:
            t_merge0 = self.tracer.now()
        row = 0
        for r in batch:
            sl = slice(row, row + r.rows)
            # Copies, not views (ascontiguousarray would pass a
            # contiguous slice through): a view pins the WHOLE padded
            # batch buffer for as long as the cache or caller holds the
            # result — up to (q_bucket·k_bucket)/(rows·k) amplification.
            out = SearchResult(res.distances[sl, :r.k].copy(),
                               res.indices[sl, :r.k].copy(),
                               res.coverage[sl].copy(),
                               degraded=res.degraded,
                               hedged=res.hedged,
                               quality=quality,
                               degrade_reason=reason)
            row += r.rows
            if self.cache is not None and not res.degraded and rung == 0:
                # Degraded (partial-coverage) and reduced-probe answers
                # are never cached: a hit after the shard recovers / the
                # pressure lifts would replay the hole or the quality
                # loss at full health.
                self.cache.put(epoch, r.queries, r.k, out, id_dtype)
            rbucket = (self.grid.bucket_for(r.rows, r.k)
                       or (r.rows, r.k))
            if res.degraded:
                self.stats.count(rbucket, "degraded_responses")
            self.stats.count(rbucket, "served_%s" % quality)
            if r.deadline is not None and now > r.deadline:
                self.stats.count(rbucket, "deadline_misses")
            self.stats.observe_latency(rbucket, now - r.t_submit)
            if self.probe is not None and not res.degraded:
                # Shadow recall sampling (obs/recall.py): enqueue only;
                # the exact scan runs off the hot path in
                # probe.run_pending(). Coverage-degraded answers are
                # skipped (partial coverage would read as recall loss);
                # reduced-probe answers are offered: their recall is the
                # served-quality feedback the ladder wants.
                self.probe.offer(r.queries, r.k, out.indices, rbucket,
                                 epoch)
            r.ticket._complete(out)
        if rec:
            t_merge1 = self.tracer.now()
            # The batch's device spans (measured once by the searcher)
            # copy into every member's tree: a complete per-request
            # timeline without per-request fencing.
            device = [c for c in bspan.children
                      if c.name in ("device_dispatch", "device_get")]
            for r in batch:
                r.span.child_at("batch_assembly", t_asm0, t_asm1,
                                bucket="%dx%d" % bucket,
                                requests=len(batch))
                for c in device:
                    r.span.child_at(c.name, c.start, c.end, **c.attrs)
                r.span.child_at("result_merge", t_merge0, t_merge1)
                r.span.finish(degraded=res.degraded)
            bspan.finish()
        logger.trace("serve batch %sx%s: %s requests, %s rows, %s padded",
                     qb, kb, len(batch), rows, qb - rows)
