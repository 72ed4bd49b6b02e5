"""A gloo world of CPU ranks for the sharded parity tests (no tests here).

:class:`World` spawns ``size`` processes that join one ``torch.distributed``
gloo group (a ``file://`` store) and then serve tasks: ``world.run(fn,
*args)`` calls ``fn(*args)`` on every rank and returns the ranks' results
in rank order, so many cases go through one world. The rank-side case
functions live here too: this module imports neither jax nor raft_tpu, so
the ranks never load the reference. Inside a case, :func:`sub_mesh`
gives the mesh of ranks ``[0, n)`` (None on the other ranks), which lets
one world of 4 run the 1-, 2-, 3- and 4-rank cases.
"""

import dataclasses
import multiprocessing as mp
import queue
import traceback

import numpy as np
import torch

_GROUPS = {}


class World:
    """``size`` gloo ranks on the CPU, serving tasks until :meth:`close`."""

    def __init__(self, size: int, store_dir, timeout: float = 120.0):
        ctx = mp.get_context("spawn")
        sub_sizes = tuple(range(1, size + 1))
        self.size = size
        self.timeout = timeout
        self._tasks = [ctx.Queue() for _ in range(size)]
        self._results = ctx.Queue()
        init = f"file://{store_dir}/gloo_store"
        self._procs = [ctx.Process(target=_serve, daemon=True,
                                   args=(r, size, init, sub_sizes,
                                         self._tasks[r], self._results))
                       for r in range(size)]
        for p in self._procs:
            p.start()
        self.broken = False

    def run(self, fn, *args) -> list:
        """``fn(*args)`` on every rank; the results in rank order. A rank
        that raises fails the call with its traceback; a world that stops
        answering is closed and fails every later call."""
        assert not self.broken, "the world stopped answering earlier"
        for q in self._tasks:
            q.put((fn, args))
        out, errors = [None] * self.size, []
        try:
            for _ in range(self.size):
                rank, ok, val = self._results.get(timeout=self.timeout)
                if ok:
                    out[rank] = val
                else:
                    errors.append(f"rank {rank}:\n{val}")
        except queue.Empty:
            self.broken = True
            self.close()
            raise AssertionError("the world stopped answering "
                                 f"({len(errors)} errors: {errors})")
        if errors:
            raise AssertionError("\n".join(errors))
        return out

    def close(self) -> None:
        for q in self._tasks:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)


def _serve(rank, size, init, sub_sizes, tasks, results) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    # Every rank creates every group once, in the same order.
    for n in sub_sizes:
        _GROUPS[n] = dist.new_group(ranks=list(range(n)))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, True, fn(*args)))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


def sub_mesh(n: int):
    """The CPU mesh of ranks [0, n), or None on a rank outside it."""
    import torch.distributed as dist

    from raft_tpu_torch.comms.comms import make_mesh

    if dist.get_rank() >= n:
        return None
    return make_mesh(_GROUPS[n], device="cpu")


def np_out(out):
    """Tensors (or tuples of them) as numpy, for the trip home."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if isinstance(out, (tuple, list)):
        return type(out)(np_out(o) for o in out)
    return out


# ---------------------------------------------------------------------------
# Rank-side cases. Each takes the sub-world size first and returns numpy
# (or None on a rank outside the sub-world).


def case_comms_test(n: int, name: str, *args):
    """One function of ``comms_test`` on a mesh of n ranks."""
    from raft_tpu_torch.comms import comms_test

    mesh = sub_mesh(n)
    return None if mesh is None else getattr(comms_test, name)(mesh, *args)


def case_comms_bf16_shift(n: int):
    """A bf16 / bool / int64 payload round the ring, bit for bit."""
    from raft_tpu_torch.comms.comms import Comms

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    comms = Comms(mesh)
    r = comms.get_rank()
    x = (torch.arange(6, dtype=torch.float32) / 7 + r).to(torch.bfloat16)
    b = torch.tensor([r % 2 == 0, True])
    i = torch.tensor([2 ** 40 + r])
    got = comms.exchange((x, b, i), (r + 1) % n, (r - 1) % n)
    return np_out((got[0].view(torch.int16), got[1], got[2]))


def case_topk_merge(n: int, dist, idx, k: int, select_min: bool, engines):
    """Rank r merges row r of the (n, q, kk) candidates with each engine:
    {engine: (distances, ids)}."""
    from raft_tpu_torch.comms.comms import Comms
    from raft_tpu_torch.comms.topk_merge import topk_merge

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    r = mesh.rank
    return {e: np_out(topk_merge(torch.as_tensor(dist[r]),
                                 torch.as_tensor(idx[r]), k, Comms(mesh),
                                 select_min=select_min, engine=e))
            for e in engines}


def case_topk_merge_pipelined(n: int, dist, idx, k: int, select_min: bool,
                              n_chunks: int, quantized: bool):
    """The pipelined merge with chunk c = a column range of rank r's
    candidates (disjoint chunks)."""
    import importlib

    from raft_tpu_torch.comms.comms import Comms

    tm = importlib.import_module("raft_tpu_torch.comms.topk_merge")
    mesh = sub_mesh(n)
    if mesh is None:
        return None
    r = mesh.rank
    bounds = tm.pipeline_chunk_bounds(dist.shape[2], n_chunks)
    d, i = torch.as_tensor(dist[r]), torch.as_tensor(idx[r])

    def scan_chunk(c):
        lo, hi = bounds[c]
        return tm._select_by_id(d[:, lo:hi], i[:, lo:hi], hi - lo,
                                select_min)

    out = tm.topk_merge_pipelined(scan_chunk, len(bounds), k, Comms(mesh),
                                  select_min=select_min, quantized=quantized)
    return np_out(out)


def case_sharded_knn(n: int, db, q, k: int, engine: str, live,
                     chunks: int = 0, sqrt: bool = False):
    from raft_tpu_torch.parallel import sharded_knn

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    return np_out(sharded_knn(mesh, db, q, k, sqrt=sqrt, merge_engine=engine,
                              live_mask=live, pipeline_chunks=chunks))


def case_kmeans(n: int, what: str, X, centroids, n_iters: int):
    from raft_tpu_torch import parallel

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    if what == "step":
        return np_out(parallel.sharded_kmeans_step(mesh, X, centroids))
    if what == "fit":
        return np_out(parallel.sharded_kmeans_fit(mesh, X, centroids,
                                                  n_iters=n_iters))
    return np_out(parallel.sharded_kmeans_balanced_fit(
        mesh, X, centroids, n_iters=n_iters))


def _flat_build(mesh, X, n_lists: int, centers, idx_dtype=torch.int32,
                train_distributed: bool = False, kmeans_n_iters: int = 20,
                placement: str = "row"):
    from raft_tpu_torch import parallel
    from raft_tpu_torch.neighbors import ivf_flat

    params = ivf_flat.IndexParams(n_lists=n_lists, idx_dtype=idx_dtype,
                                  kmeans_n_iters=kmeans_n_iters)
    return parallel.sharded_ivf_flat_build(
        mesh, params, X, centers=None if centers is None
        else torch.as_tensor(centers), train_distributed=train_distributed,
        placement=placement)


def _pq_build(mesh, X, model, placement: str):
    """A sharded IVF-PQ over the model arrays ``model`` (the keyword
    arguments of ``ivf_pq.index_from_numpy``)."""
    from raft_tpu_torch import parallel
    from raft_tpu_torch.neighbors import ivf_pq

    m = ivf_pq.index_from_numpy(**model, device="cpu")
    params = ivf_pq.IndexParams(n_lists=m.n_lists, pq_dim=m.pq_dim,
                                pq_bits=m.pq_bits)
    return parallel.sharded_ivf_pq_build(mesh, params, X, model=m,
                                         placement=placement)


def _sharded_index(mesh, kind: str, X, model, n_lists: int, placement: str):
    """kind "flat" (``model`` = the centers) or "pq" (the model arrays)."""
    if kind == "flat":
        return _flat_build(mesh, X, n_lists, model, placement=placement)
    return _pq_build(mesh, X, model, placement)


def _search_params(kind: str, engine: str, n_probes: int):
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    mod = ivf_flat if kind == "flat" else ivf_pq
    return mod.SearchParams(n_probes=n_probes, engine=engine)


def _placement_arrays(index):
    pm = index.placement_map
    return (pm.owner, pm.slot, pm.replica_owner, pm.replica_slot,
            pm.n_slots)


def case_sharded_steps(n: int, kind: str, X, model, Q, k: int, steps,
                       n_lists: int = 8, placement: str = "list"):
    """Build a sharded IVF-Flat ("flat") or IVF-PQ ("pq") index, then run
    ``steps`` in order:

    * ("search", engine, n_probes, merge_engine, live, chunks[, valid]);
    * ("suspect", n_probes, masks): every rank passes ITS OWN suspect
      mask ``masks[rank]``; the answer and the plan every rank followed;
    * ("extend", rows, ids), ("delete", ids), ("upsert", rows, ids);
    * ("replicate", list_ids, live), ("migrate", new_owner, live) (the
      successor replaces the index; migrate reports its count);
    * ("placement",), ("stats",) (routing and merge telemetry, reset
      before the build and by ("reset",)), ("warmup", n_queries, n_probes);
    * ("compact", policy keywords, live): a compaction pass (its report
      as a tuple, or None), the successor replaces the index;
    * ("save", basename) (the manifest's epoch), ("load", basename) (the
      loaded index replaces the index; its placement arrays or None).

    Each step appends its output and the index's (size, n_deleted,
    epoch)."""
    from raft_tpu_torch import lifecycle, parallel
    from raft_tpu_torch.comms.topk_merge import merge_dispatch_stats
    from raft_tpu_torch.parallel.routing import routing_stats

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    routing_stats.reset()
    merge_dispatch_stats.reset()
    index = _sharded_index(mesh, kind, X, model, n_lists, placement)
    search = (parallel.sharded_ivf_flat_search if kind == "flat"
              else parallel.sharded_ivf_pq_search)
    extend = (parallel.sharded_ivf_flat_extend if kind == "flat"
              else parallel.sharded_ivf_pq_extend)
    outs = []
    for step in steps:
        op = step[0]
        if op == "search":
            _, engine, n_probes, merge_engine, live, chunks = step[:6]
            valid = step[6] if len(step) > 6 else None
            outs.append(np_out(search(
                mesh, _search_params(kind, engine, n_probes), index, Q, k,
                merge_engine=merge_engine, live_mask=live,
                pipeline_chunks=chunks, valid_rows=valid)))
        elif op == "suspect":
            plans = []
            out = search(mesh, _search_params(kind, "auto", step[1]), index,
                         Q, k, merge_engine="allgather",
                         suspect_mask=np.asarray(step[2][mesh.rank]),
                         plan_cb=plans.append)
            outs.append((np_out(out), plans[0].q_rows,
                         plans[0].probe_slots, plans[0].suspect_avoided))
        elif op == "extend":
            extend(mesh, index, step[1], step[2])
            outs.append(index.indices.shape[1])
        elif op == "delete":
            outs.append(lifecycle.delete(index, step[1], mesh=mesh))
        elif op == "upsert":
            lifecycle.upsert(index, step[1], step[2], mesh=mesh)
            outs.append(index.indices.shape[1])
        elif op == "replicate":
            index = parallel.sharded_replicate_lists(mesh, index, step[1],
                                                     live_mask=step[2])
            outs.append(_placement_arrays(index))
        elif op == "migrate":
            index, moved = parallel.sharded_migrate_lists(
                mesh, index, step[1], live_mask=step[2])
            outs.append(moved)
        elif op == "placement":
            outs.append(_placement_arrays(index))
        elif op == "reset":
            routing_stats.reset()
            merge_dispatch_stats.reset()
            outs.append(None)
        elif op == "stats":
            snap = routing_stats.snapshot()
            outs.append((snap, merge_dispatch_stats.snapshot(),
                         routing_stats.list_loads(index.placement_map)))
        elif op == "compact":
            index, report = lifecycle.compact(
                index, lifecycle.CompactionPolicy(**step[1]), mesh=mesh,
                live_mask=step[2])
            outs.append(None if report is None
                        else dataclasses.astuple(report))
        elif op == "save":
            parallel.sharded_ivf_save(mesh, step[1], index)
            outs.append(parallel.verify_sharded_manifest(step[1]))
        elif op == "load":
            index = parallel.sharded_ivf_load(mesh, step[1])
            outs.append(None if index.placement_map is None
                        else _placement_arrays(index))
        else:
            outs.append(parallel.sharded_routed_warmup(
                mesh, _search_params(kind, "auto", step[2]), index, step[1],
                k))
        outs.append((index.size, index.n_deleted, index.epoch))
    return outs


def case_routed_searcher(n: int, kind: str, X, model, Q, k: int, dead,
                         suspect, steps, n_probes: int = 3,
                         placement: str = "list"):
    """A sharded Searcher over a sharded index, with a ShardHealth
    whose ``dead`` / ``suspect`` ranks are marked on rank 0 only, and a
    dispatch hook that records each dispatch's participating ranks. Runs
    ``steps`` like :func:`case_searcher` (plus ("replicate", list_ids)
    through the index); returns the outputs, the epochs and the hook's
    records."""
    from raft_tpu_torch import parallel
    from raft_tpu_torch.comms.health import ShardHealth
    from raft_tpu_torch.serve import BucketGrid, Searcher, warmup

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    health = ShardHealth(n)
    if mesh.rank == 0:
        for r in dead:
            health.mark_dead(r)
        for r in suspect:
            health.mark_suspect(r)
    seen = []
    index = _sharded_index(mesh, kind, X, model, 8, placement)
    make = Searcher.ivf_flat if kind == "flat" else Searcher.ivf_pq
    s = make(index, _search_params(kind, "auto", n_probes), mesh=mesh,
             health=health, dispatch_hook=lambda r: seen.append(list(r)))
    outs = []
    for step in steps:
        if step[0] == "search":
            res = s.search(Q, k, degraded=step[1])
            outs.append((res.distances, res.indices, res.coverage,
                         res.degraded))
        elif step[0] == "extend":
            s.extend(step[1])
        elif step[0] == "delete":
            outs.append(s.delete(step[1]))
        elif step[0] == "warmup":
            rep = warmup(s, BucketGrid.pow2(step[1], k_grid=(k,)))
            outs.append([rep["shapes"], rep["routed_shapes"]])
        elif step[0] == "replicate":
            s._index = parallel.sharded_replicate_lists(mesh, s._index,
                                                        step[1])
        else:
            s.upsert(step[1], step[2])
        outs.append(s.epoch)
    lat = [bool(np.isfinite(health.latency_ewma(r))) for r in range(n)]
    return outs, seen, lat


def case_ivf_flat(n: int, X, centers, Q, k: int, steps, n_lists: int = 16,
                  idx_dtype=torch.int32):
    """Build, then run ``steps`` in order; each is ("search", engine,
    n_probes, merge_engine, live, chunks), ("extend", rows, ids) or
    ("delete", ids). Returns every search's output and, per step, the
    index's (size, n_deleted, epoch)."""
    from raft_tpu_torch import lifecycle, parallel
    from raft_tpu_torch.neighbors import ivf_flat

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    index = _flat_build(mesh, X, n_lists, centers, idx_dtype)
    outs = []
    for step in steps:
        if step[0] == "search":
            _, engine, n_probes, merge_engine, live, chunks = step
            out = parallel.sharded_ivf_flat_search(
                mesh, ivf_flat.SearchParams(n_probes=n_probes,
                                            engine=engine),
                index, Q, k, merge_engine=merge_engine, live_mask=live,
                pipeline_chunks=chunks)
            outs.append(np_out(out))
        elif step[0] == "extend":
            parallel.sharded_ivf_flat_extend(mesh, index, step[1], step[2])
            outs.append(index.indices.shape[1])
        else:
            outs.append(lifecycle.delete(index, step[1], mesh=mesh))
        outs.append((index.size, index.n_deleted, index.epoch))
    return outs


def case_ivf_train_distributed(n: int, X, Q, k: int, n_lists: int,
                               n_probes: int, n_iters: int):
    """A train_distributed build: its centers and one search."""
    from raft_tpu_torch import parallel
    from raft_tpu_torch.neighbors import ivf_flat

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    index = _flat_build(mesh, X, n_lists, None, train_distributed=True,
                        kmeans_n_iters=n_iters)
    out = parallel.sharded_ivf_flat_search(
        mesh, ivf_flat.SearchParams(n_probes=n_probes), index, Q, k)
    return np_out((index.centers,) + tuple(out))


def case_ivf_trained_on_rank0(n: int, X, n_lists: int, n_iters: int):
    """A build that trains its centers on rank 0: its centers, and those
    ``ivf_flat`` trains on one device."""
    from raft_tpu_torch.neighbors import ivf_flat

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    params = ivf_flat.IndexParams(n_lists=n_lists, kmeans_n_iters=n_iters)
    return np_out((_flat_build(mesh, X, n_lists, None,
                               kmeans_n_iters=n_iters).centers,
                   ivf_flat._train_centers(params, torch.as_tensor(X))))


def case_searcher(n: int, kind: str, X, centers, Q, k: int, dead, steps,
                  n_probes: int = 4):
    """A sharded Searcher (brute force or IVF-Flat) with a ShardHealth
    whose ``dead`` ranks are marked dead on rank 0 only (the mask is
    rank 0's). Runs ``steps``: ("search", degraded), ("extend", rows),
    ("delete", ids), ("upsert", rows, ids), ("warmup", max_batch) with
    the degraded searches. Returns each search's (distances, ids,
    coverage, degraded), each warmup's (shapes, degraded) and the
    epochs."""
    from raft_tpu_torch.comms.health import ShardHealth
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import BucketGrid, Searcher, warmup

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    health = ShardHealth(n)
    if mesh.rank == 0:
        for r in dead:
            health.mark_dead(r)
    if kind == "brute_force":
        s = Searcher.brute_force(X, mesh=mesh, health=health)
    else:
        s = Searcher.ivf_flat(_flat_build(mesh, X, 16, centers),
                              ivf_flat.SearchParams(n_probes=n_probes),
                              mesh=mesh, health=health)
    outs = []
    for step in steps:
        if step[0] == "search":
            res = s.search(Q, k, degraded=step[1])
            outs.append((res.distances, res.indices, res.coverage,
                         res.degraded))
        elif step[0] == "extend":
            s.extend(step[1])
        elif step[0] == "delete":
            outs.append(s.delete(step[1]))
        elif step[0] == "warmup":
            rep = warmup(s, BucketGrid.pow2(step[1], k_grid=(k,)),
                         include_degraded=True)
            outs.append([rep["shapes"], rep["degraded"]])
        else:
            s.upsert(step[1], step[2])
        outs.append(s.epoch)
    return outs


def case_refusals(n: int, base: str):
    """Every arm that waited for the sharding slice's third part (ROADMAP
    A.4c), driven once on a sharded mesh: the LogicError each raises, or
    None (none should raise now)."""
    from raft_tpu_torch import lifecycle, parallel, serve
    from raft_tpu_torch.comms.health import ShardHealth
    from raft_tpu_torch.core.error import LogicError
    from raft_tpu_torch.core.retry import RetryPolicy
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve.recovery import RecoveryProber

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    X = np.arange(64 * 4, dtype=np.float32).reshape(64, 4) % 7
    index = _flat_build(mesh, X, 4, X[:4])
    bf = serve.Searcher.brute_force(X, mesh=mesh, health=ShardHealth(n))

    def schedule():
        if mesh.rank:
            serve.BatchScheduler.follow(bf)
            return
        sched = serve.BatchScheduler(bf, serve.BucketGrid.pow2(4),
                                     serve.BatchPolicy(max_batch=4))
        sched.submit(X[:2], 3)
        sched.close()

    msgs = []
    for fn in (
            lambda: parallel.sharded_ivf_save(mesh, base, index),
            lambda: parallel.sharded_ivf_load(mesh, base),
            lambda: parallel.verify_sharded_manifest(base),
            lambda: lifecycle.CompactionPolicy(balance_placement=1.5),
            lambda: RecoveryProber(bf, bf.health, X[:2]).step(),
            lambda: serve.Searcher.ivf_flat(
                index, ivf_flat.SearchParams(), mesh=mesh,
                health=ShardHealth(n), hedge=serve.HedgePolicy()),
            lambda: serve.Searcher.brute_force(
                X, mesh=mesh, retry=RetryPolicy()).search(X[:2], 3),
            lambda: bf.shadow_probe(0, X[:2], 3),
            schedule,
            lambda: lifecycle.compact(index, mesh=mesh)):
        try:
            fn()
            msgs.append(None)
        except LogicError as e:
            msgs.append(str(e))
    return msgs


# ---------------------------------------------------------------------------
# The operations layer (ROADMAP A.4c): snapshots, compaction, agreed retry,
# hedging, recovery, the scheduler's front rank.


class InjectedFault(OSError):
    """A scripted transient fault (an OSError, so it retries)."""


class FakeClock:
    """An injected clock whose sleeps advance it (and are recorded)."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def __call__(self):
        return self.now

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s

    def advance(self, dt):
        self.now += dt


class StragglerHook:
    """A dispatch hook: every dispatch costs ``service`` on the clock, and
    a scripted delay ``(victim, seconds, at)`` adds ``seconds`` to the
    calls (indexes in ``at``; None = every call) whose participants
    include ``victim``."""

    def __init__(self, clock, service):
        self.clock, self.service = clock, service
        self.calls = 0
        self.fault = None

    def __call__(self, ranks):
        self.clock.sleep(self.service)
        idx, self.calls = self.calls, self.calls + 1
        if self.fault is not None:
            victim, seconds, at = self.fault
            if (at is None or idx in at) and victim in {
                    int(r) for r in np.asarray(ranks).reshape(-1)}:
                self.clock.sleep(seconds)


class TornWrite:
    """``FileIO.write_bytes`` that writes the first ``offset`` bytes of
    its ``at``-th call's payload and raises (a power loss mid-write);
    with ``offset`` None that call raises before writing."""

    def __init__(self, at: int, offset=None):
        self.at, self.offset, self.calls = at, offset, 0

    def __call__(self, f, data):
        idx, self.calls = self.calls, self.calls + 1
        if idx == self.at:
            if self.offset is not None:
                f.write(bytes(data)[:self.offset])
                f.flush()
            raise InjectedFault(f"torn write at call {idx}")
        f.write(data)


def _error(fn):
    """``(type name, text)`` of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:       # noqa: BLE001 - the outcome is the case
        return type(e).__name__, str(e)
    return None


def case_snapshot_faults(n: int, base: str, fault: str):
    """A row-placed IVF-Flat saved at ``base`` on ranks [0, n), then one
    fault and a load: "version" (model version 42), "shards" (a load
    onto ranks [0, 2)), "missing" (shard 3 removed, manifest kept),
    "missing_legacy" (and the manifest removed), "dtype" (shard 2's ids
    re-saved as int64, manifest removed), "size" / "crc" (shard 2 grown
    by a byte / a byte flipped), "torn" (rank 2's writes torn at byte 64
    on a fresh base), "rename" (rank 3's rename dropped), "retry" (rank
    1's first write fails, ``retry=`` rides it out). Returns each rank's
    (type, text) of the error, or for "retry" the loaded index's size."""
    import os

    import torch.distributed as dist

    from raft_tpu_torch import parallel
    from raft_tpu_torch.comms.comms import Comms
    from raft_tpu_torch.core.retry import RetryPolicy
    from raft_tpu_torch.util.atomic_io import FileIO

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    X = np.arange(256 * 8, dtype=np.float32).reshape(256, 8) % 13
    index = _flat_build(mesh, X, 8, X[::32][:8])
    rank = mesh.rank
    if fault in ("torn", "rename", "retry"):
        io = FileIO()
        if fault == "torn" and rank == 2:
            io = FileIO(write_bytes=TornWrite(0, offset=64))
        elif fault == "rename" and rank == 3:
            def drop(src, dst):
                raise InjectedFault("rename dropped")
            io = FileIO(replace=drop)
        elif fault == "retry" and rank == 1:
            io = FileIO(write_bytes=TornWrite(0))
        retry = (RetryPolicy(max_attempts=3, base_delay=0.0)
                 if fault == "retry" else None)
        err = _error(lambda: parallel.sharded_ivf_save(
            mesh, base, index, retry=retry, file_io=io))
        if fault == "retry":
            assert err is None, err
            return parallel.sharded_ivf_load(mesh, base).size
        Comms(mesh).barrier()
        left = sorted(os.path.basename(f) for f in os.listdir(
            os.path.dirname(base)))
        return err, left, _error(lambda: parallel.sharded_ivf_load(mesh,
                                                                   base))
    parallel.sharded_ivf_save(mesh, base, index)
    if rank == 0:
        if fault == "version":
            with np.load(f"{base}.model.npz") as z:
                payload = {k: z[k] for k in z.files}
            payload["version"] = np.int64(42)
            np.savez(f"{base}.model.npz", **payload)
            os.remove(f"{base}.manifest.npz")
        elif fault.startswith("missing"):
            os.remove(f"{base}.shard3.npz")
            if fault == "missing_legacy":
                os.remove(f"{base}.manifest.npz")
        elif fault == "dtype":
            with np.load(f"{base}.shard2.npz") as z:
                payload = {k: z[k] for k in z.files}
            payload["indices"] = payload["indices"].astype(np.int64)
            np.savez(f"{base}.shard2.npz", **payload)
            os.remove(f"{base}.manifest.npz")
        elif fault in ("size", "crc"):
            path = f"{base}.shard2.npz"
            raw = bytearray(open(path, "rb").read())
            if fault == "size":
                raw += b"\x00"
            else:
                raw[len(raw) // 2] ^= 0xFF
            open(path, "wb").write(bytes(raw))
    Comms(mesh).barrier()
    if fault == "shards":
        m2 = sub_mesh(2) if rank < 2 else None
        if m2 is None:
            dist.barrier(group=mesh.group)
            return None
        err = _error(lambda: parallel.sharded_ivf_load(m2, base))
        dist.barrier(group=mesh.group)
        return err
    return _error(lambda: parallel.sharded_ivf_load(mesh, base))


def _list_index(mesh, X, centers, k_owner=None, replicate=()):
    """A list-placed IVF-Flat on ``centers`` (8 lists), its lists moved to
    ``k_owner`` (an owner array) and ``replicate`` lists replicated."""
    from raft_tpu_torch import parallel

    index = _flat_build(mesh, X, len(centers), centers, placement="list")
    if k_owner is not None:
        index, _ = parallel.sharded_migrate_lists(mesh, index, k_owner)
    if len(replicate):
        index = parallel.sharded_replicate_lists(mesh, index, replicate)
    return index


def case_compactor(n: int, X, centers, Q, k: int, del_ids):
    """The Compactor over a sharded routed Searcher: every list on rank 0,
    one search of traffic, a balance-only policy fires from its own
    trigger (report, and None on the next tick: edge-armed); then
    ``del_ids`` deleted and a pass whose ``pre_publish`` fails on rank 2
    only (every rank raises, no rank publishes), then a clean pass.
    Returns the reports, the errors, epochs and the searches."""
    from raft_tpu_torch import lifecycle
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.parallel.routing import routing_stats
    from raft_tpu_torch.serve import Searcher

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    index = _list_index(mesh, X, centers, np.zeros(len(centers), np.int64))
    s = Searcher.ivf_flat(index, ivf_flat.SearchParams(n_probes=3),
                          mesh=mesh)
    routing_stats.reset()
    before = s.search(Q, k)
    comp = lifecycle.Compactor(s, lifecycle.CompactionPolicy(
        balance_placement=1.5))
    rep = comp.run_once()
    again = comp.run_once()
    after = s.search(Q, k)
    owners = s._index.placement_map.owner
    n_del = s.delete(del_ids)

    def boom():
        if mesh.rank == 2:
            raise InjectedFault("pre_publish fault")

    epoch = s.epoch
    faulted = _error(lambda: s.compact(lifecycle.CompactionPolicy(
        shrink_capacity=True), pre_publish=boom))
    kept = s.epoch == epoch and s._index.n_deleted == len(del_ids)
    rep2 = s.compact(lifecycle.CompactionPolicy(shrink_capacity=True))
    compacted = s.search(Q, k)
    return (dataclasses.astuple(rep), again, comp.last_should_run, owners,
            (before.distances, before.indices),
            (after.distances, after.indices), n_del, faulted, kept,
            dataclasses.astuple(rep2),
            (compacted.distances, compacted.indices), s.epoch)


def case_retry(n: int, X, Q, k: int, fails: int, attempts: int):
    """A sharded brute-force Searcher with ``RetryPolicy(attempts)``
    whose rank 2 loses its result ``fails`` times (its dispatch runs, then
    raises). Returns the answer or the error, and every rank's sleeps."""
    from raft_tpu_torch.core.retry import RetryPolicy
    from raft_tpu_torch.serve import Searcher

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    clock = FakeClock()
    s = Searcher.brute_force(X, mesh=mesh, retry=RetryPolicy(
        max_attempts=attempts, base_delay=0.01), sleep=clock.sleep,
        monotonic=clock.monotonic)
    left = {"n": fails if mesh.rank == 2 else 0}
    real = s._dispatch

    def flaky(*a, **kw):
        out = real(*a, **kw)
        if left["n"]:
            left["n"] -= 1
            raise InjectedFault("result lost")
        return out

    s._dispatch = flaky
    try:
        res = s.search(Q, k)
        return (res.distances, res.indices), clock.sleeps
    except Exception as e:       # noqa: BLE001 - the outcome is the case
        return (type(e).__name__, str(e)), clock.sleeps


def _straggler_searcher(mesh, X, centers, victim, service, hedged):
    from raft_tpu_torch import parallel
    from raft_tpu_torch.comms.health import LatencyPolicy, ShardHealth
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import HedgePolicy, Searcher

    base = _list_index(mesh, X, centers)
    pm = base.placement_map
    index = parallel.sharded_replicate_lists(
        mesh, base, np.flatnonzero(pm.owner == victim))
    clock = FakeClock()
    hook = StragglerHook(clock, service)
    kw = dict(mesh=mesh, dispatch_hook=hook, monotonic=clock.monotonic)
    health = None
    if hedged:
        health = ShardHealth(mesh.size, latency=LatencyPolicy(
            alpha=0.25, window=8, quantile=0.9, multiplier=3.0,
            min_samples=4))
        kw.update(health=health, hedge=HedgePolicy(
            quantile=0.9, multiplier=2.0, min_samples=4))
    s = Searcher.ivf_flat(index, ivf_flat.SearchParams(n_probes=1), **kw)
    return s, health, clock, hook


def case_straggler(n: int, X, centers, victim: int, service: float,
                   warm, stream, k: int, hedged: bool):
    """The reference's hedged-straggler stream: ``warm`` searches, then a
    delay of 10 x ``service`` scripted on every dispatch that touches
    ``victim`` (whose lists are replicated), then ``stream``. Returns the
    latencies on the injected clock, each answer's ids and hedged flag,
    the minimum coverage, the hedge counters and the health's view."""
    mesh = sub_mesh(n)
    if mesh is None:
        return None
    s, health, clock, hook = _straggler_searcher(mesh, X, centers, victim,
                                                 service, hedged)
    for q in warm:
        s.search(q, k)
    hook.fault = (victim, 10 * service, None)
    lats, hedged_flags, ids, cov = [], [], [], 1.0
    for q in stream:
        t0 = clock.monotonic()
        out = s.search(q, k)
        lats.append(clock.monotonic() - t0)
        hedged_flags.append(out.hedged)
        ids.append(out.indices)
        cov = min(cov, float(out.coverage.min()))
    view = None if health is None else (health.suspect_mask,
                                        health.live_mask)
    return (np.asarray(lats), hedged_flags, ids, cov,
            s.hedge_stats.snapshot(), view)


def case_recovery(n: int, X, centers, victim: int, service: float, probe_q,
                  k: int):
    """The reference's breaker on the routed searcher: ``victim`` dead, a
    slow probe scripted at the second probe; five steps of a
    RecoveryProber (clean_threshold 3, budget 5 x ``service``). Returns
    each step's re-admissions and breaker state, the snapshot, the
    health's state and whether a latency was recorded for the victim."""
    from raft_tpu_torch.serve import RecoveryProber

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    s, health, clock, hook = _straggler_searcher(mesh, X, centers, victim,
                                                 service, True)
    health.mark_dead(victim)
    prober = RecoveryProber(s, health, probe_q, k, clean_threshold=3,
                            budget=5 * service)
    hook.fault = (victim, 10 * service, (1,))
    steps = []
    for _ in range(5):
        steps.append((prober.step(), prober.state(victim)))
    snap = prober.snapshot()
    prober.close()
    return (steps, snap, health.state(victim),
            bool(np.isnan(health.latency_ewma(victim))))


def drive_stream(mod, searcher, reqs, clock):
    """One request stream through ``mod``'s BatchScheduler (either
    package): submits with deadlines and priorities, pumps as the clock
    advances, sheds at a small queue bound. Returns the events, each
    ticket's answer (or error name), the stats and cache snapshots."""
    sched = mod.BatchScheduler(
        searcher, mod.BucketGrid.pow2(8, k_grid=(5, 10)),
        mod.BatchPolicy(max_batch=8, max_wait=0.01, max_queue=3),
        cache=mod.ResultCache(16), stats=mod.ServeStats(), clock=clock)
    tickets, events = [], []
    for i, (q, k) in enumerate(reqs):
        deadline = clock() + 0.03 if i % 4 == 0 else None
        try:
            tickets.append(sched.submit(q, k, deadline=deadline,
                                        priority=i % 3))
            events.append("ok")
        except Exception as err:         # noqa: BLE001 - the outcome
            events.append(type(err).__name__)
        clock.advance(0.004)
        if i % 4 == 3:
            events.append(sched.pump())
    sched.run_until_idle()
    results = []
    for tk in tickets:
        try:
            r = tk.result()
            results.append((np.asarray(r.distances), np.asarray(r.indices),
                            np.asarray(r.coverage), r.degraded, r.hedged,
                            r.quality))
        except Exception as err:         # noqa: BLE001 - the outcome
            results.append(type(err).__name__)
    sched.close()
    return (events, results, sched.stats.snapshot(), sched.cache.snapshot())


def case_scheduler(n: int, kind: str, X, centers, reqs, del_ids):
    """A BatchScheduler on rank 0 over a sharded Searcher (brute force or
    list-placed IVF-Flat), the other ranks following: rank 0 returns
    :func:`drive_stream`'s outputs and each request's unbatched sharded
    answer, the followers their batch counts. IVF-Flat then deletes
    ``del_ids`` and runs a Compactor daemon whose pass goes through the
    command channel: rank 0 returns its pass count, every rank its epoch
    and tombstone count."""
    import threading

    from raft_tpu_torch import lifecycle, serve
    from raft_tpu_torch.neighbors import ivf_flat

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    if kind == "brute_force":
        s = serve.Searcher.brute_force(X, mesh=mesh)
    else:
        s = serve.Searcher.ivf_flat(_list_index(mesh, X, centers),
                                    ivf_flat.SearchParams(n_probes=3),
                                    mesh=mesh)
    if mesh.rank:
        out = serve.BatchScheduler.follow(s)
    else:
        out = drive_stream(serve, s, reqs, FakeClock())
    direct = [s.search(q, k).indices for q, k in reqs]
    if kind == "brute_force":
        return out, direct
    s.delete(del_ids)
    gate = threading.Event()
    comp = lifecycle.Compactor(s, lifecycle.CompactionPolicy(
        trigger_frac=0.01), sleep=lambda _t: gate.wait(10))
    if mesh.rank:
        serve.BatchScheduler.follow(s)
    else:
        sched = serve.BatchScheduler(s, serve.BucketGrid.pow2(8),
                                     serve.BatchPolicy(max_batch=8))
        comp.start()
        while sched._pass is None:
            gate.wait(0.01)
        sched.pump()
        gate.set()
        comp.stop()
        sched.close()
    return out, direct, comp.passes, s.epoch, s._index.n_deleted


def case_finite_everywhere(n: int, X):
    """Rank n - 1's shard holds a NaN: every rank must raise."""
    from raft_tpu_torch.core.error import LogicError
    from raft_tpu_torch.parallel import sharded_knn

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    try:
        sharded_knn(mesh, X, X[:2], 3)
    except LogicError as e:
        return str(e)
    return None


def case_host_sendrecv_retry(n: int, failures: int):
    """host_sendrecv under a RetryPolicy whose hook fails the first
    ``failures`` attempts on every rank: the permuted rows and the
    attempt count."""
    from raft_tpu_torch.comms.comms import Comms
    from raft_tpu_torch.core.retry import RetryPolicy

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    attempts = []

    def hook(transfer):
        def attempt():
            attempts.append(1)
            if len(attempts) <= failures:
                raise OSError("transient")
            return transfer()
        return attempt

    payload = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    out = Comms(mesh).host_sendrecv(payload, dest=2, source=1,
                                    retry=RetryPolicy(base_delay=0.0),
                                    transfer_hook=hook)
    return out, len(attempts)


def case_comm_split(n: int):
    """comm_split by rank parity: each rank's sub-rank, the sub-group's
    gather of world ranks and its sync_stream status."""
    from raft_tpu_torch.comms.comms import Comms

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    comms = Comms(mesh)
    r = comms.get_rank()
    sub = comms.comm_split(r % 2)
    got = sub.allgather(torch.tensor([r]))
    return sub.get_rank(), got.numpy(), sub.sync_stream(got).name


def case_comm_split_part(n: int):
    """comm_split of a communicator over part of the job: the message."""
    from raft_tpu_torch.comms.comms import Comms
    from raft_tpu_torch.core.error import LogicError

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    try:
        Comms(mesh).comm_split(0)
    except LogicError as e:
        return str(e)
    return None
