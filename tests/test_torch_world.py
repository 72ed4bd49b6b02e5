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
      before the build and by ("reset",)), ("warmup", n_queries, n_probes).

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


def case_refusals(n: int):
    """The LogicErrors of what waits for the sharding slice's third part
    (ROADMAP A.4c)."""
    from raft_tpu_torch import lifecycle, parallel, serve
    from raft_tpu_torch.core.error import LogicError
    from raft_tpu_torch.core.retry import RetryPolicy
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve.recovery import RecoveryProber

    mesh = sub_mesh(n)
    if mesh is None:
        return None
    X = np.arange(64 * 4, dtype=np.float32).reshape(64, 4) % 7
    index = _flat_build(mesh, X, 4, X[:4])
    msgs = []
    for fn in (
            lambda: parallel.sharded_ivf_save("index", index),
            lambda: parallel.sharded_ivf_load(mesh, "index"),
            lambda: parallel.verify_sharded_manifest("index"),
            lambda: lifecycle.CompactionPolicy(balance_placement=1.5),
            lambda: RecoveryProber(None, None, X[:2]),
            lambda: serve.Searcher.ivf_flat(
                index, ivf_flat.SearchParams(), mesh=mesh,
                hedge=serve.HedgePolicy()),
            lambda: serve.Searcher.brute_force(X, mesh=mesh,
                                               retry=RetryPolicy()),
            lambda: serve.Searcher.brute_force(X, mesh=mesh).shadow_probe(
                0, X[:2], 3),
            lambda: serve.BatchScheduler(
                serve.Searcher.brute_force(X, mesh=mesh),
                serve.BucketGrid.pow2(4)),
            lambda: lifecycle.compact(index, mesh=mesh)):
        try:
            fn()
            msgs.append(None)
        except LogicError as e:
            msgs.append(str(e))
    return msgs


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
