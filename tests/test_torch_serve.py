"""The serving runtime of raft_tpu_torch against raft_tpu's, on the CPU.

Every case feeds the same seeded numpy inputs, and the same injected
clock (the reference suite's ``Clock``), through ``raft_tpu.serve`` and
``raft_tpu_torch.serve``:

* host logic must give equal outputs: ``BucketGrid`` / ``pad_queries``,
  ``ResultCache``'s LRU and epoch isolation, ``RetryPolicy.delays()`` and
  ``with_retry``'s attempt schedule, the ``Tracer`` span tree and its JSON
  and Chrome exports (byte for byte);
* single-host ``Searcher`` over brute force, IVF-Flat and IVF-PQ: the
  reference with ``mesh=None`` and the port on ``cpu`` search the same
  index (IVF arrays built by the reference and crossed over with
  ``index_from_numpy``). Rows and queries are integer valued, so ids must
  be identical and distances equal (IVF-Flat within rtol 1e-6, the
  tolerance of its own parity tests);
* ``BatchScheduler``: one request stream under one clock gives the same
  tickets, the same ``stats.snapshot()`` (counters and latency
  quantiles), the same ``Overloaded`` sheds and the same ladder rungs,
  over the reference suite's cost-model fake searcher; reduced answers
  are never cached in either;
* ``Compactor``: the same ``should_run`` decisions and report, and
  identical searches after ``run_once``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import lifecycle as jlc
from raft_tpu import serve as jserve
from raft_tpu.core import retry as jretry
from raft_tpu.core.error import LogicError as JLogicError
from raft_tpu.distance.distance_types import DistanceType as JDistance
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.obs import trace as jtrace
from raft_tpu_torch import lifecycle as lc
from raft_tpu_torch import obs, serve
from raft_tpu_torch.core import retry
from raft_tpu_torch.core.error import CudaError, LogicError
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from raft_tpu_torch.obs import trace
from raft_tpu_torch.ops import _build
from test_serve import Clock, _CostModelSearcher
from test_torch_common import int_data, n, t

DIM = 16
N_DB = 1024
_RNG = np.random.default_rng(7)
_DB = int_data(_RNG, (N_DB, DIM))


def _queries(rng, rows):
    return int_data(rng, (rows, DIM))


def _flat_pair(n_probes=8, n_lists=16):
    """The reference's IVF-Flat index over the shared integer rows, its
    centers rounded to integers, and the port's copy of its arrays."""
    j = jivf.build(jivf.IndexParams(n_lists=n_lists, kmeans_n_iters=4), _DB)
    j = dataclasses.replace(j, centers=jnp.round(j.centers))
    p = ivf_flat.index_from_numpy(n(j.centers), n(j.data), n(j.indices),
                                  n(j.list_sizes), j.metric.value,
                                  device="cpu")
    p.epoch = int(j.epoch)              # the reference's build extends
    return (serve.Searcher.ivf_flat(p, ivf_flat.SearchParams(n_probes)),
            jserve.Searcher.ivf_flat(j, jivf.SearchParams(n_probes)))


PQ_DIM, PQ_LISTS, PQ_CAP = 8, 16, 96


def _pq_pair(n_probes=8):
    """A small IVF-PQ index from integer arrays (identity rotation) in
    both packages."""
    rng = np.random.default_rng(3)
    sizes = rng.integers(40, PQ_CAP + 1, PQ_LISTS).astype(np.int32)
    indices = np.full((PQ_LISTS, PQ_CAP), -1, np.int32)
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for l in range(PQ_LISTS):
        indices[l, :sizes[l]] = base[l] + np.arange(sizes[l])
    codes = rng.integers(0, 256, (PQ_LISTS, PQ_CAP, PQ_DIM)).astype(np.int32)
    a = dict(centers=int_data(rng, (PQ_LISTS, DIM), hi=4),
             rotation_matrix=np.eye(DIM, dtype=np.float32),
             pq_centers=rng.integers(-2, 3, (PQ_DIM, 256, DIM // PQ_DIM)
                                     ).astype(np.float32),
             pq_codes=n(ivf_pq.pack_codes(t(codes), 8)),
             indices=indices, list_sizes=sizes, pq_bits=8, pq_dim=PQ_DIM)
    j = jpq.Index(metric=JDistance.L2Expanded,
                  codebook_kind=jpq.CodebookGen(0),
                  **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in a.items()})
    p = ivf_pq.index_from_numpy(**a, codebook_kind=0, metric=0,
                                device="cpu")
    return (serve.Searcher.ivf_pq(p, ivf_pq.SearchParams(n_probes)),
            jserve.Searcher.ivf_pq(j, jpq.SearchParams(n_probes)))


def _bf_pair():
    return (serve.Searcher.brute_force(t(_DB)),
            jserve.Searcher.brute_force(_DB))


def _same_result(res, jres, rtol=0.0):
    np.testing.assert_array_equal(res.indices, np.asarray(jres.indices))
    np.testing.assert_allclose(res.distances, np.asarray(jres.distances),
                               rtol=rtol, atol=0)
    np.testing.assert_array_equal(res.coverage, np.asarray(jres.coverage))
    assert (res.degraded, res.hedged, res.quality, res.degrade_reason) == (
        jres.degraded, jres.hedged, jres.quality, jres.degrade_reason)


# ---------------------------------------------------------------------------
# Host logic


def test_exports_match_reference():
    assert set(serve.__all__) == set(jserve.__all__)
    assert all(hasattr(serve, name) for name in serve.__all__)
    assert "Compactor" in lc.__all__ and lc.Compactor is not None


@pytest.mark.parametrize("max_batch,k_grid", [(12, (1, 10)), (512, (10, 100)),
                                              (1, (5,)), (33, (1, 10, 100))])
def test_bucket_grid_and_pad_queries(max_batch, k_grid):
    g = serve.BucketGrid.pow2(max_batch, k_grid=k_grid)
    jg = jserve.BucketGrid.pow2(max_batch, k_grid=k_grid)
    assert (g.q_buckets, g.k_grid, g.max_batch, g.max_k, g.shapes()) == (
        jg.q_buckets, jg.k_grid, jg.max_batch, jg.max_k, jg.shapes())
    for rows in range(0, g.max_batch + 3):
        for k in (1, 5, 10, 11, 100, 101):
            assert g.bucket_for(rows, k) == jg.bucket_for(rows, k)
            assert g.bucket_k(k) == jg.bucket_k(k)
        assert g.bucket_queries(rows) == jg.bucket_queries(rows)
    q = _queries(np.random.default_rng(max_batch), 3)
    for qb in (3, 4, g.max_batch):
        if qb >= 3:
            np.testing.assert_array_equal(serve.pad_queries(q, qb),
                                          jserve.pad_queries(q, qb))
    assert serve.pad_queries(q, 3) is q
    with pytest.raises(LogicError):
        serve.pad_queries(q, 2)
    for bad in (dict(q_buckets=(4, 2), k_grid=(10,)),
                dict(q_buckets=(), k_grid=(10,)),
                dict(q_buckets=(1, 2), k_grid=(10, 10))):
        with pytest.raises(LogicError):
            serve.BucketGrid(**bad)
        with pytest.raises(JLogicError):
            jserve.BucketGrid(**bad)


def _cache_script(mod):
    """One sequence of puts, gets and invalidations; returns everything
    observable."""
    cache = mod.ResultCache(3)
    qs = [np.full((1, 2), i, np.float32) for i in range(5)]
    out = []
    cache.put(0, qs[0], 5, "r0")
    cache.put(0, qs[1], 5, "r1")
    out.append(cache.get(0, qs[0], 5))            # refresh q0
    cache.put(0, qs[2], 5, "r2")
    cache.put(0, qs[3], 5, "r3")                  # evicts q1 (LRU)
    out += [cache.get(0, qs[1], 5), cache.get(0, qs[0], 5)]
    out += [cache.get(1, qs[0], 5), cache.get(0, qs[0], 6),
            cache.get(0, qs[0] + 1e-7, 5)]        # epoch, k, bytes
    cache.put(0, np.zeros((1, 4), np.float32), 5, "A")
    out.append(cache.get(0, np.zeros((4, 1), np.float32), 5))  # shape
    cache.put(1, qs[4], 5, "new")
    out += [cache.invalidate(epoch=0), cache.get(1, qs[4], 5), len(cache),
            cache.invalidate(), len(cache)]
    return out, cache.snapshot()


def test_result_cache_lru_and_epoch_isolation():
    assert _cache_script(serve) == _cache_script(jserve)
    with pytest.raises(LogicError):
        serve.ResultCache(0)


@pytest.mark.parametrize("kw", [{}, dict(max_attempts=5, base_delay=0.1,
                                         backoff=3.0, max_delay=0.5),
                                dict(max_attempts=1), dict(backoff=1.0)])
def test_retry_policy_delays(kw):
    assert retry.RetryPolicy(**kw).delays() == jretry.RetryPolicy(
        **kw).delays()


def _retry_script(mod, fails, max_attempts, timeout, slow_attempts):
    """``fn`` raises OSError ``fails`` times, and the attempts listed in
    ``slow_attempts`` take 1 s on the fake clock. Returns the schedule:
    sleeps, on_retry calls and the outcome (result, or the error type and
    the length of its cause chain)."""
    clock = Clock()
    sleeps, retries = [], []
    calls = [0]

    def fn():
        calls[0] += 1
        if calls[0] in slow_attempts:
            clock.advance(1.0)
        if calls[0] <= fails:
            raise OSError("transient %d" % calls[0])
        return "ok@%d" % calls[0]

    def sleep(dt):
        sleeps.append(dt)
        clock.advance(dt)

    policy = mod.RetryPolicy(max_attempts=max_attempts, base_delay=0.05,
                             attempt_timeout=timeout)
    try:
        out = mod.with_retry(fn, policy, sleep=sleep, monotonic=clock,
                             on_retry=lambda a, e: retries.append(
                                 (a, type(e).__name__, str(e))))
    except Exception as err:             # noqa: BLE001 - the outcome
        depth, e = 0, err
        while e.__cause__ is not None:
            depth, e = depth + 1, e.__cause__
        out = (type(err).__name__, str(err), depth)
    return sleeps, retries, out, calls[0], clock()


@pytest.mark.parametrize("fails,max_attempts,timeout,slow", [
    (0, 3, None, ()), (2, 3, None, ()), (3, 3, None, ()), (5, 4, None, ()),
    (0, 3, 0.5, (1,)), (1, 3, 0.5, (2, 3))])
def test_with_retry_schedule(fails, max_attempts, timeout, slow):
    assert _retry_script(retry, fails, max_attempts, timeout, slow) == \
        _retry_script(jretry, fails, max_attempts, timeout, slow)


def _trace_script(mod):
    clock = Clock()
    tr = mod.Tracer(clock=clock, max_traces=2)
    for r in range(3):
        root = tr.request("serve.request", rows=r + 1, k=5, seq=r)
        with root.child("cache_lookup"):
            clock.advance(0.25)
        qw = root.child("queue_wait")
        clock.advance(0.5)
        qw.finish()
        root.child_at("device_dispatch", 1.0, 1.75, kind="ivf_flat")
        root.annotate(bucket="%dx5" % (r + 1))
        clock.advance(0.125)
        root.finish(cache="miss")
    off = mod.Tracer(clock=clock, enabled=False)
    assert off.request("x") is mod.NULL_SPAN
    return (tr.to_json(), tr.chrome_trace_json(), tr.dropped, tr.pending,
            tr.to_json(drain=True), tr.pending)


def test_tracer_exports_byte_identical():
    assert _trace_script(trace) == _trace_script(jtrace)


# ---------------------------------------------------------------------------
# Single-host Searcher


@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat", "ivf_pq"])
@pytest.mark.parametrize("k", [1, 10])
def test_searcher_single_host(kind, k):
    s, js = {"brute_force": _bf_pair, "ivf_flat": _flat_pair,
             "ivf_pq": _pq_pair}[kind]()
    rng = np.random.default_rng(97)
    rtol = 1e-6 if kind == "ivf_flat" else 0.0
    assert (s.dim, s.epoch, s.kind) == (js.dim, js.epoch, js.kind)
    for rows in (1, 5, 16):
        q = _queries(rng, rows)
        _same_result(s.search(q, k), js.search(q, k), rtol)
    if kind != "brute_force":
        q = _queries(rng, 7)
        _same_result(s.search(q, k, n_probes=2),
                     js.search(q, k, n_probes=2), rtol)
    assert s.device.type == "cpu"


def test_searcher_mutations_bump_epoch_as_the_reference():
    s, js = _flat_pair()
    rng = np.random.default_rng(5)
    q = _queries(rng, 6)
    for step in ("extend", "delete", "upsert", "compact", "miss"):
        if step == "extend":
            new = int_data(rng, (40, DIM))
            s.extend(new)
            js.extend(new)
        elif step == "delete":
            assert s.delete(np.arange(0, 300, 3)) == js.delete(
                np.arange(0, 300, 3))
        elif step == "upsert":
            ids = np.arange(1, 60, 2)
            new = int_data(rng, (ids.size, DIM))
            s.upsert(new, ids)
            js.upsert(new, ids)
        elif step == "compact":
            rep, jrep = s.compact(), js.compact()
            assert dataclasses.asdict(rep) == {
                f.name: getattr(jrep, f.name)
                for f in dataclasses.fields(rep)}
        else:
            assert s.delete([10 ** 6]) == js.delete([10 ** 6]) == 0
        assert s.epoch == js.epoch
        assert s.tombstone_frac == pytest.approx(js.tombstone_frac)
        _same_result(s.search(q, 10), js.search(q, 10), 1e-6)
    bf, jbf = _bf_pair()
    new = int_data(rng, (8, DIM))
    bf.extend(new)
    jbf.extend(new)
    assert bf.epoch == jbf.epoch == 1
    _same_result(bf.search(q, 10), jbf.search(q, 10))


def test_searcher_device_rules():
    s, _ = _bf_pair()
    assert s.device.type == "cpu"
    if not torch.cuda.is_available():
        # numpy goes to the card by default, and there is none
        with pytest.raises(CudaError):
            serve.Searcher.brute_force(_DB)
        with pytest.raises(CudaError):
            serve.Searcher.brute_force(t(_DB), device="cuda")
    with pytest.raises(LogicError):
        serve.Searcher.brute_force(t(_DB), device="meta")
    assert serve.Searcher.brute_force(_DB, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw,queue", [
    (dict(mesh=object()), "A.4"), (dict(health=object()), "A.4"),
    # A log on a brute-force searcher: the reference's own refusal.
    pytest.param(dict(wal=object()), "records sharded IVF mutations",
                 id="kw2-A.5"),
    (dict(hedge=serve.HedgePolicy()), "A.4"),
    (dict(dispatch_hook=print), "A.4")])
def test_waiting_features_raise(kw, queue):
    with pytest.raises(LogicError, match=queue):
        serve.Searcher.brute_force(t(_DB), **kw)
    if "wal" in kw:
        with pytest.raises(JLogicError, match=queue):
            jserve.Searcher.brute_force(_DB, **kw)


def test_sharded_only_paths_raise():
    s, _ = _bf_pair()
    with pytest.raises(LogicError, match="A.4"):
        s.shadow_probe(0, _DB[:2], 5)
    with pytest.raises(LogicError):
        serve.warmup(s, serve.BucketGrid.pow2(2), include_degraded=True)
    with pytest.raises(LogicError):
        s.delete([1])            # brute-force rows are positional
    # The shadow recall probe is accepted (obs/recall.py).
    probe = obs.RecallProbe(s, rate=0.0)
    sched = serve.BatchScheduler(s, serve.BucketGrid.pow2(2),
                                 serve.BatchPolicy(max_batch=2), probe=probe)
    assert sched.probe is probe
    sched.close()


# ---------------------------------------------------------------------------
# BatchScheduler


def _stream(seed=11, n_req=30):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_req):
        if reqs and rng.random() < 0.3:
            reqs.append(reqs[rng.integers(0, len(reqs))])
        else:
            reqs.append((_queries(rng, int(rng.integers(1, 9))),
                         int((3, 5, 10)[rng.integers(0, 3)])))
    return reqs


def _drive(mod, searcher, reqs, tracer=False):
    """One request stream through ``mod``'s BatchScheduler: submits with
    deadlines and priorities, pumps as the clock advances, sheds at a
    small queue bound. Returns everything observable."""
    clock = Clock()
    tr = ((trace if mod is serve else jtrace).Tracer(clock=clock)
          if tracer else None)
    sched = mod.BatchScheduler(
        searcher, mod.BucketGrid.pow2(8, k_grid=(5, 10)),
        mod.BatchPolicy(max_batch=8, max_wait=0.01, max_queue=3),
        cache=mod.ResultCache(16), stats=mod.ServeStats(), clock=clock,
        tracer=tr)
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
            results.append(tk.result())
        except Exception as err:         # noqa: BLE001 - the outcome
            results.append(type(err).__name__)
    sched.close()
    return (events, results, sched.stats.snapshot(),
            sched.cache.snapshot(), tr.to_json() if tr else None)


@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat"])
def test_scheduler_stream_equals_reference(kind):
    s, js = _bf_pair() if kind == "brute_force" else _flat_pair()
    reqs = _stream()
    ev, res, snap, cache, _ = _drive(serve, s, reqs)
    jev, jres, jsnap, jcache, _ = _drive(jserve, js, reqs)
    assert ev == jev
    assert "Overloaded" in ev
    assert snap == jsnap and cache == jcache
    assert sum(b["cache_hits"] for b in snap["buckets"].values()) > 0
    assert sum(b["batched_rows"] for b in snap["buckets"].values()) > 0
    assert sum(b["padded_slots"] for b in snap["buckets"].values()) > 0
    assert len(res) == len(jres)
    for r, jr in zip(res, jres):
        if isinstance(r, str):
            assert r == jr
        else:
            _same_result(r, jr, 1e-6 if kind == "ivf_flat" else 0.0)


def test_scheduler_span_tree_equals_reference():
    """The traced scheduler's request trees (queue_wait, batch_assembly,
    the searcher's device_dispatch and device_get, result_merge) export
    byte for byte the reference's under one clock."""
    s, js = _bf_pair()
    reqs = _stream(seed=13, n_req=12)
    out = _drive(serve, s, reqs, tracer=True)[4]
    assert out == _drive(jserve, js, reqs, tracer=True)[4]
    assert "device_dispatch" in out and "result_merge" in out


def test_priority_shed_equals_reference():
    outs = []
    for mod, (s, _) in ((serve, _bf_pair()), (jserve, _bf_pair()[::-1])):
        clock = Clock()
        sched = mod.BatchScheduler(
            s, mod.BucketGrid.pow2(16, k_grid=(5, 10)),
            mod.BatchPolicy(max_batch=16, max_wait=10.0, max_queue=2),
            stats=mod.ServeStats(), clock=clock)
        rng = np.random.default_rng(61)
        seen = []
        tks = []
        for pri in (0, 0, 1, 1, 1, 0):
            try:
                tks.append(sched.submit(_queries(rng, 1), 5, priority=pri))
                seen.append("ok")
            except mod.Overloaded:
                seen.append("shed")
            clock.advance(0.001)
            seen.append([tk.done for tk in tks])
        sched.run_until_idle()
        seen.append([tk.result().indices.tolist() if tk._error is None
                     else "evicted" for tk in tks])
        outs.append((seen, sched.stats.snapshot()))
    assert outs[0] == outs[1]


def _ladder_script(mod, searcher):
    """The reference suite's ladder scenarios on one searcher: queue
    pressure walks rung 1 then the deepest rung and back to full; a
    deadline budget under the cost model picks the rung that fits;
    reduced answers are never cached."""
    clock = Clock()
    cost = _CostModelSearcher(searcher, clock, per_probe=0.01)
    cache = mod.ResultCache(32)
    sched = mod.BatchScheduler(
        cost, mod.BucketGrid.pow2(8, k_grid=(5, 10)),
        mod.BatchPolicy(max_batch=8, max_wait=10.0, max_queue=8),
        cache=cache, stats=mod.ServeStats(), clock=clock,
        degrade=mod.DegradePolicy(queue_high=0.25, queue_full=0.8,
                                  min_samples=4))
    rng = np.random.default_rng(41)
    q8 = _queries(rng, 8)
    out = []
    tA = sched.submit(q8, 5)
    backlog = [sched.submit(_queries(rng, 1), 10) for _ in range(3)]
    sched.pump()
    out += [tA.result(), sched.brownout_level, len(cache)]
    backlog += [sched.submit(_queries(rng, 1), 10) for _ in range(4)]
    tB = sched.submit(q8, 5)
    sched.pump()
    out += [tB.result(), sched.brownout_level, len(cache)]
    clock.advance(11.0)
    sched.run_until_idle()
    out += [b.result() for b in backlog] + [sched.brownout_level,
                                            len(cache)]
    for _ in range(8):                  # teach the model: full ~0.08 s
        sched.stats.observe_latency((4, 5), 0.08)
    for _ in range(5):
        tk = sched.submit(_queries(rng, 4), 5, deadline=clock() + 0.05)
        sched.flush()
        out.append(tk.result())
    tk = sched.submit(q8, 5)            # re-ask at full quality
    sched.flush()
    out += [tk.result(), len(cache), sched.stats.snapshot()]
    return out


def test_degrade_ladder_equals_reference():
    s, js = _flat_pair(n_probes=8, n_lists=8)
    out, jout = _ladder_script(serve, s), _ladder_script(jserve, js)
    assert len(out) == len(jout)
    for a, b in zip(out, jout):
        if isinstance(a, serve.SearchResult):
            _same_result(a, b, 1e-6)
        else:
            assert a == b
    qualities = [a.quality for a in out if isinstance(a, serve.SearchResult)]
    assert {"full", "reduced", "brownout"} <= set(qualities)
    assert out[2] == 0                  # the reduced answer was not cached


def test_degrade_policy_rungs_equal_reference():
    for kw in (dict(), dict(ladder=(1.0, 0.5), min_probes=2),
               dict(ladder=(1.0, 0.6, 0.3, 0.1), min_probes=3)):
        p, jp = serve.DegradePolicy(**kw), jserve.DegradePolicy(**kw)
        for base in (1, 4, 8, 32):
            for rung in range(len(p.ladder)):
                assert p.probes_at(base, rung) == jp.probes_at(base, rung)
                assert p.quality_at(rung) == jp.quality_at(rung)
    for bad in (dict(ladder=(1.0,)), dict(ladder=(0.5, 0.25)),
                dict(ladder=(1.0, 0.5, 0.5)),
                dict(queue_high=0.9, queue_full=0.5)):
        with pytest.raises(LogicError):
            serve.DegradePolicy(**bad)
        with pytest.raises(JLogicError):
            jserve.DegradePolicy(**bad)


@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat"])
def test_warmup_report_equals_reference(kind):
    s, js = _bf_pair() if kind == "brute_force" else _flat_pair()
    grid = serve.BucketGrid(q_buckets=(2, 8), k_grid=(5,))
    jgrid = jserve.BucketGrid(q_buckets=(2, 8), k_grid=(5,))
    rep = serve.warmup(s, grid, degrade_ladder=(1.0, 0.5, 0.25))
    jrep = jserve.warmup(js, jgrid, degrade_ladder=(1.0, 0.5, 0.25))
    for key in ("shapes", "degraded", "routed_shapes", "degrade_rungs"):
        assert rep[key] == jrep[key]
    # No kernel is built or loaded for CPU tensors.
    assert rep["compile_events"] == 0
    assert rep["cache_dir"] == str(_build.BUILD_DIR)


def test_warmup_cache_dir_names_the_build_dir(tmp_path):
    """The port builds into one directory: ``cache_dir`` may name it, and
    any other directory raises rather than moving later builds."""
    s, _ = _bf_pair()
    grid = serve.BucketGrid(q_buckets=(2,), k_grid=(5,))
    rep = serve.warmup(s, grid, cache_dir=str(_build.BUILD_DIR))
    assert rep["cache_dir"] == _build.enable_compilation_cache()
    with pytest.raises(LogicError, match="builds its kernels"):
        serve.warmup(s, grid, cache_dir=str(tmp_path))
    assert _build.enable_compilation_cache() == str(_build.BUILD_DIR)


def test_compile_counter_counts_builds_and_loads(monkeypatch, tmp_path):
    """The counter hears ``_build``'s events: one per nvcc run, one per
    first library load, none after it closes."""
    import ctypes.util

    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to load on this machine")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "build_all", lambda names: {
        names[0]: libc})
    stats = serve.ServeStats()
    with serve.CompileCounter(stats) as counter:
        _build.load_library("fake_a")
        _build.load_library("fake_a")       # already loaded: no event
        _build._notify("build", "fake_b")
    _build.load_library("fake_c")           # counter closed
    assert counter.count == 2
    assert stats.snapshot()["compile_events"] == 2
    assert not _build._LISTENERS


# ---------------------------------------------------------------------------
# Compactor


def test_compactor_equals_reference():
    s, js = _flat_pair()
    pol = lc.CompactionPolicy(trigger_frac=0.1)
    jpol = jlc.CompactionPolicy(trigger_frac=0.1)
    flag = [False]
    c = lc.Compactor(s, pol, drift_signal=lambda: flag[0])
    jc = jlc.Compactor(js, jpol, drift_signal=lambda: flag[0])
    q = _queries(np.random.default_rng(17), 9)
    trail = []
    for step, (ids, drift) in enumerate([
            (np.arange(0, 40), False), (np.arange(40, 90), False),
            (None, True), (None, True), (None, False),
            (np.arange(90, 200), False), (None, False)]):
        flag[0] = drift
        if ids is not None:
            assert s.delete(ids) == js.delete(ids)
        rep, jrep = c.run_once(), jc.run_once()
        trail.append((step, c.last_should_run, jc.last_should_run,
                      c.passes, jc.passes, c.skipped, jc.skipped))
        assert c.last_trigger_frac == pytest.approx(jc.last_trigger_frac)
        assert (rep is None) == (jrep is None), trail
        if rep is not None:
            assert dataclasses.asdict(rep) == {
                f.name: getattr(jrep, f.name)
                for f in dataclasses.fields(rep)}
        assert s.epoch == js.epoch
        _same_result(s.search(q, 10), js.search(q, 10), 1e-6)
    assert [x[1] for x in trail] == [x[2] for x in trail]
    assert c.passes == jc.passes >= 2
    forced, jforced = c.run_once(force=True), jc.run_once(force=True)
    assert forced is None and jforced is None  # nothing left to reclaim


def test_compactor_loop_and_failures():
    """The daemon loop runs on the injected sleep and survives a failing
    pre_publish, which publishes nothing."""
    s, _ = _flat_pair()
    s.delete(np.arange(0, 500))
    e0 = s.epoch

    def boom():
        raise RuntimeError("injected")

    c = lc.Compactor(s, lc.CompactionPolicy(trigger_frac=0.1),
                     pre_publish=boom)
    with pytest.raises(RuntimeError):
        c.run_once()
    assert (c.failures, s.epoch) == (1, e0) and "injected" in c.last_error
    slept = []
    c2 = lc.Compactor(s, lc.CompactionPolicy(trigger_frac=0.1),
                      interval=0.5, sleep=lambda dt: (slept.append(dt),
                                                      c2._stop.wait(0.01)))
    c2.start()
    c2.start()                              # idempotent
    for _ in range(500):
        if c2.passes:
            break
        c2._stop.wait(0.01)
    c2.stop()
    assert c2.passes == 1 and s.epoch == e0 + 1 and slept[0] == 0.5
    assert c2._thread is None


# ---------------------------------------------------------------------------
# Threads: request threads submit while one thread pumps and a
# mutation thread deletes and compacts.


def test_threaded_submit_pump_and_mutations():
    import sys
    import threading

    s, _ = _flat_pair()
    sched = serve.BatchScheduler(
        s, serve.BucketGrid.pow2(8, k_grid=(5, 10)),
        serve.BatchPolicy(max_batch=8, max_wait=0.0, max_queue=16),
        cache=serve.ResultCache(64))
    n_threads, per_thread = 8, 25
    admitted, shed, errors = [], [], []
    lock = threading.Lock()
    stop = threading.Event()
    e0 = s.epoch

    def submitter(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(per_thread):
                q, k = _queries(rng, int(rng.integers(1, 5))), (5, 10)[
                    int(rng.integers(0, 2))]
                try:
                    tk = sched.submit(q, k)
                    with lock:
                        admitted.append((tk, q.shape[0], k))
                except serve.Overloaded:
                    with lock:
                        shed.append(1)
        except Exception as err:         # noqa: BLE001 - reported below
            errors.append(err)

    def pumper():
        while not stop.is_set():
            sched.pump(force=True)

    def mutator():
        try:
            for lo in range(0, 400, 100):
                s.delete(np.arange(lo, lo + 100))
            s.compact()
        except Exception as err:         # noqa: BLE001 - reported below
            errors.append(err)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(n_threads)]
        threads.append(threading.Thread(target=mutator))
        pump = threading.Thread(target=pumper)
        pump.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        stop.set()
        pump.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert not pump.is_alive() and not any(th.is_alive() for th in threads)
    sched.run_until_idle()
    assert len(admitted) + len(shed) == n_threads * per_thread
    for tk, rows, k in admitted:
        assert tk.result().indices.shape == (rows, k)
    snap = sched.stats.snapshot()["buckets"].values()
    total = {c: sum(b[c] for b in snap)
             for c in ("requests", "queued", "shed", "cache_hits")}
    assert total["requests"] == n_threads * per_thread
    assert total["shed"] == len(shed)
    assert total["queued"] + total["cache_hits"] == len(admitted)
    assert s.epoch == e0 + 5             # four deletes and one compaction
    q = _queries(np.random.default_rng(1), 50)
    assert not np.isin(s.search(q, 10).indices, np.arange(400)).any()
