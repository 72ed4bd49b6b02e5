"""The rest of raft_tpu_torch's core/ and util/ against raft_tpu's.

Mirrors tests/test_core.py. The same inputs go through both packages;
operators, math, the array checks, util arithmetic and the sentinels agree
bit for bit (values and dtypes). The handle, tracing, cancellation,
staging and build-cache cases hold the port's counterparts to the
reference's contracts: a torch Generator in place of the PRNG key stream,
record_function / NVTX ranges in place of TraceAnnotation, CUDA events in
place of block_until_ready.
"""

import io
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu_torch
from raft_tpu import core as jcore
from raft_tpu import util as jutil
from raft_tpu.core import interruptible as jint
from raft_tpu.core import math as jmath
from raft_tpu.core import mdarray as jmd
from raft_tpu.core import operators as jops
from raft_tpu.core import sentinels as jsent
from raft_tpu.core import temporary_buffer as jtb
from raft_tpu.util import input_validation as jiv
from raft_tpu_torch import core, util
from raft_tpu_torch.core import compilation_cache, interruptible, mdarray
from raft_tpu_torch.core import math as tmath
from raft_tpu_torch.core import nvtx, resources, sentinels
from raft_tpu_torch.core import operators as ops
from raft_tpu_torch.core import temporary_buffer as tb
from raft_tpu_torch.ops import _build
from raft_tpu_torch.util import input_validation as iv
from test_torch_common import n, t


def _same(got, want):
    """Bit for bit, dtype included."""
    got, want = n(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Resources


class TestResources:
    def test_device_slot_and_lazy_generator(self):
        res = core.Resources("cpu")
        assert res.device == torch.device("cpu")
        assert res.has_resource("generator")
        assert res.generator.device == torch.device("cpu")
        assert res.get_resource("generator") is res.generator

    def test_shallow_copy_shares_objects_not_table(self):
        for mod in (core, jcore):
            res = mod.Resources("cpu") if mod is core else mod.Resources()
            obj = object()
            res.set_resource("x", obj)
            copy = mod.Resources(res)
            assert copy.get_resource("x") is obj
            copy.set_resource("x", "other")
            assert res.get_resource("x") is obj
            override = mod.Resources(res, x="tpu1")
            assert override.get_resource("x") == "tpu1"
            assert res.get_resource("x") is obj

    def test_copy_by_keyword_other(self):
        """``Resources(other=h)`` is the shallow copy ``Resources(h)`` is,
        as the reference's copy constructor takes ``other``."""
        for mod in (core, jcore):
            res = mod.Resources("cpu") if mod is core else mod.Resources()
            obj = object()
            res.set_resource("x", obj)
            copy = mod.Resources(other=res)
            assert copy.get_resource("x") is obj
            assert copy.device == res.device
            assert "other" not in copy._slots
            copy.set_resource("x", "other")
            assert res.get_resource("x") is obj
            override = mod.Resources(other=res, x="tpu1")
            assert override.get_resource("x") == "tpu1"
            assert res.get_resource("x") is obj
        h = core.DeviceResources("cpu", seed=3)
        copy = core.Resources(other=h)
        assert copy.generator is h.generator
        assert core.Resources("cpu", other=h).device == torch.device("cpu")

    def test_seeded_generator_stream(self):
        """DeviceResources(seed=) seeds the generator: the same seed
        draws the same numbers, another seed others, and the stream
        advances (the reference's next_key)."""
        a = core.DeviceResources("cpu", seed=3)
        b = core.DeviceResources("cpu", seed=3)
        c = core.DeviceResources("cpu", seed=4)
        x = torch.randn(8, generator=a.generator)
        assert torch.equal(x, torch.randn(8, generator=b.generator))
        assert not torch.equal(torch.randn(8, generator=a.generator), x)
        assert not torch.equal(
            torch.randn(8, generator=core.DeviceResources(
                "cpu", seed=3).generator),
            torch.randn(8, generator=c.generator))
        assert core.DeviceResources("cpu").generator.initial_seed() == 0

    def test_comms_missing_raises(self):
        with pytest.raises(core.LogicError):
            core.Resources("cpu").get_comms()
        with pytest.raises(jcore.LogicError):
            jcore.Resources().get_comms()

    def test_comms_and_subcomm_roundtrip(self):
        res = core.Resources("cpu")
        assert not res.comms_initialized()
        res.set_comms("fake")
        assert res.comms_initialized() and res.get_comms() == "fake"
        res.set_subcomm("row", "fake-comm")
        assert res.get_subcomm("row") == "fake-comm"
        with pytest.raises(core.LogicError):
            res.get_subcomm("col")

    def test_resource_factory_registry(self):
        calls = []

        @core.resource_factory("torch_test_slot")
        def make(res):
            calls.append(res)
            return len(calls)

        res = core.Resources("cpu")
        assert res.has_resource("torch_test_slot")
        assert res.get_resource("torch_test_slot") == 1
        assert res.get_resource("torch_test_slot") == 1     # made once
        assert not res.has_resource("no_such_slot")
        with pytest.raises(core.LogicError):
            res.get_resource("no_such_slot")

    def test_handle_alias_ensure_handle_and_sync(self):
        assert resources.Handle is core.DeviceResources
        assert raft_tpu_torch.DeviceResources is core.DeviceResources
        assert raft_tpu_torch.Resources is core.Resources
        h = core.DeviceResources("cpu")
        assert resources.ensure_handle(h) is h
        made = resources.ensure_handle(None, "cpu")
        assert isinstance(made, core.DeviceResources)
        assert made.device.type == "cpu"
        h.sync_stream(torch.ones(3))
        h.sync_stream()


# ---------------------------------------------------------------------------
# Array views


class TestValidation:
    def test_check_matrix(self):
        x = np.zeros((3, 4), np.float32)
        arr = core.check_matrix(x, rows=3, cols=4, dtype=torch.float32,
                                device="cpu")
        assert tuple(arr.shape) == (3, 4) and arr.device.type == "cpu"
        assert core.check_matrix(t(x), dtype=np.float32) is not None

    @pytest.mark.parametrize("call", [
        lambda m: m.check_matrix(np.zeros((3, 4), np.float32), rows=5),
        lambda m: m.check_matrix(np.zeros((3, 4), np.float32), cols=3),
        lambda m: m.check_matrix(np.zeros((3, 4), np.float32),
                                 dtype=np.int32),
        lambda m: m.check_vector(np.zeros((3, 4), np.float32)),
        lambda m: m.check_vector(np.zeros(3, np.float32), size=4),
    ])
    def test_refusals_match_reference(self, call):
        with pytest.raises(jcore.LogicError):
            call(jmd)
        with pytest.raises(core.LogicError):
            call(_CpuChecks)

    @pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16,
                                       np.int32, np.int8, np.uint8, bool])
    def test_as_array_dtypes_match_reference(self, dtype):
        x = (np.arange(6).reshape(2, 3) % 2).astype(dtype)
        got = core.as_array(x, device="cpu")
        _same(got, jcore.as_array(x))
        _same(core.as_array(t(x)), jcore.as_array(x))
        _same(core.as_array(x, dtype=np.int32, device="cpu"),
              jcore.as_array(x, dtype=jnp.int32))

    def test_array_spec_and_enums(self):
        spec = core.ArraySpec(dtype=torch.float32, ndim=2, shape=(None, 4))
        spec.validate(torch.zeros(7, 4))
        with pytest.raises(core.LogicError):
            spec.validate(torch.zeros(7, 5))
        assert [(m.name, m.value) for m in core.MemoryType] == [
            (m.name, m.value) for m in jcore.MemoryType]
        assert [(m.name, m.value) for m in mdarray.Layout] == [
            (m.name, m.value) for m in jmd.Layout]
        assert core.row_major.name == "row_major"
        assert core.col_major.value == jcore.col_major.value

    def test_factories_match_reference(self):
        _same(mdarray.make_matrix(3, 2, device="cpu"), jmd.make_matrix(3, 2))
        _same(mdarray.make_vector(5, dtype=np.int32, device="cpu"),
              jmd.make_vector(5, dtype=jnp.int32))
        _same(mdarray.make_scalar(2.5, device="cpu"), jmd.make_scalar(2.5))

    @pytest.mark.parametrize("make", [
        lambda: np.zeros((3, 4), np.float32),
        lambda: np.asfortranarray(np.zeros((3, 4), np.float32)),
        lambda: np.zeros(5, np.float32),
        lambda: np.zeros((3, 4), np.float32)[:, ::2],
    ], ids=["c", "f", "1d", "strided"])
    def test_layout_predicates_on_numpy_match_reference(self, make):
        x = make()
        assert iv.is_row_major(x) == jiv.is_row_major(x)
        assert iv.is_col_major(x) == jiv.is_col_major(x)
        assert util.is_row_major(x) == jutil.is_row_major(x)
        assert mdarray.is_row_major(x) == jmd.is_row_major(x)

    def test_layout_predicates_on_tensors(self):
        x = torch.zeros(3, 4)
        assert util.is_row_major(x) and not util.is_col_major(x)
        assert util.is_col_major(x.T) and not util.is_row_major(x.T)
        assert util.is_row_major(x[0]) and util.is_col_major(x[0])
        # The reference's jax arrays are logically row-major.
        assert jiv.is_row_major(jnp.zeros((3, 4)))
        assert not jiv.is_col_major(jnp.zeros((3, 4)))

    def test_expects_and_fail(self):
        core.expects(True)
        with pytest.raises(core.LogicError):
            core.expects(False, "nope")
        with pytest.raises(core.LogicError, match="stop 3"):
            core.fail("stop %s", 3)
        with pytest.raises(jcore.LogicError):
            jcore.fail("stop")


class _CpuChecks:
    """``check_matrix`` / ``check_vector`` onto the CPU."""

    @staticmethod
    def check_matrix(x, **kw):
        return core.check_matrix(x, device="cpu", **kw)

    @staticmethod
    def check_vector(x, **kw):
        return core.check_vector(x, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Serialize (the core package's exports)


def test_mdspan_and_scalar_roundtrip_through_core():
    buf = io.BytesIO()
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    core.serialize_mdspan(buf, a)
    core.serialize_mdspan(buf, torch.ones((2, 2), dtype=torch.int32))
    core.serialize_scalar(buf, 7, np.int64)
    buf.seek(0)
    np.testing.assert_array_equal(core.deserialize_mdspan(buf), a)
    np.testing.assert_array_equal(core.deserialize_mdspan(buf),
                                  np.ones((2, 2), np.int32))
    assert core.deserialize_scalar(buf, np.int64) == 7
    jbuf = io.BytesIO()
    jcore.serialize_mdspan(jbuf, a)
    pbuf = io.BytesIO()
    core.serialize_mdspan(pbuf, a)
    assert jbuf.getvalue() == pbuf.getvalue()


# ---------------------------------------------------------------------------
# Operators, KeyValuePair, math

_X = np.array([-2.5, -1.0, 0.0, 0.5, 3.0, 4.0], np.float32)
_Y = np.array([1.5, -1.0, 2.0, 0.0, 3.0, -0.25], np.float32)

UNARY = ["identity_op", "sq_op", "abs_op", "nz_op"]
BINARY = ["add_op", "sub_op", "mul_op", "div_op", "div_checkzero_op",
          "min_op", "max_op", "sqdiff_op", "absdiff_op", "equal_op",
          "notequal_op"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_operators_match_reference(name):
    _same(getattr(ops, name)(t(_X), 7), getattr(jops, name)(_X, 7))


def test_sqrt_op_and_cast_op_match_reference():
    np.testing.assert_allclose(n(ops.sqrt_op(t(np.abs(_X)))),
                               np.asarray(jops.sqrt_op(np.abs(_X))),
                               rtol=1e-6)      # XLA's sqrt: an ulp off
    _same(ops.cast_op(torch.int32)(t(_X)), jops.cast_op(jnp.int32)(_X))
    assert ops.void_op(1, 2) is None and jops.void_op(1, 2) is None


@pytest.mark.parametrize("name", BINARY)
def test_binary_operators_match_reference(name):
    _same(getattr(ops, name)(t(_X), t(_Y)),
          getattr(jops, name)(jnp.asarray(_X), jnp.asarray(_Y)))


def test_pow_op_matches_reference():
    a, b = np.abs(_X) + 1, np.array([2, 0.5, 3, 1, 0, 2], np.float32)
    np.testing.assert_allclose(n(ops.pow_op(t(a), t(b))),
                               np.asarray(jops.pow_op(a, b)), rtol=1e-6)


@pytest.mark.parametrize("name,c", [("add_const_op", 2.0),
                                    ("sub_const_op", 0.5),
                                    ("mul_const_op", -3.0),
                                    ("div_const_op", 4.0)])
def test_const_operators_match_reference(name, c):
    _same(getattr(ops, name)(c)(t(_X)), getattr(jops, name)(c)(_X))


def test_compose_matches_reference():
    f = ops.compose_op(ops.sqrt_op, ops.sq_op, ops.add_const_op(1.0))
    jf = jops.compose_op(jops.sqrt_op, jops.sq_op, jops.add_const_op(1.0))
    _same(f(t(_X)), jf(_X))
    assert float(ops.compose_op(ops.sqrt_op, ops.sq_op)(
        torch.tensor(3.0))) == pytest.approx(3.0)


@pytest.mark.parametrize("op", ["argmin_op", "argmax_op"])
def test_kvp_reducers_match_reference_ties_to_lower_key(op):
    """Equal values keep the lower key, whichever side it is on."""
    keys_a = np.array([3, 1, 4, 2, 9], np.int32)
    keys_b = np.array([1, 3, 4, 5, 0], np.int32)
    vals_a = np.array([1.0, 1.0, 2.0, 5.0, -1.0], np.float32)
    vals_b = np.array([1.0, 1.0, 0.0, 5.0, 7.0], np.float32)
    got = getattr(ops, op)(core.KeyValuePair(t(keys_a), t(vals_a)),
                           core.KeyValuePair(t(keys_b), t(vals_b)))
    want = getattr(jops, op)(jcore.KeyValuePair(keys_a, vals_a),
                             jcore.KeyValuePair(keys_b, vals_b))
    _same(got.key, want.key)
    _same(got.value, want.value)
    _same(ops.key_op(got), jops.key_op(want))
    _same(ops.value_op(got), jops.value_op(want))
    tie = getattr(ops, op)(core.KeyValuePair(torch.tensor(3),
                                             torch.tensor(1.0)),
                           core.KeyValuePair(torch.tensor(1),
                                             torch.tensor(1.0)))
    assert int(tie.key) == 1


@pytest.mark.parametrize("name", ["abs", "cos", "exp", "sin", "sqrt",
                                  "tanh", "sgn"])
def test_math_unary_match_reference(name):
    x = np.abs(_X) if name == "sqrt" else _X
    np.testing.assert_allclose(n(getattr(tmath, name)(t(x))),
                               np.asarray(getattr(jmath, name)(x)),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["acos", "asin", "atanh", "log"])
def test_math_domain_limited_match_reference(name):
    x = np.array([0.05, 0.3, 0.5, 0.75, 0.9], np.float32)
    np.testing.assert_allclose(n(getattr(tmath, name)(t(x))),
                               np.asarray(getattr(jmath, name)(x)),
                               rtol=1e-6)
    np.testing.assert_allclose(n(tmath.pow(t(x), t(x))),
                               np.asarray(jmath.pow(x, x)), rtol=1e-6)


def test_math_variadic_max_min_match_reference():
    z = np.array([0.0, 9.0, -9.0, 1.0, 1.0, 1.0], np.float32)
    for name in ("max", "min"):
        _same(getattr(tmath, name)(t(_X), t(_Y), t(z)),
              getattr(jmath, name)(_X, _Y, z))
        _same(getattr(tmath, name)(t(_X)), getattr(jmath, name)(_X))


# ---------------------------------------------------------------------------
# util and sentinels


def test_pow2_matches_reference():
    for v in (1, 2, 64, 128):
        p, jp = util.Pow2(v), jutil.Pow2(v)
        for x in (0, 1, 63, 64, 65, 130, 1000):
            assert (p.round_up(x), p.round_down(x), p.div(x), p.mod(x),
                    p.is_aligned(x)) == (
                jp.round_up(x), jp.round_down(x), jp.div(x), jp.mod(x),
                jp.is_aligned(x))
    for bad in (0, 3, 100):
        with pytest.raises(ValueError):
            util.Pow2(bad)


def test_util_arithmetic_matches_reference():
    for a in range(0, 40, 3):
        for b in (1, 4, 7):
            assert util.ceildiv(a, b) == jutil.ceildiv(a, b)
            assert util.round_up_safe(a, b) == jutil.round_up_safe(a, b)
            assert util.round_down_safe(a, b) == jutil.round_down_safe(a, b)
        assert util.is_pow2(a) == jutil.is_pow2(a)
    assert util.product_of_lists([1, 2], "ab", [None]) == \
        jutil.product_of_lists([1, 2], "ab", [None])


def test_pad_id_matches_reference():
    assert sentinels.pad_id() == jsent.pad_id() == -1
    _same(sentinels.pad_id(torch.int32), jsent.pad_id(jnp.int32))


# ---------------------------------------------------------------------------
# Interruptible


class TestInterruptible:
    def test_sync_ok(self):
        core.synchronize(torch.ones(4))
        core.synchronize()
        jint.synchronize(jnp.ones(4))

    def test_cancel_raises_once(self):
        tok = core.Interruptible.get_token()
        assert tok is core.Interruptible.get_token()
        tok.cancel()
        with pytest.raises(interruptible.InterruptedException):
            tok.interruptible_check()
        tok.interruptible_check()               # flag cleared

    def test_cancelled_synchronize_raises(self):
        core.Interruptible.get_token().cancel()
        with pytest.raises(interruptible.InterruptedException):
            core.synchronize(torch.ones(2))
        core.synchronize(torch.ones(2))

    def test_reset_clears_without_raising(self):
        tok = core.Interruptible.get_token()
        tok.cancel()
        tok.reset()
        tok.interruptible_check()

    def test_cancel_thread_from_another_thread(self):
        main = threading.get_ident()
        worker = threading.Thread(
            target=core.Interruptible.cancel_thread, args=(main,))
        worker.start()
        worker.join()
        with pytest.raises(interruptible.InterruptedException):
            core.Interruptible.get_token().interruptible_check()

    def test_dead_threads_leave_the_registry(self):
        ids = []

        def run():
            ids.append(threading.get_ident())
            core.Interruptible.get_token()

        th = threading.Thread(target=run)
        th.start()
        th.join()
        core.Interruptible.get_token()          # sweeps
        assert ids[0] not in core.Interruptible._registry


# ---------------------------------------------------------------------------
# Tracing


class TestTracing:
    def test_traced_preserves_semantics(self):
        @nvtx.traced
        def f(x):
            return x * 2

        assert f.__name__ == "f" and f.__wrapped__ is not None
        assert int(f(torch.tensor(3))) == 6

    def test_labels_reach_the_profiler(self):
        from torch.profiler import profile

        @nvtx.traced
        def f(x):
            return x + 1

        @nvtx.traced(name="custom", domain="dom")
        def g(x):
            return x - 1

        with profile() as prof:
            f(torch.ones(2))
            g(torch.ones(2))
            with core.range_scope("outer"):
                core.push_range("inner")
                core.pop_range()
        keys = {e.key for e in prof.key_averages()}
        assert {"raft_tpu_torch::test_torch_core.f", "dom::custom",
                "raft_tpu_torch::outer", "raft_tpu_torch::inner"} <= keys

    def test_pop_without_push_is_a_no_op(self):
        core.pop_range()
        core.push_range("a")
        core.push_range("b")
        core.pop_range()
        core.pop_range()
        assert nvtx._stack() == []

    def test_entry_points_are_traced(self):
        from raft_tpu_torch.distance import (fused_l2_nn_min_reduce,
                                             masked_l2_nn, pairwise_distance)
        from raft_tpu_torch.distance.pairwise import distance

        for fn in (distance, pairwise_distance, fused_l2_nn_min_reduce,
                   masked_l2_nn):
            assert fn.__wrapped__ is not None, fn


# ---------------------------------------------------------------------------
# Staging buffer and build cache


@pytest.mark.parametrize("make", ["make_temporary_device_buffer",
                                  "make_readonly_temporary_device_buffer",
                                  "make_writeback_temporary_device_buffer"])
def test_temporary_buffers_match_reference(make):
    """Both stage the array; only the writeback kind copies the final
    value back, and only on a clean exit."""
    host, jhost = np.arange(4, dtype=np.float32), np.arange(4, dtype=np.float32)
    with getattr(tb, make)(host, device="cpu") as buf:
        _same(buf.view(), host)
        buf.value = buf.value * 2
    with getattr(jtb, make)(jhost) as jbuf:
        jbuf.value = jbuf.value * 2
    np.testing.assert_array_equal(host, jhost)
    with pytest.raises(RuntimeError):
        with getattr(tb, make)(host, device="cpu") as buf:
            buf.value = buf.value + 100
            raise RuntimeError("abort")
    np.testing.assert_array_equal(host, jhost)


def test_writeback_of_an_in_place_change():
    """The staged tensor is a copy: an in-place change reaches the host
    array through writeback only."""
    host = np.zeros(3, np.float32)
    with core.make_temporary_device_buffer(host, device="cpu") as b:
        b.view().add_(5)
    np.testing.assert_array_equal(host, [0, 0, 0])
    with core.make_writeback_temporary_device_buffer(host, device="cpu") as b:
        b.view().add_(5)
    np.testing.assert_array_equal(host, [5, 5, 5])


def test_compilation_cache_names_and_moves_the_build_dir(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    assert compilation_cache.enable_compilation_cache() == str(
        _build.BUILD_DIR)
    mine = tmp_path / "kernels"
    assert compilation_cache.enable_compilation_cache(str(mine)) == str(mine)
    assert mine.is_dir() and _build.BUILD_DIR == mine
    assert _build._library_path("fused_knn").parent == mine
    assert compilation_cache.enable_compilation_cache() == str(mine)


def test_synchronize_polls_at_most_the_interval():
    t0 = time.perf_counter()
    core.synchronize(torch.ones(2), poll_interval=0.01)
    assert time.perf_counter() - t0 < 1.0
