"""The streaming select (kStream, kernel B5's plain version) of
raft_tpu_torch against raft_tpu's.

A pure selection has no rounding, so everything here must agree bit for
bit (NaN where NaN): the extract's candidate arrays against the
reference's ``extract_m_rows`` on the same 512-position sub-chunk rows,
and ``select_k(method=kStream)`` against the reference's kStream (its
Pallas sweep in interpret mode) and against ``kTopK``. Shapes stay small
(len 8192-24576, batch 8-16, k 64) because the reference interprets its
kernel on the CPU.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.matrix.select_k import SelectMethod as JMethod
from raft_tpu.matrix.select_k import extract_m_rows as jextract
from raft_tpu.matrix.select_k import select_k as jselect_k
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.matrix.select_k import SelectMethod, select_k
from raft_tpu_torch.ops import stream_select as ss
from test_torch_common import n, t

sk = importlib.import_module("raft_tpu_torch.matrix.select_k")

_DTYPES = {"f32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16),
           "f16": (torch.float16, jnp.float16)}


def _same_bits(xt, jdt):
    """The reference's copy of a torch tensor, bit for bit (PyTorch casts
    NaN to bf16 as 0xFFFF, a negative NaN; numpy casts it to +NaN)."""
    if xt.dtype == torch.float32:
        return n(xt)
    return n(xt.view(torch.int16)).view(jdt)


def _ref_candidates(keys):
    """The reference's candidate block: keys padded with +inf to a
    multiple of 8192, one ``extract_m_rows`` call over every 512-position
    sub-chunk row."""
    batch, length = keys.shape
    n_pad = -(-length // 8192) * 8192
    nc = n_pad // 512
    w = np.full((batch, n_pad), np.inf, np.float32)
    w[:, :length] = keys
    ids = (np.arange(batch * nc)[:, None] % nc * 512
           + np.arange(512)).astype(np.int32)
    _, v, i = jextract(jnp.asarray(w.reshape(batch * nc, 512)),
                       jnp.asarray(ids),
                       8, jnp.full((batch * nc, 8), jnp.inf, jnp.float32),
                       jnp.full((batch * nc, 8), -1, jnp.int32))
    return n(v).reshape(batch, nc * 8), n(i).reshape(batch, nc * 8)


def _rows(kind, rng, batch=6, length=8192):
    if kind == "gauss":
        return rng.standard_normal((batch, length)).astype(np.float32)
    if kind == "int_ties":
        return rng.integers(0, 3, (batch, length)).astype(np.float32)
    if kind == "starved":
        x = rng.standard_normal((batch, length)).astype(np.float32)
        x[rng.random((batch, length)) < 0.995] = np.inf
        return x
    if kind == "nan":
        x = rng.standard_normal((batch, length)).astype(np.float32)
        x[1, 700] = np.nan
        x[4, 5:9] = np.nan
        return x
    if kind == "inf_heavy":
        x = rng.integers(0, 5, (batch, length)).astype(np.float32)
        x[0, :3000] = -np.inf
        x[2, 100:] = np.inf
        return x
    if kind == "ragged":
        return rng.standard_normal((batch, 10000)).astype(np.float32)
    if kind.startswith("ties_"):
        # C keys at one value in every sub-chunk, the rest above it: the
        # counts on each side of the kernel's 32-survivor list.
        x = 5 + rng.random((batch, length)).astype(np.float32)
        subs = x.reshape(batch, -1, 512)
        for r in range(batch):
            for s in range(subs.shape[1]):
                subs[r, s, rng.permutation(512)[:int(kind[5:])]] = 1.0
        return x
    if kind == "zeros":
        x = rng.standard_normal((batch, length)).astype(np.float32)
        x[rng.random((batch, length)) < 0.02] = 0.0
        x[rng.random((batch, length)) < 0.02] = -0.0
        return x
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["gauss", "int_ties", "starved", "nan",
                                  "inf_heavy", "ragged", "ties_8", "ties_9",
                                  "ties_32", "ties_33", "ties_512", "zeros"])
def test_plain_extract_matches_reference(rng, kind):
    x = _rows(kind, rng)
    v, i = ss.stream_extract(t(x))
    jv, ji = _ref_candidates(x)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert v.shape == (x.shape[0], ss.n_candidates(x.shape[1]))
    np.testing.assert_array_equal(n(v), jv)
    np.testing.assert_array_equal(n(i), ji)


@pytest.mark.parametrize("first,second", [(0.0, -0.0), (-0.0, 0.0)])
def test_plain_extract_writes_the_keys_own_zero(first, second):
    """-0 and +0 tie, so the lower position comes first, and each extract
    is the key at its position, sign included (the reference writes
    ``jnp.min``'s zero for both)."""
    x = np.full((1, 8192), 3.0, np.float32)
    x[0, 3], x[0, 5] = first, second
    v, i = (n(a) for a in ss.stream_extract(t(x)))
    np.testing.assert_array_equal(i[0, :3], [3, 5, 0])
    np.testing.assert_array_equal(np.signbit(v[0, :2]),
                                  np.signbit([first, second]))


def test_extract_signatures(rng):
    """Starved sub-chunks repeat (inf, first position); NaN sub-chunks give
    (NaN, INT32_MAX) on every pass."""
    x = np.full((1, 8192), np.inf, np.float32)
    x[0, 515] = 1.0
    x[0, 1500] = np.nan
    v, i = (n(a) for a in ss.stream_extract(t(x)))
    assert v[0, 8] == 1.0 and i[0, 8] == 515
    assert np.isinf(v[0, 9:16]).all() and (i[0, 9:16] == 512).all()
    assert np.isnan(v[0, 16:24]).all() and (i[0, 16:24] == ss.I32MAX).all()
    assert (i[0, :8] == 0).all()


@pytest.mark.parametrize("lane_base", [0, 8])
def test_extract_core_matches_reference(rng, lane_base):
    w = rng.integers(0, 4, (9, 512)).astype(np.float32)
    w[2, :] = np.inf
    w[5, 3] = np.nan
    ids = np.tile(np.arange(512, dtype=np.int32) + 1024, (9, 1))
    out_v = np.full((9, 16), np.inf, np.float32)
    out_i = np.full((9, 16), -1, np.int32)
    rw, v, i = ss.extract_m_rows(t(w), t(ids), 8, t(out_v), t(out_i),
                                 lane_base)
    jw, jv, ji = jextract(jnp.asarray(w), jnp.asarray(ids), 8,
                          jnp.asarray(out_v), jnp.asarray(out_i), lane_base)
    np.testing.assert_array_equal(n(v), n(jv))
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(rw), n(jw))


def _batch(kind, rng, batch=16, length=24576):
    x = rng.standard_normal((batch, length)).astype(np.float32)
    if kind == "patch":            # <= 8 audit failures: per-row repair
        x[1] = np.sort(x[1])
        x[2] = np.sort(x[2])[::-1]
        x[3] = 2.5
        x[4, :5000] = -np.inf
        x[5, 1000:] = np.inf
        x[6, 77] = np.nan
    elif kind == "fallback":       # every row sorted: whole-batch sort
        x = np.sort(x, axis=1)
    elif kind == "constant":
        x[:] = 1.5
    return x


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("kind", ["gauss", "patch", "fallback", "constant"])
def test_kstream_matches_reference(rng, dtype, select_min, kind):
    x = _batch(kind, rng)
    tdt, jdt = _DTYPES[dtype]
    xt = t(x).to(tdt)
    v, i = select_k(xt, 64, select_min, method=SelectMethod.kStream)
    jv, ji = jselect_k(_same_bits(xt, jdt), 64, select_min,
                       method=JMethod.kStream)
    tv, ti = select_k(xt, 64, select_min, method=SelectMethod.kTopK)
    assert v.dtype == tdt and i.dtype == torch.int32
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(v.float()), n(jv).astype(np.float32))
    np.testing.assert_array_equal(n(i), n(ti))
    np.testing.assert_array_equal(n(v.float()), n(tv.float()))


@pytest.mark.parametrize("batch,length", [(8, 8192), (13, 10000)])
def test_kstream_small_and_ragged(rng, batch, length):
    x = rng.integers(0, 50, (batch, length)).astype(np.float32)
    v, i = select_k(t(x), 64, method=SelectMethod.kStream)
    jv, ji = jselect_k(x, 64, method=JMethod.kStream)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(n(v), n(jv))


def test_kstream_nan_rows_match_reference_edge_cases(rng):
    """The reference's own NaN cases (tests/test_edge_cases.py): a NaN row
    is sent to the exact sort and ranks NaN where kTopK does, in both
    packages and both polarities."""
    x = rng.standard_normal((8, 16384)).astype(np.float32)
    x[3, 100] = np.nan
    for select_min in (True, False):
        v, i = select_k(t(x), 64, select_min, method=SelectMethod.kStream)
        jv, ji = jselect_k(x, 64, select_min, method=JMethod.kStream)
        jtv, jti = jselect_k(x, 64, select_min, method=JMethod.kTopK)
        tv, ti = select_k(t(x), 64, select_min, method=SelectMethod.kTopK)
        np.testing.assert_array_equal(n(i), n(ji))
        np.testing.assert_array_equal(n(ti), n(jti))
        np.testing.assert_array_equal(n(v), n(jv))
        np.testing.assert_array_equal(n(tv), n(jtv))


def test_kstream_audit_counts_the_bad_rows(rng, monkeypatch):
    """One sorted row is repaired alone: the exact sort sees that row
    only; nine bad rows (> 8) sort the whole batch. (At len 65536 a random
    row keeps its top 64 in 128 sub-chunks and passes the audit.)"""
    seen = []
    real = sk.stable_top_k

    def spy(values, k, select_min=True):
        seen.append(values.shape[0])
        return real(values, k, select_min)

    monkeypatch.setattr(sk, "stable_top_k", spy)
    x = rng.standard_normal((16, 65536)).astype(np.float32)
    x[7] = np.sort(x[7])
    sk._stream_top_k(t(x), 64, True)
    assert seen == [16, 1]              # rank of the candidates, then row 7
    seen.clear()
    x[:9] = np.sort(x[:9], axis=1)
    sk._stream_top_k(t(x), 64, True)
    assert seen == [16, 16]


def test_kstream_with_payload_indices(rng):
    x = rng.standard_normal((8, 9000)).astype(np.float32)
    payload = rng.permutation(10 ** 6)[:9000].astype(np.int32)
    _, i = select_k(t(x), 64, indices=t(payload), method=SelectMethod.kStream)
    _, ji = jselect_k(x, 64, indices=payload, method=JMethod.kStream)
    np.testing.assert_array_equal(n(i), n(ji))


@pytest.mark.parametrize("args,match", [
    ((np.zeros((2, 9000), np.float32), 257), "k <= 256"),
    ((np.zeros((2, 9000), np.int32), 64), "f32/bf16/f16"),
    ((np.zeros((2, 1000), np.float32), 200), "candidates >= k"),
])
def test_kstream_explicit_request_errors(args, match):
    x, k = args
    with pytest.raises(LogicError, match=match):
        select_k(t(x), k, method=SelectMethod.kStream)
    with pytest.raises(Exception, match=match):
        jselect_k(x, k, method=JMethod.kStream)


def test_kstream_refuses_f64():
    """The reference runs with x64 off, so f64 never reaches its check;
    the port keeps f64 tensors and refuses them."""
    with pytest.raises(LogicError, match="f32/bf16/f16"):
        select_k(torch.zeros((2, 9000), dtype=torch.float64), 64,
                 method=SelectMethod.kStream)


_CUDA = torch.device("cuda")
_CPU = torch.device("cpu")


@pytest.mark.parametrize("batch,length,k,dtype,device,expected", [
    (8, 65536, 64, torch.float32, _CUDA, True),
    (64, 131072, 128, torch.float32, _CUDA, True),
    (1024, 262144, 256, torch.float32, _CUDA, True),
    (8, 65536, 64, torch.bfloat16, _CUDA, True),
    (8, 65536, 64, torch.float16, _CUDA, True),
    (7, 65536, 64, torch.float32, _CUDA, False),
    (8, 65535, 64, torch.float32, _CUDA, False),
    (8, 65536, 63, torch.float32, _CUDA, False),
    (8, 65536, 257, torch.float32, _CUDA, False),
    (1000, 10000, 10, torch.float32, _CUDA, False),
    (8, 65536, 64, torch.int32, _CUDA, False),
    (8, 65536, 64, torch.float64, _CUDA, False),
    (8, 65536, 64, torch.float32, _CPU, False),
    (64, 131072, 128, torch.float32, _CPU, False),
])
def test_kauto_gate(batch, length, k, dtype, device, expected):
    assert sk._stream_supported(batch, length, k, dtype, device) is expected


def test_kauto_on_cpu_is_the_stable_sort(rng, monkeypatch):
    def no_stream(*a, **kw):
        raise AssertionError("kAuto took kStream on the CPU")

    monkeypatch.setattr(sk, "_stream_top_k", no_stream)
    x = rng.standard_normal((8, 65536)).astype(np.float32)
    v, i = select_k(t(x), 64)
    tv, ti = select_k(t(x), 64, method=SelectMethod.kTopK)
    np.testing.assert_array_equal(n(i), n(ti))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("method", [SelectMethod.kTopK, SelectMethod.kStream])
def test_nan_signs_and_signed_zeros_follow_lax_top_k(dtype, select_min,
                                                     method):
    """lax.top_k orders floats by the total order of their bits: a negative
    NaN below -inf, -0 below +0. The port sorts on the same integer keys
    (``order_key``), so it agrees on the CPU and on the card alike."""
    tdt, jdt = _DTYPES[dtype]
    row = torch.tensor([0.0, -0.0, 1.0, float("nan"), -1.0, float("-inf"),
                        float("inf"), 0.0, -0.0, 2.0])
    row[4] = -row[3]                                   # a negative NaN
    x = torch.full((8, 9000), 5.0)
    x[:, :10] = row
    xt = x.to(tdt)
    k = 64 if method == SelectMethod.kStream else 10
    v, i = select_k(xt, k, select_min, method=method)
    jv, ji = jselect_k(_same_bits(xt, jdt), k, select_min,
                       method=JMethod.kTopK)
    np.testing.assert_array_equal(n(i), n(ji))
    # Values: the same NaN and zero signs (XLA may rewrite a NaN payload).
    pv, rv = n(v.float()), n(jv).astype(np.float32)
    np.testing.assert_array_equal(np.signbit(pv), np.signbit(rv))
    np.testing.assert_array_equal(pv, rv)


@pytest.mark.parametrize("select_min", [True, False])
def test_kstream_signed_zeros_follow_lax_top_k_not_the_reference_kstream(
        rng, select_min):
    """+0 at position 3 and -0 at 5 (mirrored for a max-selection) among
    the k best, no NaN, and no row flagged by the audit, so the candidates
    decide the answer: the port's kStream gives lax.top_k's order [5, 3]
    (-0 below +0). The reference's kStream gives [3, 5]: its extract
    writes ``jnp.min``'s zero for both (ROADMAP C.2)."""
    x = (5 + rng.standard_normal((8, 65536))).astype(np.float32)
    x[:, 3], x[:, 5] = 0.0, -0.0
    if not select_min:
        x = -x
    keys = t(x) if select_min else -t(x)
    cand_v, _ = ss.stream_extract(keys)
    assert not sk._audit_failures(cand_v,
                                  sk.stable_top_k(cand_v, 64)[0]).any()
    v, i = select_k(t(x), 64, select_min, method=SelectMethod.kStream)
    jv, ji = jselect_k(x, 64, select_min, method=JMethod.kTopK)
    np.testing.assert_array_equal(n(i), n(ji))
    np.testing.assert_array_equal(np.signbit(n(v)), np.signbit(n(jv)))
    np.testing.assert_array_equal(n(v), n(jv))
    assert (n(i)[:, :2] == [5, 3]).all()
    _, ri = jselect_k(x, 64, select_min, method=JMethod.kStream)
    assert (n(ri)[:, :2] == [3, 5]).all()
