"""The sanitizer layer (core/checks.py) of raft_tpu_torch against
raft_tpu's.

Mirrors tests/test_checks.py: the reference's four cases hold in the
port, on the same inputs, and each raises in both packages or in
neither. The port's checks are eager (a TorchFunctionMode), so the further
cases pin what that mode sees: index checks before the op, integer
division by zero, NaN outputs under ``debug_nan_guard``, and the error
sets of ``checked(errors=)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import checks as jchecks
from raft_tpu_torch.core import checks
from raft_tpu_torch.core.checks import CheckError, check, checked
from raft_tpu_torch.core.error import RaftError


def test_checked_passes_clean_fn():
    out = checked(lambda x: torch.sqrt(x) + 1.0)(torch.tensor([1.0, 4.0]))
    jout = jchecks.checked(lambda x: jnp.sqrt(x) + 1.0)(
        jnp.asarray([1.0, 4.0]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_checked_raises_on_nan():
    with pytest.raises(CheckError, match="nan"):
        checked(lambda x: torch.log(x))(torch.tensor([-1.0]))
    with pytest.raises(Exception, match="nan"):
        jchecks.checked(lambda x: jnp.log(x))(jnp.asarray([-1.0]))


def test_checked_raises_on_oob_index():
    with pytest.raises(CheckError, match="out of range"):
        checked(lambda x, i: x[i])(torch.arange(4.0), torch.tensor(10))
    with pytest.raises(Exception):
        jchecks.checked(lambda x, i: x[i])(jnp.arange(4.0), jnp.asarray(10))


def test_explicit_check_surfaces():
    @checked
    def fn(x):
        check(torch.all(x > 0), "x must be positive")
        return x * 2.0

    @jchecks.checked
    def jfn(x):
        jchecks.check(jnp.all(x > 0), "x must be positive")
        return x * 2.0

    assert float(fn(torch.tensor([1.0]))[0]) == float(jfn(jnp.asarray(
        [1.0]))[0])
    with pytest.raises(CheckError, match="positive"):
        fn(torch.tensor([-3.0]))
    with pytest.raises(Exception, match="positive"):
        jfn(jnp.asarray([-3.0]))


def test_check_formats_and_is_a_raft_error():
    with pytest.raises(RaftError, match="got 3 rows"):
        check(False, "got {n} rows", n=3)
    check(torch.tensor(True), "fine")


@pytest.mark.parametrize("call", [
    lambda x, i: x[i],                              # negative in range
    lambda x, i: x[..., i],
    lambda x, i: x[None, i],
    lambda x, i: torch.index_select(x, 0, i.abs()),
    lambda x, i: torch.gather(x, 0, i.abs()),
    lambda x, i: x.take(i),
], ids=["neg", "ellipsis", "none", "index_select", "gather", "take"])
def test_in_range_indices_pass(call):
    x = torch.arange(6.0)
    i = torch.tensor([-1, 0, 5])
    assert torch.equal(checked(call)(x, i), call(x, i))


def _setitem(x, i):
    x[i] = 1.0


@pytest.mark.parametrize("call", [
    lambda x: x[torch.tensor([0, 6])],
    lambda x: x[torch.tensor([-7])],
    lambda x: x.reshape(2, 3)[:, torch.tensor([3])],
    lambda x: x.reshape(2, 3)[torch.tensor([1]), torch.tensor([3])],
    lambda x: torch.index_select(x, 0, torch.tensor([6])),
    lambda x: torch.gather(x, 0, torch.tensor([-1])),
    lambda x: x.take(torch.tensor([6])),
    lambda x: torch.take_along_dim(x.reshape(2, 3), torch.tensor([[3]]), 1),
    lambda x: _setitem(x, torch.tensor([9])),
], ids=["getitem", "negative", "column", "pair", "index_select", "gather",
        "take", "take_along_dim", "setitem"])
def test_out_of_range_indices_raise_before_the_op(call):
    with pytest.raises(CheckError, match="out of range"):
        checked(call)(torch.arange(6.0))


@pytest.mark.parametrize("call", [
    lambda a, b: a // b, lambda a, b: a % b, lambda a, b: torch.fmod(a, b),
    lambda a, b: torch.div(a, b, rounding_mode="trunc"),
], ids=["floordiv", "mod", "fmod", "div_trunc"])
def test_integer_division_by_zero_raises(call):
    a, b = torch.tensor([4, 5]), torch.tensor([2, 0])
    with pytest.raises(CheckError, match="division by zero"):
        checked(call)(a, b)
    # Float division is left to the NaN check: 1/0 is inf, not an error.
    assert torch.isinf(checked(lambda p, q: p / q)(a.float(), b.float()))[1]


def test_errors_select_the_checks():
    log_neg = lambda x: torch.log(x)        # noqa: E731
    assert torch.isnan(checked(log_neg, errors=checks.INDEX_CHECKS)(
        torch.tensor([-1.0])))[0]
    with pytest.raises(IndexError):        # torch's own check on the CPU
        checked(lambda x: x[torch.tensor(5)], errors=checks.FLOAT_CHECKS)(
            torch.arange(3.0))
    assert checks.ALL_CHECKS == (checks.FLOAT_CHECKS | checks.INDEX_CHECKS
                                 | checks.DIV_CHECKS)


def test_debug_nan_guard_scopes_the_nan_check():
    zero = torch.tensor([0.0])
    with checks.debug_nan_guard():
        with pytest.raises(CheckError, match="nan"):
            zero / zero
    assert torch.isnan(zero / zero)[0]           # off again
    with checks.debug_nan_guard(False):
        assert torch.isnan(zero / zero)[0]
    prev = jax.config.jax_debug_nans
    with jchecks.debug_nan_guard():
        with pytest.raises(Exception):
            jnp.asarray([0.0]) / jnp.asarray([0.0])
    assert jax.config.jax_debug_nans == prev
