"""Opt-in runtime value checking: the sanitizer layer.

Port of ``raft_tpu/core/checks.py``. The reference functionalizes its
checks with ``jax.experimental.checkify``; the port runs eagerly, so its
checks are a ``torch.overrides.TorchFunctionMode`` active inside
:func:`checked` and :func:`debug_nan_guard`. Under it every torch call is
checked:

* index checks, before the op runs: an integer index tensor of
  ``x[i]`` / ``x[i] = v``, ``index_select``, ``gather``, ``take`` or
  ``take_along_dim`` with an entry out of range raises
  :class:`CheckError` (on the card the op itself would end in a device
  assert, which poisons the CUDA context);
* division checks, before the op runs: an integer division or remainder
  by a zero tensor entry raises;
* NaN checks, after the op: a floating output that holds a NaN raises,
  naming "nan" and the op.

Each check reads its tensor on the host, so a checked call synchronises
with the card at every op: a debugging tool, not a serving mode.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, FrozenSet, Iterable, Optional

import torch
from torch.overrides import TorchFunctionMode

from raft_tpu_torch.core.error import RaftError

#: The check kinds of :func:`checked` (the reference's checkify sets;
#: :func:`check` raises at once, so user checks need no kind).
FLOAT_CHECKS = frozenset({"nan"})
INDEX_CHECKS = frozenset({"index"})
DIV_CHECKS = frozenset({"div"})
ALL_CHECKS = FLOAT_CHECKS | INDEX_CHECKS | DIV_CHECKS


class CheckError(RaftError):
    """A runtime check failed (a NaN, an index out of range, an integer
    division by zero, or :func:`check`)."""


_GETITEM = {torch.Tensor.__getitem__, torch.Tensor.__setitem__}
_DIM_INDEX = {torch.index_select, torch.Tensor.index_select, torch.gather,
              torch.Tensor.gather, torch.take_along_dim,
              torch.Tensor.take_along_dim}
_FLAT_INDEX = {torch.take, torch.Tensor.take}
_INT_DIV = {torch.floor_divide, torch.Tensor.floor_divide,
            torch.Tensor.__floordiv__, torch.remainder, torch.Tensor.remainder,
            torch.Tensor.__mod__, torch.fmod, torch.Tensor.fmod}
_DIV = {torch.div, torch.Tensor.div}


def _is_index(t) -> bool:
    return (isinstance(t, torch.Tensor) and not t.is_floating_point()
            and t.dtype != torch.bool and t.numel() > 0)


def _in_range(name: str, idx: torch.Tensor, size: int, negative: bool):
    lo, hi = int(idx.min()), int(idx.max())
    if hi >= size or lo < (-size if negative else 0):
        raise CheckError(f"{name}: index out of range: [{lo}, {hi}] against "
                         f"a dimension of {size}")


def _check_getitem(x: torch.Tensor, key) -> None:
    items = key if isinstance(key, tuple) else (key,)
    consuming = [it for it in items if it is not None and it is not Ellipsis]
    n_used = sum(it.ndim if isinstance(it, torch.Tensor)
                 and it.dtype == torch.bool else 1 for it in consuming)
    dim = 0
    for it in items:
        if it is None:
            continue
        if it is Ellipsis:
            dim += x.ndim - n_used
            continue
        if _is_index(it) and dim < x.ndim:
            _in_range("index", it, x.shape[dim], negative=True)
        dim += (it.ndim if isinstance(it, torch.Tensor)
                and it.dtype == torch.bool else 1)


def _check_indices(func, args, kwargs) -> None:
    if func in _GETITEM and len(args) >= 2:
        _check_getitem(args[0], args[1])
    elif func in _DIM_INDEX:
        x = args[0]
        dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
        idx = kwargs.get("index", kwargs.get("indices",
                                             args[2] if len(args) > 2
                                             else None))
        if func in (torch.take_along_dim, torch.Tensor.take_along_dim):
            idx = args[1] if len(args) > 1 else kwargs.get("indices")
            dim = args[2] if len(args) > 2 else kwargs.get("dim")
            if dim is None:
                x = x.reshape(-1)
                dim = 0
        if _is_index(idx) and isinstance(dim, int):
            _in_range(func.__name__, idx, x.shape[dim], negative=False)
    elif func in _FLAT_INDEX:
        idx = args[1] if len(args) > 1 else kwargs.get("index")
        if _is_index(idx):
            _in_range("take", idx, args[0].numel(), negative=True)


def _check_div(func, args, kwargs) -> None:
    """An integer division (``//``, ``%``, ``fmod``, ``div`` with a
    rounding mode) whose divisor holds a zero."""
    if len(args) < 2 or not (func in _INT_DIV or (
            func in _DIV and kwargs.get("rounding_mode") is not None)):
        return
    a, b = args[0], args[1]
    if isinstance(a, float) or (isinstance(a, torch.Tensor)
                                and (a.is_floating_point() or a.is_complex())):
        return
    if isinstance(b, torch.Tensor):
        zero = (not b.is_floating_point() and not b.is_complex()
                and bool((b == 0).any()))
    else:
        zero = isinstance(b, int) and b == 0
    if zero:
        raise CheckError(f"{func.__name__}: integer division by zero")


def _outputs(out) -> Iterable[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _outputs(o)


class _CheckMode(TorchFunctionMode):
    def __init__(self, kinds: FrozenSet[str]):
        super().__init__()
        self.kinds = kinds

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "index" in self.kinds:
            _check_indices(func, args, kwargs)
        if "div" in self.kinds:
            _check_div(func, args, kwargs)
        out = func(*args, **kwargs)
        if "nan" in self.kinds:
            for t in _outputs(out):
                if (t.is_floating_point() or t.is_complex()) and t.numel() \
                        and bool(torch.isnan(t).any()):
                    raise CheckError(
                        f"nan in the output of {getattr(func, '__name__', func)}")
        return out


def checked(fn: Callable, errors: Optional[FrozenSet[str]] = None
            ) -> Callable:
    """``fn`` with the checks of ``errors`` (default: all of
    :data:`ALL_CHECKS`) active over each call; a failed check raises
    :class:`CheckError`."""
    kinds = ALL_CHECKS if errors is None else frozenset(errors)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _CheckMode(kinds):
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def debug_nan_guard(enable: bool = True):
    """A scope in which any op whose floating output holds a NaN raises
    :class:`CheckError` (the reference's ``jax_debug_nans``)."""
    if not enable:
        yield
        return
    with _CheckMode(FLOAT_CHECKS):
        yield


def check(pred, msg: str, **fmt) -> None:
    """Raise :class:`CheckError` at once when ``pred`` (a bool or a
    one-element tensor) is false; ``msg`` is formatted with ``fmt``."""
    if not bool(pred):
        raise CheckError(msg.format(**fmt) if fmt else msg)
