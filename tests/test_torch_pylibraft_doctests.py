"""Run the docstring examples of pylibraft_torch and raft_dask_torch.

Modelled on tests/test_doctests.py. The examples are pylibraft's, each
with an explicit ``handle=DeviceResources(device="cpu")``: the facades
run on ``cuda`` unless the caller asks for the CPU.
"""

import doctest
import importlib
import pkgutil

import pytest

import pylibraft
import pylibraft_torch
import raft_dask_torch

_IMPORT_ERRORS = []

_MODULES = sorted(
    m.name
    for pkg in (pylibraft_torch, raft_dask_torch)
    for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + ".",
                                   onerror=_IMPORT_ERRORS.append)
    if not m.ispkg
)


def _examples(mod) -> int:
    return sum(len(t.examples) for t in doctest.DocTestFinder().find(mod))


def test_all_packages_walkable():
    """A broken subpackage must fail loudly, not silently drop its modules
    from the grid."""
    assert not _IMPORT_ERRORS, f"unimportable packages: {_IMPORT_ERRORS}"
    assert len(_MODULES) >= 18  # current module count; shrink = lost coverage


@pytest.mark.parametrize("modname", _MODULES)
def test_module_doctests(modname):
    mod = importlib.import_module(modname)
    results = doctest.testmod(mod, verbose=False)
    assert results.failed == 0, f"{results.failed} doctest failures in {modname}"


def test_the_reference_examples_are_carried_over():
    """Each pylibraft module with examples has its counterpart's."""
    for m in pkgutil.walk_packages(pylibraft.__path__, prefix="pylibraft."):
        if m.ispkg:
            continue
        ref = importlib.import_module(m.name)
        port = importlib.import_module("pylibraft_torch" + m.name[len(
            "pylibraft"):])
        assert _examples(port) >= _examples(ref), m.name
