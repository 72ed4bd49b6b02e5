"""The port's package surface against raft_tpu's.

For every package of ``raft_tpu``, each name of its ``__all__`` resolves
in the port's package of the same path, unless the module that defines it
waits for a later slice of ROADMAP A.6: those names, modules and packages
are listed below with that slice's letter, and the test asserts that they
are still missing, so a slice that ports one must move it out of the list.
The port's ``__all__`` holds the reference's less its pending names (the
port's own additions, such as its mesh, may stand beside them).

The facades ``pylibraft`` and ``raft_dask`` have theirs in
``pylibraft_torch`` and ``raft_dask_torch``: module for module, with the
reference's ``__all__`` in each package.
"""

import importlib
import pkgutil

import pytest

import pylibraft
import raft_dask
import raft_tpu

# Packages of raft_tpu with no counterpart yet, by slice (none left).
PENDING_PACKAGES = {}

# Modules of ported packages that wait for a slice (none left).
PENDING_MODULES = {}

# Names of ported packages that wait for a slice, by package (none left).
PENDING_NAMES = {}

# JAX plumbing with no counterpart by design (ROADMAP A): not in any
# __all__, listed so the module walk below knows them.
NOT_PORTED = {"raft_tpu.util.pallas_compat", "raft_tpu.util.shard_map_compat"}

# The reference builds its host runtime into its own package directory,
# where the module walk finds it as an extension module once it exists;
# the port builds its copy under build/ instead.
BUILT_LIBRARIES = {"raft_tpu._native.libraft_tpu_host"}

# Every slice of ROADMAP A.6 is ported (j, the facades, last), so no
# pending entry may name one.
SLICES = set()

_REF_MODULES = sorted(m.name for m in pkgutil.walk_packages(
    raft_tpu.__path__, prefix="raft_tpu."))
_REF_PACKAGES = ["raft_tpu"] + sorted(
    m.name for m in pkgutil.walk_packages(raft_tpu.__path__,
                                          prefix="raft_tpu.") if m.ispkg)


_FACADES = (pylibraft, raft_dask)
_FACADE_MODULES = sorted(
    m.name for pkg in _FACADES
    for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + "."))
_FACADE_PACKAGES = [pkg.__name__ for pkg in _FACADES] + sorted(
    m.name for pkg in _FACADES
    for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + ".")
    if m.ispkg)


def _port_name(ref: str) -> str:
    top, _, rest = ref.partition(".")
    return top + "_torch" + ("." + rest if rest else "")


def _import(name):
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as err:
        if err.name is not None and name.startswith(err.name):
            return None
        raise


def test_pending_lists_name_slices_still_to_come():
    for table in (PENDING_PACKAGES, PENDING_MODULES):
        assert set(table.values()) <= SLICES
    for names in PENDING_NAMES.values():
        assert set(names.values()) <= SLICES
    for name in list(PENDING_PACKAGES) + list(PENDING_MODULES):
        assert name in _REF_MODULES, name


@pytest.mark.parametrize("ref_name", _REF_MODULES)
def test_every_reference_module_has_a_port_or_a_slice(ref_name):
    """Each module of raft_tpu exists in the port, or waits for the slice
    listed (in a pending package or as a pending module)."""
    pending = ref_name in PENDING_MODULES or any(
        ref_name == p or ref_name.startswith(p + ".")
        for p in PENDING_PACKAGES)
    if ref_name in NOT_PORTED or ref_name in BUILT_LIBRARIES:
        assert _import(_port_name(ref_name)) is None
        return
    port = _import(_port_name(ref_name))
    if pending:
        assert port is None, (
            f"{_port_name(ref_name)} exists now: take {ref_name} out of "
            "the pending lists")
    else:
        assert port is not None, f"{_port_name(ref_name)} is missing"


@pytest.mark.parametrize("ref_name", _REF_PACKAGES)
def test_package_all_resolves_in_the_port(ref_name):
    if ref_name in PENDING_PACKAGES:
        assert _import(_port_name(ref_name)) is None
        return
    ref = importlib.import_module(ref_name)
    port = importlib.import_module(_port_name(ref_name))
    names = list(getattr(ref, "__all__", []))
    pending = PENDING_NAMES.get(ref_name, {})
    assert set(pending) <= set(names)
    for name in names:
        if name in pending:
            assert not hasattr(port, name), (
                f"{_port_name(ref_name)}.{name} resolves now: take it out "
                "of PENDING_NAMES")
            continue
        assert hasattr(port, name), f"{_port_name(ref_name)}.{name}"
        ref_obj, obj = getattr(ref, name), getattr(port, name)
        # A module stays a module, a class a class, a function a callable.
        assert type(obj).__name__ == type(ref_obj).__name__ or (
            callable(ref_obj) and callable(obj)), name
    # The port may export more (its own mesh, for one), never less.
    assert set(names) - set(pending) <= set(getattr(port, "__all__", []))


def test_facade_walk_finds_both_facades():
    assert len(_FACADE_MODULES) == 24
    assert {"pylibraft.neighbors.ivf_pq", "raft_dask.common.comms_utils"} \
        <= set(_FACADE_MODULES)


@pytest.mark.parametrize("ref_name", _FACADE_MODULES)
def test_every_facade_module_has_a_port(ref_name):
    assert _import(_port_name(ref_name)) is not None, (
        f"{_port_name(ref_name)} is missing")


@pytest.mark.parametrize("ref_name", _FACADE_PACKAGES)
def test_facade_all_resolves_in_the_port(ref_name):
    """The facade packages export exactly the reference's names."""
    ref = importlib.import_module(ref_name)
    port = importlib.import_module(_port_name(ref_name))
    names = list(getattr(ref, "__all__", []))
    for name in names:
        assert hasattr(port, name), f"{_port_name(ref_name)}.{name}"
        ref_obj, obj = getattr(ref, name), getattr(port, name)
        assert type(obj).__name__ == type(ref_obj).__name__ or (
            callable(ref_obj) and callable(obj)), name
    assert names == list(getattr(port, "__all__", []))
