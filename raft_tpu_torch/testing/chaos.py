"""Deterministic, seeded fault injection for comms and file-I/O call sites.

Port of ``raft_tpu/testing/chaos.py`` (host Python, so the port keeps its
own copy): wrap an eager call site, script faults at exact call indexes,
and the failure sequence replays bit for bit on every run: no wall
clock, no unseeded randomness.

Six fault kinds (the failure modes of the sharded serving story):

* ``"raise"``: the call site raises :class:`InjectedFault` (or a
  caller-supplied exception factory): a lost transfer or I/O error.
* ``"corrupt"``: the call runs, but its payload result is corrupted by
  a seeded numpy generator (additive noise on float arrays, values
  scrambled on int arrays): a torn read. The same seed, script and call
  sequence give the same bytes in both packages.
* ``"drop_rank"``: a scripted rank is marked dead in a
  :class:`~raft_tpu_torch.comms.health.ShardHealth` registry: a host
  loss, feeding the degraded-serving path.
* ``"torn_write"``: a :meth:`ChaosMonkey.wrap_write` byte-write site
  writes only the first ``offset`` bytes of its payload, then raises:
  the on-disk state a power loss mid-``write(2)`` leaves behind (the
  ``util/atomic_io.FileIO`` seam; ``lifecycle/wal.py`` log appends).
* ``"partial_rename"``: a :meth:`ChaosMonkey.wrap_rename` rename site
  raises WITHOUT renaming, leaving the ``.tmp`` file orphaned: a kill
  between a multi-file save's renames.
* ``"delay"``: the call runs after ``seconds`` of injected sleep
  (``ChaosMonkey(sleep=...)``, a test's fake clock, so the straggler is
  deterministic): the slow shard. ``at=None`` scripts the fault at
  every call, and :meth:`ChaosMonkey.rank_hook` scopes the delay to the
  dispatches a scripted victim rank takes part in.

Over a ``torch.distributed`` job each rank holds its own monkey: a
fault scripted on one rank fires on that rank only, which is how the
port's tests exercise the agreement of one rank's failure
(``comms/agree.py``).

Usage::

    chaos = ChaosMonkey(seed=0)
    flaky_save = chaos.wrap("save", ivf_flat.save,
                            faults=[FaultSpec(kind="raise", at=(0, 1))])
    with_retry(lambda: flaky_save(path, index),
               RetryPolicy(max_attempts=3))
    assert chaos.calls("save") == 3   # failed, failed, succeeded
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch.core.error import RaftError, expects


class InjectedFault(RaftError, OSError):
    """A scripted fault from the chaos harness. Subclasses OSError so the
    default IO retry policies (``retry_on=(OSError, ...)``) treat it as
    transient without chaos-specific configuration."""


@dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: apply ``kind`` at the given 0-based call
    indexes of a wrapped site.

    ``at=None`` means every call index (a persistent fault — the shape
    a straggling shard takes); ``rank`` names the victim for
    ``"drop_rank"`` and the participation scope for ``"delay"`` under
    :meth:`ChaosMonkey.rank_hook`; ``error`` overrides the raised
    exception factory for ``"raise"`` (a callable returning an
    exception instance, so each attempt gets a fresh object and retry
    cause-chains stay acyclic); ``offset`` is the byte offset a
    ``"torn_write"`` truncates the payload at (clamped to the payload
    length; 0 = nothing written before the tear); ``seconds`` is the
    injected-clock sleep of a ``"delay"``.
    """

    kind: str = "raise"   # "raise" | "corrupt" | "drop_rank"
    #                     # | "torn_write" | "partial_rename" | "delay"
    at: Optional[Tuple[int, ...]] = (0,)
    rank: int = -1
    error: Optional[Callable[[], BaseException]] = None
    offset: int = -1
    seconds: float = 0.0

    def __post_init__(self):
        expects(self.kind in ("raise", "corrupt", "drop_rank",
                              "torn_write", "partial_rename", "delay"),
                "unknown fault kind %r", self.kind)
        if self.kind == "drop_rank":
            expects(self.rank >= 0, "drop_rank needs a victim rank")
        if self.kind == "torn_write":
            expects(self.offset >= 0,
                    "torn_write needs the byte offset to tear at")
        if self.kind == "delay":
            expects(self.seconds > 0.0,
                    "delay needs seconds > 0, got %s", self.seconds)


@dataclass
class _Site:
    faults: List[FaultSpec] = field(default_factory=list)
    calls: int = 0


class ChaosMonkey:
    """Deterministic fault injector over named call sites.

    Every wrapped site keeps its own call counter; faults fire when the
    counter hits a scripted index. Corruption noise comes from one
    ``np.random.default_rng(seed)`` stream consumed in call order, so a
    given (seed, script, call sequence) reproduces the exact same
    corrupted payloads every run.
    """

    def __init__(self, seed: int = 0, health=None, sleep=None):
        # ``health``: an optional ShardHealth (comms/health.py) that
        # "drop_rank" faults feed (kept untyped to avoid a hard import).
        # ``sleep``: the clock-advancing callable "delay" faults consume
        # (a test's fake clock's ``sleep`` — never wall time, or the
        # replayed schedule stops being bit-identical).
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.health = health
        self.sleep = sleep
        self._sites: Dict[str, _Site] = {}

    # -- scripting --------------------------------------------------------
    def script(self, site: str, faults: Sequence[FaultSpec]) -> None:
        """Attach fault specs to ``site`` (extends any existing script)."""
        self._sites.setdefault(site, _Site()).faults.extend(faults)

    def wrap(self, site: str, fn: Callable,
             faults: Optional[Sequence[FaultSpec]] = None) -> Callable:
        """Wrap ``fn`` as chaos site ``site``; optionally script faults in
        the same call. The wrapper consults the script before AND after
        the real call: "raise" faults pre-empt the call (the transfer
        never happened), "corrupt" faults mangle the returned payload,
        "drop_rank" fires before the call (the host died under it)."""
        if faults:
            self.script(site, faults)
        state = self._sites.setdefault(site, _Site())

        @functools.wraps(fn)
        def chaotic(*args, **kwargs):
            idx = state.calls
            state.calls += 1
            fault = self._fault_at(state, idx)
            expects(fault is None or fault.kind not in
                    ("torn_write", "partial_rename"),
                    "%r faults need the typed IO wrappers (wrap_write / "
                    "wrap_rename) — a generic call site has no byte "
                    "payload to tear", fault.kind if fault else "")
            if fault is not None and fault.kind == "drop_rank":
                expects(self.health is not None,
                        "drop_rank fault needs ChaosMonkey(health=...)")
                self.health.mark_dead(fault.rank)
                fault = None  # the call itself proceeds (degraded)
            if fault is not None and fault.kind == "raise":
                raise (fault.error() if fault.error is not None
                       else InjectedFault(
                           f"injected fault at {site}[{idx}]"))
            if fault is not None and fault.kind == "delay":
                self._sleep(fault, site, idx)   # straggle, then proceed
            out = fn(*args, **kwargs)
            if fault is not None and fault.kind == "corrupt":
                out = self.corrupt(out)
            return out

        return chaotic

    def wrap_write(self, site: str, fn: Optional[Callable] = None,
                   faults: Optional[Sequence[FaultSpec]] = None
                   ) -> Callable:
        """Wrap a ``write_bytes(f, data)``-shaped primitive (the
        :class:`raft_tpu_torch.util.atomic_io.FileIO` seam) as chaos site
        ``site``.  ``"torn_write"`` faults write ``data[:offset]``
        through the real primitive and then raise — the file holds a
        true prefix of the payload, exactly the state a power loss
        mid-write leaves.  ``"raise"`` faults pre-empt the write
        entirely.  Deterministic and replayable like :meth:`wrap`."""
        from raft_tpu_torch.util import atomic_io

        real = fn if fn is not None else atomic_io.DEFAULT_IO.write_bytes
        if faults:
            self.script(site, faults)
        state = self._sites.setdefault(site, _Site())

        def chaotic_write(f, data):
            idx = state.calls
            state.calls += 1
            fault = self._fault_at(state, idx)
            if fault is not None and fault.kind == "torn_write":
                real(f, bytes(data)[:fault.offset])
                f.flush()
                raise InjectedFault(
                    f"torn write at {site}[{idx}]: "
                    f"{min(fault.offset, len(data))}/{len(data)} bytes")
            if fault is not None and fault.kind == "raise":
                raise (fault.error() if fault.error is not None
                       else InjectedFault(
                           f"injected fault at {site}[{idx}]"))
            return real(f, data)

        return chaotic_write

    def wrap_rename(self, site: str, fn: Optional[Callable] = None,
                    faults: Optional[Sequence[FaultSpec]] = None
                    ) -> Callable:
        """Wrap a ``replace(src, dst)``-shaped primitive as chaos site
        ``site``.  ``"partial_rename"`` faults raise WITHOUT renaming
        (the ``.tmp`` stays orphaned, ``dst`` keeps its old content or
        stays absent) — the torn state of a kill between a multi-file
        publish's renames.  ``"raise"`` behaves identically here (the
        rename never happened) but keeps the generic retryable-error
        semantics."""
        import os as _os

        real = fn if fn is not None else _os.replace
        if faults:
            self.script(site, faults)
        state = self._sites.setdefault(site, _Site())

        def chaotic_rename(src, dst):
            idx = state.calls
            state.calls += 1
            fault = self._fault_at(state, idx)
            if fault is not None and fault.kind in ("partial_rename",
                                                    "raise"):
                raise (fault.error() if fault.error is not None
                       else InjectedFault(
                           f"injected {fault.kind} at {site}[{idx}]: "
                           f"{src} -> {dst} dropped"))
            return real(src, dst)

        return chaotic_rename

    def hook(self, site: str) -> Callable[[], None]:
        """A zero-arg callable that :meth:`fire`\\ s ``site`` — the shape
        lifecycle hook points take (e.g. ``Compactor(pre_publish=
        chaos.hook("compact.publish"))`` scripts a fault between a
        compaction pass building its successor index and the publish
        swap, proving the no-partial-publish contract)."""
        return lambda: self.fire(site)

    def fire(self, site: str):
        """Bare call-site hook for code that has no convenient callable to
        wrap: bumps the site counter and raises/drops per the script.
        Returns the 0-based call index it just consumed."""
        state = self._sites.setdefault(site, _Site())
        idx = state.calls
        state.calls += 1
        fault = self._fault_at(state, idx)
        if fault is not None:
            if fault.kind == "drop_rank":
                expects(self.health is not None,
                        "drop_rank fault needs ChaosMonkey(health=...)")
                self.health.mark_dead(fault.rank)
            elif fault.kind == "raise":
                raise (fault.error() if fault.error is not None
                       else InjectedFault(
                           f"injected fault at {site}[{idx}]"))
            elif fault.kind == "delay":
                self._sleep(fault, site, idx)
        return idx

    def rank_hook(self, site: str) -> Callable:
        """A ``hook(ranks)`` callable for rank-scoped sites: the Searcher
        calls it after each dispatch with the participating ranks, and a
        scripted ``"delay"`` fault sleeps ONLY when its victim ``rank``
        is among them (``rank < 0`` = any participant) — so a straggling
        shard slows exactly the dispatches that touch it, and queries
        routed around it (replica preference) dodge the delay.
        ``"drop_rank"`` faults fire regardless of participation (the
        host dies whether or not this dispatch used it).  The site
        counter counts every invocation; returns the consumed index."""
        state = self._sites.setdefault(site, _Site())

        def on_ranks(ranks) -> int:
            idx = state.calls
            state.calls += 1
            fault = self._fault_at(state, idx)
            if fault is None:
                return idx
            if fault.kind == "drop_rank":
                expects(self.health is not None,
                        "drop_rank fault needs ChaosMonkey(health=...)")
                self.health.mark_dead(fault.rank)
            elif fault.kind == "delay":
                participants = {int(r) for r in np.asarray(ranks).reshape(-1)}
                if fault.rank < 0 or fault.rank in participants:
                    self._sleep(fault, site, idx)
            elif fault.kind == "raise":
                raise (fault.error() if fault.error is not None
                       else InjectedFault(
                           f"injected fault at {site}[{idx}]"))
            return idx

        return on_ranks

    def _sleep(self, fault: FaultSpec, site: str, idx: int) -> None:
        expects(self.sleep is not None,
                "delay fault at %s[%s] needs ChaosMonkey(sleep=...) — "
                "inject the test clock's sleep, never wall time",
                site, idx)
        self.sleep(fault.seconds)

    # -- payload corruption ----------------------------------------------
    def corrupt(self, payload):
        """Deterministically mangle a payload (seeded stream, consumed in
        call order). Floats get large additive noise on a random subset
        of entries; ints get values scrambled to in-range garbage; pytrees
        (tuple/list/dict) corrupt every array leaf."""
        if isinstance(payload, tuple):
            return tuple(self.corrupt(p) for p in payload)
        if isinstance(payload, list):
            return [self.corrupt(p) for p in payload]
        if isinstance(payload, dict):
            return {k: self.corrupt(v) for k, v in payload.items()}
        arr = np.asarray(payload)
        if arr.size == 0:
            return payload
        flat = np.array(arr, copy=True).reshape(-1)
        n_hit = max(1, flat.size // 8)
        hit = self.rng.choice(flat.size, size=n_hit, replace=False)
        if np.issubdtype(flat.dtype, np.floating):
            scale = np.abs(flat).max() + 1.0
            flat[hit] += scale * (10.0 * self.rng.standard_normal(n_hit)
                                  ).astype(flat.dtype)
        elif np.issubdtype(flat.dtype, np.integer):
            # Python ints: `flat.max() + 1` on a numpy scalar would wrap
            # at the dtype max (the exclusive bound itself is in range
            # for rng.integers).
            lo, hi = int(flat.min()), int(flat.max()) + 1
            flat[hit] = self.rng.integers(lo, max(hi, lo + 1), size=n_hit,
                                          dtype=flat.dtype)
        else:
            return payload
        return flat.reshape(arr.shape)

    # -- introspection ----------------------------------------------------
    def calls(self, site: str) -> int:
        """How many times ``site`` has been entered."""
        s = self._sites.get(site)
        return 0 if s is None else s.calls

    def clear(self, site: str) -> None:
        """Drop every scripted fault at ``site`` (the call counter keeps
        counting) — how a scenario models a fault that ENDED: the
        straggler recovered, so later probes/dispatches run clean."""
        self._sites.setdefault(site, _Site()).faults.clear()

    def reset(self, site: Optional[str] = None) -> None:
        """Reset call counters (and the corruption RNG stream) so a
        scripted scenario replays from the top."""
        if site is None:
            for s in self._sites.values():
                s.calls = 0
            self.rng = np.random.default_rng(self.seed)
        else:
            self._sites.setdefault(site, _Site()).calls = 0

    @staticmethod
    def _fault_at(state: _Site, idx: int) -> Optional[FaultSpec]:
        for f in state.faults:
            if f.at is None or idx in f.at:
                return f
        return None
