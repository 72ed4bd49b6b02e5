"""What the loops share: the cell being run, host ranges for the trace,
and the correctness checks with their limits."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List

import numpy as np

#: Numbers compared exactly (a count that must be 0).
EXACT = ("bad_ids", "misplaced", "data_mismatch")


@dataclass
class Cell:
    """One run of one cell: its parts, the seed and the device."""

    name: str
    cfg: dict
    traffic: dict
    system: ModuleType
    reference: ModuleType
    seed: int
    device: str
    trace: bool
    state: dict = field(default_factory=dict)

    def mark(self, name: str):
        """A host range named ``perfbench.<name>`` in a traced run (the
        idle gaps are named by these); nothing otherwise."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function("perfbench." + name)

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()


def worst(readings: List[dict]) -> Dict[str, float]:
    """One reading per number over several judgements: the largest of
    each, and the recall over all answers (weighted by ``n``)."""
    out: Dict[str, float] = {}
    for r in readings:
        for key, v in r.items():
            if key not in ("recall", "n"):
                out[key] = max(out.get(key, v), v)
    total = sum(r["n"] for r in readings if "n" in r)
    if total:
        out["recall"] = sum(r["recall"] * r["n"] for r in readings
                            if "n" in r) / total
    return out


def checks(readings: Dict[str, float], cfg: dict) -> Dict[str, dict]:
    """Each number beside its limit: the configuration's ``limits`` (at
    most) and ``min_recall`` (at least)."""
    out = {}
    for key, v in readings.items():
        if key == "recall":
            out[key] = {"value": float(v), "limit": cfg["min_recall"],
                        "ok": bool(v >= cfg["min_recall"])}
        else:
            lim = cfg["limits"][key]
            out[key] = {"value": float(v) if key not in EXACT else int(v),
                        "limit": lim, "ok": bool(v <= lim)}
    return out


def seeded_sample(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """``size`` distinct indices of ``range(n)`` (all of them if fewer),
    sorted."""
    return np.sort(rng.choice(n, size=min(n, size), replace=False))
