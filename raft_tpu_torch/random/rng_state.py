"""RNG state: seed + subsequence with a generator-type tag.

Port of ``raft_tpu/random/rng_state.py``. Where the reference derives a
``jax.random`` key from (seed, subsequence), the port seeds an explicit
``torch.Generator`` on the requested device. The two draw different
numbers from the same seed; tests hand both packages the same numpy
inputs instead.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch


class GeneratorType(enum.Enum):
    """Kept for API parity; both map to the device's Philox generator."""

    GenPhilox = 0
    GenPC = 1


@dataclass
class RngState:
    """Reproducible RNG stream state."""

    seed: int = 0
    base_subsequence: int = 0
    type: GeneratorType = GeneratorType.GenPC

    def generator(self, device="cpu") -> torch.Generator:
        """A generator on ``device`` seeded from (seed, subsequence)."""
        g = torch.Generator(device=device)
        g.manual_seed((self.seed * 1_000_003 + self.base_subsequence)
                      & 0xFFFF_FFFF_FFFF)
        return g

    def advance(self, subsequences: int = 1) -> None:
        """Advance the stream: later draws are independent of earlier."""
        self.base_subsequence += subsequences

    def next_generator(self, device="cpu") -> torch.Generator:
        """Generator for the current subsequence, then advance."""
        g = self.generator(device)
        self.advance()
        return g
