"""Batched linear assignment: the auction algorithm with epsilon-scaling.

Port of ``raft_tpu/solver/linear_assignment.py`` (RAFT's
``solver/linear_assignment.cuh``). Every problem of a batch runs the
reference's schedule: 12 phases, epsilon from span / 2 down by a factor
of 6 to a floor of span * 4e-6 (computed in f32 as the reference computes
it), each phase restarting the assignment from the prices so far and
running bid rounds until every row is assigned or ``max_rounds`` rounds
have passed. A round is dense tensor work over the whole batch: each
unassigned row bids for its best column (``argmax``, ties to the first
column) by the gap to its second best plus epsilon, each column takes its
highest bid (``scatter_reduce`` amax, ties to the lowest row by amin),
evicts its previous owner and raises its price by the bid.

The reference runs one ``lax.while_loop`` a phase under ``vmap``. Here
one Python loop of rounds serves the batch: a problem whose rows are all
assigned, or whose round count reached ``max_rounds``, is frozen (its
state selected back, as ``vmap``'s select does), so each slice of a batch
equals :func:`lap` on that slice bit for bit. A round in which every row
is assigned changes nothing, so the loop asks the host whether any
problem is still active only every ``_CHECK_EVERY`` rounds.

Rows left unassigned at ``max_rounds`` are matched to the free columns on
the host (:func:`_complete_assignment`), as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.nvtx import traced
from raft_tpu_torch.core.resources import DeviceLike

# Epsilon-scaling phases (the reference's schedule).
_N_PHASES = 12
# Bid rounds between two host checks of "is any problem still active".
_CHECK_EVERY = 8


def _eps_schedule(span: torch.Tensor) -> torch.Tensor:
    """(batch, phases) epsilons in f32: span / 2 / 6^i, floored at
    span * 4e-6. The division by the power is a multiply by its
    reciprocal, which is how XLA evaluates the reference's expression."""
    powers = torch.pow(6.0, torch.arange(_N_PHASES, dtype=torch.float32,
                                         device=span.device))
    eps = span[:, None] / 2.0 * (1.0 / powers)[None, :]
    return torch.maximum(eps, (span * 4e-6)[:, None])


def _bid_round(value, prices, row_of_col, col_of_row, eps):
    """One auction round over the batch; returns the new
    ``(row_of_col, col_of_row, prices)``. No host sync and no host copy,
    so a CUDA graph can hold it."""
    B, n, _ = value.shape
    dev = value.device
    neg_inf = torch.full((), float("-inf"), dtype=value.dtype, device=dev)
    ar = torch.arange(n, device=dev).expand(B, n)
    unassigned = col_of_row < 0
    net = value - prices[:, None, :]
    best_j = torch.argmax(net, dim=2)
    best_v = torch.gather(net, 2, best_j[:, :, None])
    # The second best: the row's maximum with its best set to -inf.
    second_v = net.scatter_(2, best_j[:, :, None],
                            float("-inf")).amax(dim=2)
    bid = best_v[:, :, 0] - second_v + eps[:, None]
    bids = torch.where(unassigned, bid, neg_inf)
    col_bid = torch.full((B, n), float("-inf"), dtype=value.dtype,
                         device=dev).scatter_reduce(
        1, best_j, bids, "amax", include_self=False)
    won_col = col_bid > neg_inf
    is_winner = (unassigned & (bids == torch.gather(col_bid, 1, best_j))
                 & torch.gather(won_col, 1, best_j))
    winner_row = torch.full((B, n), n, dtype=torch.int64,
                            device=dev).scatter_reduce(
        1, best_j, torch.where(is_winner, ar, n), "amin", include_self=False)
    has_winner = winner_row < n
    # Evict each won column's previous owner.
    prev = torch.where(has_winner, row_of_col, -1)
    evicted = torch.zeros((B, n + 1), dtype=torch.bool, device=dev).scatter_(
        1, torch.where(prev >= 0, prev, n), True)[:, :n]
    col_of_row = torch.where(evicted, -1, col_of_row)
    row_of_col = torch.where(has_winner, winner_row, row_of_col)
    # Assign the winners (a row wins at most one column: it bid on one).
    col_of_row = torch.cat(
        [col_of_row, col_of_row.new_zeros((B, 1))], dim=1).scatter_(
        1, torch.where(has_winner, winner_row, n),
        torch.where(has_winner, ar, -1))[:, :n]
    prices = prices + torch.where(has_winner, col_bid, 0.0)
    return row_of_col, col_of_row, prices


class _Auction:
    """The auction's state for a batch of problems, updated in place by
    :meth:`rounds`. On ``cuda`` the ``_CHECK_EVERY`` rounds between two
    host checks are one CUDA graph (a round is ~30 small launches), so
    the host replays one graph where it would issue hundreds of
    launches; the graph runs the same kernels on the same buffers, so it
    computes what the eager rounds compute."""

    def __init__(self, costs: torch.Tensor, max_rounds: int):
        B, n, _ = costs.shape
        dev = costs.device
        self.value = -costs
        self.max_rounds = max_rounds
        self.prices = torch.zeros((B, n), dtype=costs.dtype, device=dev)
        self.row_of_col = torch.full((B, n), -1, dtype=torch.int64,
                                     device=dev)
        self.col_of_row = torch.full((B, n), -1, dtype=torch.int64,
                                     device=dev)
        self.it = torch.zeros(B, dtype=torch.int64, device=dev)
        self.eps = torch.zeros(B, dtype=costs.dtype, device=dev)
        self.graph = None

    def restart(self, eps: torch.Tensor) -> None:
        """A new phase: no row assigned, the round count at 0, the prices
        kept."""
        self.row_of_col.fill_(-1)
        self.col_of_row.fill_(-1)
        self.it.zero_()
        self.eps.copy_(eps)

    def active(self) -> torch.Tensor:
        """The problems with an unassigned row and rounds left."""
        return (torch.any(self.col_of_row < 0, dim=1)
                & (self.it < self.max_rounds))

    def _eager_rounds(self) -> None:
        for _ in range(_CHECK_EVERY):
            act = self.active()
            r, c, p = _bid_round(self.value, self.prices, self.row_of_col,
                                 self.col_of_row, self.eps)
            # A frozen problem keeps its state (vmap's select).
            self.row_of_col.copy_(torch.where(act[:, None], r,
                                              self.row_of_col))
            self.col_of_row.copy_(torch.where(act[:, None], c,
                                              self.col_of_row))
            self.prices.copy_(torch.where(act[:, None], p, self.prices))
            self.it.add_(act.long())

    def capture(self) -> None:
        """Record the rounds as a CUDA graph. The warm-up run on a side
        stream moves the state, so the caller restarts afterwards."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._eager_rounds()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._eager_rounds()

    def rounds(self) -> None:
        """``_CHECK_EVERY`` rounds, the frozen problems unchanged."""
        if self.graph is not None:
            self.graph.replay()
        else:
            self._eager_rounds()


def _auction(costs: torch.Tensor, max_rounds: int) -> torch.Tensor:
    """Forward auction with epsilon-scaling for a batch of (n, n) f32
    min-cost problems. Returns the row assignments (batch, n) int64, -1
    where a row was left unassigned at ``max_rounds``."""
    span = torch.clamp_min(torch.abs(costs).amax(dim=(1, 2)), 1.0)
    eps_all = _eps_schedule(span)
    state = _Auction(costs, max_rounds)
    if costs.is_cuda:
        state.restart(eps_all[:, 0])
        state.capture()
        state.prices.zero_()
    for phase in range(_N_PHASES):
        state.restart(eps_all[:, phase])
        while bool(state.active().any()):
            state.rounds()
    return state.col_of_row


def _complete_assignment(assign: torch.Tensor) -> torch.Tensor:
    """Repair partial assignments (batch, n): the rows left at -1 (the
    auction hit ``max_rounds``) take the unused columns, the highest
    first, so each result is a permutation (possibly suboptimal), as the
    reference's host repair does."""
    if bool((assign >= 0).all()):
        return assign
    a = assign.cpu().numpy().copy()
    n = a.shape[1]
    for b in range(a.shape[0]):
        row = a[b]
        used = set(int(c) for c in row[row >= 0])
        free_cols = [c for c in range(n) if c not in used]
        for r in np.where(row < 0)[0]:
            row[r] = free_cols.pop()
    return torch.as_tensor(a, device=assign.device)


def _solve(costs: torch.Tensor, max_rounds: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assignments (batch, n) int32 and objectives (batch,) of f32
    costs."""
    assign = _complete_assignment(_auction(costs, max_rounds))
    totals = torch.sum(torch.gather(costs, 2, assign[:, :, None])[:, :, 0],
                       dim=1)
    return assign.to(torch.int32), totals


@traced
def lap(cost, max_rounds: int = 0, device: DeviceLike = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve one min-cost assignment. Returns ``(row_assignment (n,)
    int32, total_cost scalar)``. ``max_rounds`` caps the bid rounds of
    each phase (0: 50 n). A tensor stays on its device; other inputs go
    to ``device`` (``cuda`` by default)."""
    cost = as_array(cost, device=device).float()
    expects(cost.ndim == 2 and cost.shape[0] == cost.shape[1],
            "cost must be square")
    n = cost.shape[0]
    assign, totals = _solve(cost[None], max_rounds or 50 * n)
    return assign[0], totals[0]


class LinearAssignmentProblem:
    """Batched LAP solver (``batchsize`` x ``size`` x ``size`` costs).
    ``epsilon`` is kept for parity with the reference, which does not
    read it."""

    def __init__(self, size: int, batchsize: int = 1, epsilon: float = 1e-6):
        self.size = size
        self.batchsize = batchsize
        self.epsilon = epsilon
        self._row_assignments = None
        self._obj_vals = None

    def solve(self, costs, device: DeviceLike = None) -> None:
        """costs: (batchsize, size, size) or (size, size)."""
        costs = as_array(costs, device=device).float()
        if costs.ndim == 2:
            costs = costs[None]
        expects(tuple(costs.shape) == (self.batchsize, self.size, self.size),
                "cost tensor shape mismatch")
        self._row_assignments, self._obj_vals = _solve(costs,
                                                       50 * self.size)

    def getAssignmentVector(self, batch: int = 0) -> torch.Tensor:
        """The row assignment of problem ``batch``."""
        return self._row_assignments[batch]

    def getPrimalObjectiveValue(self, batch: int = 0) -> float:
        """The total cost of problem ``batch``."""
        return float(self._obj_vals[batch])
