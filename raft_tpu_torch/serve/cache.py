"""Exact-query LRU result cache for the serving runtime.

Port of ``raft_tpu/serve/cache.py``, with the id dtype in the key:
production query streams are heavily repeated (trending queries, retried
RPCs, A/B replays), and an exact-match cache answers those without
touching the card.

Correctness contract: the key is ``(index epoch, query bytes, k)``, with
the index's id dtype beside them (an int32 index and its int64 copy can
stand at the same epoch; neither's answer may serve the other). The
epoch, threaded from ``Index.epoch`` (bumped by every mutation:
``extend``, ``lifecycle.delete``, ``lifecycle.upsert`` and each
compaction publish) through ``Searcher.epoch``, makes stale hits
impossible: mutating the index changes the key space, so entries written
against the old contents can never answer for the new ones. It also makes
lifecycle racing safe: a search dispatched against the pre-mutation
snapshot writes its answer under the OLD epoch
(``BatchScheduler._dispatch`` captures the epoch before searching), so
the entry is unreachable the moment the mutation commits; a deleted row
can never be served from cache after its delete's epoch is current.
``invalidate()`` additionally drops the dead entries eagerly (they could
otherwise occupy LRU capacity until evicted).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from raft_tpu_torch.core.error import expects

CacheKey = Tuple[int, int, bytes, bytes]


def _key(epoch: int, queries: np.ndarray, k: int, id_dtype=None) -> CacheKey:
    # Shape/dtype ride in the key via a header: two float32 queries of
    # different shapes may share tobytes() (e.g. (1,4) vs (4,1)). So does
    # the id dtype of the answer.
    header = ("%s|%s|%s" % (queries.shape, queries.dtype.str,
                            id_dtype)).encode()
    return (int(epoch), int(k), header, queries.tobytes())


class ResultCache:
    """Bounded LRU over exact (epoch, query bytes, k) triples.

    Values are whatever the searcher returned for the FULL request
    (a ``SearchResult``); the cache never slices or reassembles.
    Thread-safe; hit/miss/eviction counters for the stats scrape.
    """

    def __init__(self, capacity: int = 1024):
        expects(capacity >= 1, "cache capacity must be >= 1, got %s",
                capacity)
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[CacheKey, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def get(self, epoch: int, queries: np.ndarray, k: int, id_dtype=None):
        """The cached result for this exact request (and id dtype), or
        None. Counts a hit or a miss either way."""
        key = _key(epoch, np.asarray(queries), k, id_dtype)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def put(self, epoch: int, queries: np.ndarray, k: int, result,
            id_dtype=None) -> None:
        key = _key(epoch, np.asarray(queries), k, id_dtype)
        with self._lock:
            self._entries[key] = result
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def invalidate(self, epoch: Optional[int] = None) -> int:
        """Drop entries eagerly: all of them (default — the extend-path
        hook), or only those written against one ``epoch``. Returns the
        number dropped. Counters survive (the scrape wants totals)."""
        with self._lock:
            if epoch is None:
                n = len(self._entries)
                self._entries.clear()
            else:
                stale = [key for key in self._entries if key[0] == epoch]
                for key in stale:
                    del self._entries[key]
                n = len(stale)
            self.invalidations += n
            return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"size": len(self._entries), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "invalidations": self.invalidations,
                    "hit_rate": self.hits / total if total else 0.0}
