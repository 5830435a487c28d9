"""The slot engine's page arena: a free list over a fixed pool of pages.

A copy of the JAX package's decode/arena.py.  The paged resident state
(decode/beam_search.py, ``*_paged``) keeps the encoder-axis tensors in
pools of ``decode_enc_block``-row pages; the engine
(decode/decoder.SlotDecodeEngine) allocates ``ceil(length / block)``
pages at pack time, frees them at unpack or eviction, and passes each
slot's page ids to the step as its page-table row.  Plain numpy on the
host: allocation runs between chunks and syncs nothing.

``ArenaExhaustedError`` is the typed backpressure signal: the batcher
requeues the admission until a harvest frees pages.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

from textsummarization_on_flink_tpu_torch.resilience.errors import (  # noqa: F401
    ArenaExhaustedError,
)

__all__ = ["ArenaExhaustedError", "PageArena"]


class PageArena:
    """LIFO free list over page ids ``0 .. pages - 1`` (a just-freed page
    is reused first).  The scratch page (id ``pages`` in the pools) is
    not managed here: it is never allocated or freed."""

    def __init__(self, pages: int):
        if pages < 1:
            raise ValueError(f"arena needs at least one page, got {pages}")
        self._capacity = int(pages)
        self._free: List[int] = list(range(pages - 1, -1, -1))
        self._owned = np.zeros(pages, dtype=bool)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self._capacity - len(self._free)

    @property
    def fill(self) -> float:
        """In-use fraction in [0, 1]."""
        return self.pages_in_use / self._capacity

    def alloc(self, n: int) -> np.ndarray:
        """``n`` pages as int32 ids; raises ``ArenaExhaustedError`` and
        allocates nothing when fewer are free."""
        n = int(n)
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise ArenaExhaustedError(
                f"arena exhausted: need {n} pages, {len(self._free)} free "
                f"of {self._capacity}", needed=n, free=len(self._free))
        ids = [self._free.pop() for _ in range(n)]
        self._owned[ids] = True
        return np.asarray(ids, dtype=np.int32)

    def free(self, ids: Iterable[int]) -> None:
        """Return pages to the free list.  An id out of range or not
        allocated raises: an accounting fault must not hand one page to
        two residents."""
        for pid in np.asarray(list(ids), dtype=np.int64).tolist():
            if not 0 <= pid < self._capacity:
                raise ValueError(
                    f"page id {pid} outside arena of {self._capacity}")
            if not self._owned[pid]:
                raise ValueError(f"double free of page {pid}")
            self._owned[pid] = False
            self._free.append(int(pid))
