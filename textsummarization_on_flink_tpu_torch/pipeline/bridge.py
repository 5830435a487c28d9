"""The record queue between a pipeline's source and its trainer or decoder.

The port's copy of the Python half of the JAX package's
pipeline/bridge.py, which stands in for Flink-AI-Extended's
Java<->Python data-exchange queues (Integration Report.md:887-941): a
bounded queue of byte records between the pipeline (which owns sources
and sinks) and the trainer or decoder.  Carried over from the
reference's failure modes:

  * a put wakes the consumer before it returns (the reference's bridge
    surfaced a result only when the NEXT record arrived, Integration
    Report:879-897);
  * ``close()`` ends the stream cleanly: drained ``get``s return None
    instead of blocking forever, and a producer parked on a full queue
    is released.

The JAX package's native ring buffer (``libtsbridge.so``) belongs to
that package, so ``make_record_queue()`` returns the Python queue.  Safe
for one producer and one consumer thread (the bridge's topology).
"""

from __future__ import annotations

import collections
import threading
from typing import Optional


class RecordQueue:
    """Interface: a bounded queue of byte records with end-of-stream."""

    def put(self, data: bytes, timeout: Optional[float] = None) -> bool:
        """Enqueue; False on timeout or if closed."""
        raise NotImplementedError

    def get(self, timeout: Optional[float] = None) -> Optional[bytes]:
        """Dequeue; None when closed-and-drained (end of stream) or on
        timeout.  ``closed`` tells the two apart."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def closed(self) -> bool:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class PyRecordQueue(RecordQueue):
    """A condition-variable deque; close() wakes a producer parked in a
    full-queue put() and a consumer parked in an empty-queue get()."""

    def __init__(self, capacity: int = 1024):
        self._items: "collections.deque[bytes]" = collections.deque()
        self._capacity = max(capacity, 1)
        self._cond = threading.Condition()
        self._closed = False

    def put(self, data: bytes, timeout: Optional[float] = None) -> bool:
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._closed or len(self._items) < self._capacity,
                timeout=timeout)
            if not ok or self._closed:
                return False
            self._items.append(bytes(data))
            self._cond.notify_all()  # immediate flush
            return True

    def get(self, timeout: Optional[float] = None) -> Optional[bytes]:
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._closed or len(self._items) > 0,
                timeout=timeout)
            if not ok or not self._items:
                return None  # timeout, or closed-and-drained
            rec = self._items.popleft()
            self._cond.notify_all()
            return rec

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()  # wakes parked producers and consumers

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)


def make_record_queue(capacity: int = 1024) -> RecordQueue:
    return PyRecordQueue(capacity)
