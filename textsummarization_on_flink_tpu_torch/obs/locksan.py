"""Runtime lock-order sanitizer (``TS_LOCKSAN=1``).

The static side of the story lives in tools/tslint (TS007 derives the
lock acquisition-order graph from the call graph); this is the dynamic
side: an opt-in instrumented lock that records the REAL per-thread
acquisition order, fails fast on an inversion, and can cross-check what
actually ran against what the analyzer predicted.

Usage — replace direct ``threading.Lock()`` construction with the
factories, naming each lock the way tslint names it (``Class.attr``)::

    from textsummarization_on_flink_tpu_torch.obs import locksan
    self._lock = locksan.make_lock("RemoteReplica._lock")

With ``TS_LOCKSAN`` unset the factories return PLAIN ``threading``
primitives — zero wrapper, zero overhead, nothing to reason about in
production.  With ``TS_LOCKSAN=1`` every acquisition:

* pushes onto a per-thread held-lock stack and increments
  ``obs/locksan_acquisitions_total``;
* adds ``held -> acquiring`` edges to a process-global order graph;
* **fails fast** if the opposite edge was ever observed: the acquire is
  rolled back (the inner lock is released), a
  ``lock_inversion`` flight dump is written via obs/flightrec, and the
  typed :class:`LockOrderInversionError` is raised — a deadlock that
  would have been a wedged process under unlucky scheduling becomes a
  loud test failure under ANY scheduling that exercises both orders;
* optionally cross-checks each NEW edge against the statically derived
  graph (``TS_LOCKSAN_GRAPH=path`` to the JSON written by
  ``python -m tools.tslint --lock-graph``): an edge the analyzer never
  predicted counts ``obs/locksan_unmodeled_edges_total`` — the witness
  that the static model and real execution have drifted apart.

Kill conditions (when to turn it OFF): locksan is a test/chaos-rig
tool.  The wrapper adds a dict/stack bookkeeping cost per acquisition
and one process-global mutex on the order graph — never enable it on a
latency-measuring run, and never ship metrics from a sanitized run to
a perf baseline.  Reentrant acquisition of the same sanitized lock
(RLock) records no self-edges.

Caveat: do not hand a sanitized **RLock** to ``threading.Condition`` —
the Condition would probe ownership through ``acquire(False)``, which
succeeds reentrantly and corrupts its bookkeeping.  Use
:func:`make_condition` (plain-Lock based) for condition variables.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Set

__all__ = [
    "LockOrderInversionError", "make_lock", "make_rlock", "make_condition",
    "active", "configure", "snapshot", "reset",
]

_TRUTHY = ("1", "true", "on", "yes")


class LockOrderInversionError(RuntimeError):
    """Two locks were acquired in opposite orders by different code
    paths — the classic AB/BA deadlock, caught at the second acquire."""

    def __init__(self, message: str, acquiring: str = "",
                 held: Optional[List[str]] = None,
                 flight_dump: Optional[str] = None):
        super().__init__(message)
        self.acquiring = acquiring
        self.held = list(held or ())
        self.flight_dump = flight_dump


def _env_enabled() -> bool:
    return os.environ.get("TS_LOCKSAN", "").strip().lower() in _TRUTHY


class _Sanitizer:
    """Process-global order graph + per-thread held stacks."""

    def __init__(self) -> None:
        self._mu = threading.Lock()  # plain on purpose: guards the graph
        #: observed order: edges[a] contains b iff b was acquired with a
        #: held (a "happened-before" b inside some thread)
        self.edges: Dict[str, Set[str]] = {}
        self.static_edges: Optional[Dict[str, Set[str]]] = None
        self.static_path: Optional[str] = None
        self._tls = threading.local()
        self.acquisitions = 0
        self.inversions = 0
        self.unmodeled = 0

    # -- per-thread stack --------------------------------------------------

    def _stack(self) -> List["SanitizedLock"]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    # -- static graph ------------------------------------------------------

    def load_static(self, path: str) -> None:
        with open(path, "r", encoding="utf-8") as f:
            payload = json.load(f)
        edges: Dict[str, Set[str]] = {}
        for a, b in payload.get("edges", ()):
            edges.setdefault(a, set()).add(b)
        # transitive closure: the analyzer reports direct edges; runtime
        # stacks witness ancestors too (A held while C acquired through B)
        changed = True
        while changed:
            changed = False
            for a in list(edges):
                reach = edges[a]
                for b in list(reach):
                    extra = edges.get(b, set()) - reach - {a}
                    if extra:
                        reach |= extra
                        changed = True
        self.static_edges = edges
        self.static_path = path

    # -- events ------------------------------------------------------------

    def on_acquired(self, lock: "SanitizedLock") -> None:
        stack = self._stack()
        reentrant = any(h is lock for h in stack)
        held = []
        if not reentrant:
            seen: Set[str] = set()
            for h in stack:
                if h.name != lock.name and h.name not in seen:
                    seen.add(h.name)
                    held.append(h.name)
        inversion_against: Optional[str] = None
        unmodeled = 0
        with self._mu:
            self.acquisitions += 1
            for h in held:
                if h in self.edges.get(lock.name, ()):
                    inversion_against = h
                    break
            if inversion_against is None:
                for h in held:
                    dst = self.edges.setdefault(h, set())
                    if lock.name not in dst:
                        dst.add(lock.name)
                        if (self.static_edges is not None
                                and lock.name
                                not in self.static_edges.get(h, ())):
                            unmodeled += 1
                self.unmodeled += unmodeled
            else:
                self.inversions += 1
        _emit(lambda o: o.counter("obs/locksan_acquisitions_total").inc(1))
        if inversion_against is not None:
            dump = _flight_dump(lock.name, inversion_against, held)
            _emit(lambda o: o.counter("obs/locksan_inversions_total").inc(1))
            raise LockOrderInversionError(
                f"lock-order inversion: acquiring {lock.name} while "
                f"holding {held} but {lock.name} -> {inversion_against} "
                f"was previously observed — AB/BA deadlock under "
                f"adversarial scheduling",
                acquiring=lock.name, held=held, flight_dump=dump)
        if unmodeled:
            _emit(lambda o: o.counter(
                "obs/locksan_unmodeled_edges_total").inc(unmodeled))
        stack.append(lock)

    def on_released(self, lock: "SanitizedLock") -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                return


def _emit(inc: Any) -> None:
    """Mirror a sanitizer event into the default obs registry (call
    sites pass the literal metric name so the OBSERVABILITY.md
    doc-drift gate sees it)."""
    try:
        from textsummarization_on_flink_tpu_torch import obs
        inc(obs)
    except Exception:  # tslint: disable=TS005 — the sanitizer must never take the process down through its own telemetry; the in-object counters in snapshot() stay exact
        pass


def _flight_dump(acquiring: str, prior: str,
                 held: List[str]) -> Optional[str]:
    try:
        from textsummarization_on_flink_tpu_torch import obs
        from textsummarization_on_flink_tpu_torch.obs import flightrec
        return flightrec.trigger(
            obs.registry(), "lock_inversion",
            acquiring=acquiring, held=held,
            prior_edge=f"{acquiring} -> {prior}",
            thread=threading.current_thread().name)
    except Exception:  # tslint: disable=TS005 — flight capture is best-effort evidence; the typed LockOrderInversionError below is the failure signal itself
        return None


class SanitizedLock:
    """Order-checking wrapper over a ``threading`` lock primitive.
    Context-manager and acquire/release compatible; ``Condition`` can
    wrap the plain-Lock flavor (it falls back to its default
    ``_is_owned`` probe, which this wrapper answers correctly)."""

    def __init__(self, name: str, inner: Any, san: _Sanitizer) -> None:
        self.name = name
        self._inner = inner
        self._san = san

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if not ok:
            return False
        try:
            self._san.on_acquired(self)
        except LockOrderInversionError:
            self._inner.release()  # roll back: fail the acquire, typed
            raise
        return True

    def release(self) -> None:
        self._san.on_released(self)
        self._inner.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return bool(locked()) if locked is not None else False

    def __enter__(self) -> "SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"SanitizedLock({self.name!r})"


_SAN = _Sanitizer()
_ACTIVE = _env_enabled()
if _ACTIVE and os.environ.get("TS_LOCKSAN_GRAPH"):
    try:
        _SAN.load_static(os.environ["TS_LOCKSAN_GRAPH"])
    except (OSError, ValueError):
        pass  # missing/broken graph: sanitize without the cross-check


def active() -> bool:
    """True when locks built by the factories are sanitized."""
    return _ACTIVE


def configure(enabled: Optional[bool] = None,
              static_graph: Optional[str] = None) -> None:
    """Re-latch the sanitizer (tests; production uses the env vars at
    import).  Locks created BEFORE enabling stay plain — construct the
    objects under test after calling this."""
    global _ACTIVE
    if enabled is not None:
        _ACTIVE = bool(enabled)
    if static_graph is not None:
        _SAN.load_static(static_graph)


def reset() -> None:
    """Drop the observed order graph and counters (test isolation)."""
    with _SAN._mu:
        _SAN.edges.clear()
        _SAN.acquisitions = 0
        _SAN.inversions = 0
        _SAN.unmodeled = 0


def snapshot() -> Dict[str, Any]:
    """Exact in-object view (the obs counters mirror these but share the
    default registry with everything else in the process)."""
    with _SAN._mu:
        return {
            "active": _ACTIVE,
            "acquisitions": _SAN.acquisitions,
            "inversions": _SAN.inversions,
            "unmodeled_edges": _SAN.unmodeled,
            "order_edges": sorted(
                (a, b) for a, bs in _SAN.edges.items() for b in bs),
            "static_graph": _SAN.static_path,
        }


def make_lock(name: str) -> Any:
    """A ``threading.Lock`` — sanitized when TS_LOCKSAN is on."""
    if not _ACTIVE:
        return threading.Lock()
    return SanitizedLock(name, threading.Lock(), _SAN)


def make_rlock(name: str) -> Any:
    """A ``threading.RLock`` — sanitized when TS_LOCKSAN is on
    (reentrant re-acquisition records no self-edges)."""
    if not _ACTIVE:
        return threading.RLock()
    return SanitizedLock(name, threading.RLock(), _SAN)


def make_condition(name: str, lock: Optional[Any] = None) -> Any:
    """A ``threading.Condition``.  Pass ``lock`` to share a mutex built
    by :func:`make_lock` (the wait/notify protocol releases and
    re-acquires THROUGH the sanitized wrapper, so condition waits stay
    visible to the order graph); default builds its own."""
    if lock is None:
        lock = make_lock(name)
    return threading.Condition(lock)
