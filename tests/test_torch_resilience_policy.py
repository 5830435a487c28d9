"""The port's resilience policy against the JAX package's, on the CPU.

Deadline, RetryPolicy and CircuitBreaker go through the same states
under one injected clock and seeded jitter; the typed errors keep the
JAX package's bases; ResilientSource reconnects through injected
``io.connect`` / ``io.read`` faults and drops replayed uuids as the JAX
one does; BreakerSink opens after the same number of ``io.write``
faults."""

import time

import pytest

from textsummarization_on_flink_tpu import obs as jax_obs
from textsummarization_on_flink_tpu.pipeline import io as jax_io
from textsummarization_on_flink_tpu.resilience import errors as jax_errors
from textsummarization_on_flink_tpu.resilience import (
    faultinject as jax_faults,
)
from textsummarization_on_flink_tpu.resilience import policy as jax_policy
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.pipeline import io
from textsummarization_on_flink_tpu_torch.resilience import errors
from textsummarization_on_flink_tpu_torch.resilience import faultinject
from textsummarization_on_flink_tpu_torch.resilience import policy

PKGS = {"jax": (jax_policy, jax_io, jax_faults, jax_obs),
        "port": (policy, io, faultinject, obs)}


class Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    c = Clock()
    # both packages read time.monotonic through the one time module
    monkeypatch.setattr(time, "monotonic", c)
    return c


ERRORS = ["ResilienceError", "StreamIdleError", "DeadlineExceededError",
          "CircuitOpenError", "RetriesExhaustedError", "CheckpointCorruptError",
          "WorkerCrashError", "ArenaExhaustedError"]


@pytest.mark.parametrize("name", ERRORS)
def test_errors_keep_the_jax_bases(name):
    mine, theirs = getattr(errors, name), getattr(jax_errors, name)
    assert [b.__name__ for b in mine.__mro__] == \
        [b.__name__ for b in theirs.__mro__]
    assert issubclass(mine, RuntimeError)


def _deadline_trace(pol, clock):
    out = []
    for secs in (None, 0, -1, 2.5):
        d = pol.Deadline.after(secs)
        row = [d.bounded, d.remaining(), d.expired(), d.timeout_for(1.0),
               d.timeout_for()]
        clock.t += 1.0
        row += [d.remaining(), d.expired()]
        clock.t += 2.0
        row += [d.remaining(), d.expired(), d.timeout_for(1.0)]
        try:
            d.check("the test")
            row.append("ok")
        except Exception as e:  # noqa: BLE001 - the class is the result
            row.append(type(e).__name__)
        out.append(row)
    return out


def test_deadline_states_equal_jax(clock):
    start = clock.t
    want = _deadline_trace(jax_policy, clock)
    clock.t = start
    assert _deadline_trace(policy, clock) == want
    assert want[3][-1] == "DeadlineExceededError"


def _retry_trace(pkg, seed, max_attempts, deadline_secs, clock):
    pol, _, _, omod = PKGS[pkg]
    reg = omod.Registry()
    slept = []

    def sleep(d):
        slept.append(d)
        clock.t += d

    rp = pol.RetryPolicy(max_attempts=max_attempts, base_delay=0.05,
                         max_delay=1.0, seed=seed, name="io.source",
                         sleep=sleep, registry=reg,
                         deadline=pol.Deadline.after(deadline_secs))
    attempts, outcome = [], "ok"
    try:
        for a in rp.attempts():
            attempts.append(a)
            rp.note_failure(ConnectionResetError(f"attempt {a}"))
    except Exception as e:  # noqa: BLE001 - the class is the result
        outcome = (type(e).__name__, type(e.__cause__).__name__)
    delays = [rp.next_delay() for _ in range(3)]
    return (attempts, slept, outcome, delays, reg.render_text())


@pytest.mark.parametrize("seed,max_attempts,deadline_secs", [
    (0, 5, 0), (7, 3, 0), (42, 8, 0), (3, 8, 0.2)])
def test_retry_policy_states_equal_jax(clock, seed, max_attempts,
                                       deadline_secs):
    start = clock.t
    want = _retry_trace("jax", seed, max_attempts, deadline_secs, clock)
    clock.t = start
    got = _retry_trace("port", seed, max_attempts, deadline_secs, clock)
    assert got == want
    assert want[2][0] in ("RetriesExhaustedError", "DeadlineExceededError")


def _breaker_trace(pkg, clock):
    pol, _, _, omod = PKGS[pkg]
    reg = omod.Registry()
    br = pol.CircuitBreaker(threshold=3, reset_secs=5.0, name="io.sink",
                            clock=clock, registry=reg)
    states = []
    script = ("f", "s", "f", "f", "f", "a", "t4", "a", "t2", "a", "a", "f",
              "a", "t5", "a", "s", "a", "f", "f", "t1", "a")
    for op in script:
        if op == "f":
            br.record_failure()
        elif op == "s":
            br.record_success()
        elif op == "a":
            states.append(("allow", br.allow()))
        else:
            clock.t += float(op[1:])
        states.append(br.state)
    return states, reg.render_text()


def test_circuit_breaker_states_equal_jax(clock):
    start = clock.t
    want = _breaker_trace("jax", clock)
    clock.t = start
    got = _breaker_trace("port", clock)
    assert got == want
    assert "open" in want[0] and "half_open" in want[0]


def _flapping_rows(pkg, spec, n_rows=6):
    """A source that replays from the start on every connection, through
    ResilientSource, with io.connect/io.read faults armed."""
    pol, iomod, fmod, omod = PKGS[pkg]
    rows = [(f"uuid-{i}", f"article {i} .", "", "ref .")
            for i in range(n_rows)]
    reg = omod.Registry()
    with omod.use_registry(reg), fmod.use_plan(
            fmod.FaultPlan(fmod.parse(spec), registry=reg)):
        faults = fmod.plan()

        class Replaying(iomod.Source):
            schema = iomod.ARTICLE_INPUT_SCHEMA

            def rows(self):
                if faults.fire("io.connect"):
                    raise ConnectionRefusedError("injected io.connect")
                for n, row in enumerate(rows):
                    if faults.fire("io.read"):
                        raise ConnectionResetError(
                            f"injected io.read after {n}")
                    yield row

        src = iomod.ResilientSource(Replaying, max_reconnects=10, seed=5,
                                    sleep=lambda d: None)
        got = list(src.rows())
    counts = {k: reg.counter(k).value for k in (
        "resilience/io_reconnects_total", "resilience/io_dup_rows_total")}
    return got, counts, rows


@pytest.mark.parametrize("spec", ["io.read:0.3:1:3", "io.read:0.5:9:4",
                                  "io.connect:0.5:2:2,io.read:0.2:4:3"])
def test_resilient_source_reconnects_and_drops_replays(spec):
    got, counts, rows = _flapping_rows("port", spec)
    want, jcounts, _ = _flapping_rows("jax", spec)
    assert got == rows == want  # every row exactly once, in order
    assert counts == jcounts
    assert counts["resilience/io_reconnects_total"] >= 1
    assert counts["resilience/io_dup_rows_total"] >= 1


def test_resilient_source_gives_up_typed():
    class Dead(io.Source):
        schema = io.ARTICLE_INPUT_SCHEMA

        def rows(self):
            raise ConnectionRefusedError("nobody home")
            yield  # pragma: no cover

    with obs.use_registry(obs.Registry()):
        src = io.ResilientSource(Dead, max_reconnects=2, seed=0,
                                 sleep=lambda d: None)
        with pytest.raises(errors.RetriesExhaustedError) as ei:
            list(src.rows())
    assert isinstance(ei.value.__cause__, ConnectionRefusedError)


def _breaker_sink_trace(pkg, clock, spec):
    pol, iomod, fmod, omod = PKGS[pkg]
    reg = omod.Registry()
    with omod.use_registry(reg), fmod.use_plan(
            fmod.FaultPlan(fmod.parse(spec), registry=reg)):
        inner = iomod.CollectionSink()
        sink = iomod.BreakerSink(inner, pol.CircuitBreaker(
            threshold=3, reset_secs=10.0, name="io.sink", clock=clock,
            registry=reg))
        states = []
        for i in range(12):
            sink.write((f"uuid-{i}", "a", "s", "r"))
            states.append(sink.breaker.state)
            if i == 8:
                clock.t += 11.0  # past the reset: one half-open probe
    counts = {k: reg.counter(k).value for k in (
        "resilience/sink_shed_total", "resilience/sink_errors_total")}
    return states, [r[0] for r in inner.rows], counts


@pytest.mark.parametrize("spec", ["io.write:1.0:0:4", "io.write:0.6:3"])
def test_breaker_sink_opens_after_the_same_faults(clock, spec):
    start = clock.t
    want = _breaker_sink_trace("jax", clock, spec)
    clock.t = start
    got = _breaker_sink_trace("port", clock, spec)
    assert got == want
    assert "open" in got[0]
