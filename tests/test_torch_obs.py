"""The port's obs package against the JAX package's, on the CPU.

The same sequence of metric operations on a registry of each package
gives byte-equal Prometheus text and equal snapshots; the same span
nesting gives equal span trees and Chrome-trace events but for the
timestamps and ids; the flight recorder dumps the same frames under one
injected clock, and the profiler the same phase ledger; the port's
/metrics serves its render_text(); its SLO engine reads the repo's
SLO_POLICY.json."""

import json
import os
import urllib.request

import pytest

from textsummarization_on_flink_tpu import obs as jax_obs
from textsummarization_on_flink_tpu.obs import flightrec as jax_flightrec
from textsummarization_on_flink_tpu.obs import profile as jax_profile
from textsummarization_on_flink_tpu.obs import slo as jax_slo
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.obs import flightrec, slo
from textsummarization_on_flink_tpu_torch.obs import http as obs_http
from textsummarization_on_flink_tpu_torch.obs import profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def drive(reg):
    """One fixed sequence of counter, gauge, labelled and histogram
    operations (the serve layer's names among them)."""
    reg.counter("serve/requests_total").inc()
    reg.counter("serve/requests_total").inc(4)
    reg.counter("serve/requests_total").labels(tenant="paid").inc(2)
    reg.counter("serve/requests_total").labels(tenant="free",
                                               tier="greedy").inc()
    reg.counter("pipeline/rows_out_total").inc(8)
    reg.counter("serve/never_touched_total")
    g = reg.gauge("serve/queue_depth")
    g.set(7)
    g.inc(2)
    g.dec(0.5)
    reg.gauge("serve/slots_free").labels(replica="r0").set(3)
    h = reg.histogram("serve/e2e_latency_seconds")
    for i, v in enumerate((0.003, 0.02, 0.02, 0.4, 1.7, 12.0, 250.0)):
        h.observe(v, trace_id=f"t{i}")
    h.labels(tenant="paid").observe(0.05)
    fill = reg.histogram("serve/batch_fill",
                         buckets=[float(i) for i in range(1, 17)])
    for n in (16, 4, 9, 16, 1):
        fill.observe(n)
    fill.observe(2, n=3)
    reg.histogram("decode/request_latency_seconds",
                  buckets=obs.exponential_buckets(0.001, 2.0, 8))


@pytest.fixture()
def driven():
    jreg, treg = jax_obs.Registry(), obs.Registry()
    drive(jreg)
    drive(treg)
    return jreg, treg


@pytest.mark.parametrize("exemplars,openmetrics", [
    (None, False), (True, False), (False, False), (True, True)])
def test_render_text_is_byte_equal(driven, exemplars, openmetrics):
    jreg, treg = driven
    want = jreg.render_text(exemplars=exemplars, openmetrics=openmetrics)
    got = treg.render_text(exemplars=exemplars, openmetrics=openmetrics)
    assert got.encode() == want.encode()
    assert "serve_requests_total" in got


@pytest.mark.parametrize("compact", [False, True])
def test_snapshots_are_equal(driven, compact):
    jreg, treg = driven
    assert treg.snapshot(compact=compact) == jreg.snapshot(compact=compact)
    assert json.dumps(treg.snapshot(compact=compact))


def test_percentiles_and_exemplars_are_equal(driven):
    jreg, treg = driven
    for name in ("serve/e2e_latency_seconds", "serve/batch_fill"):
        jh, th = jreg.histogram(name), treg.histogram(name)
        for q in (0, 50, 90, 99, 100):
            assert th.percentile(q) == jh.percentile(q)
        assert (th.count, th.sum, th.mean) == (jh.count, jh.sum, jh.mean)
        assert th.exemplars() == jh.exemplars()


def test_a_dark_registry_counts_nothing():
    """obs=False hands out the null registry, as in the JAX package."""
    from textsummarization_on_flink_tpu_torch.config import HParams

    dark = obs.registry_for(HParams(obs=False, device="cpu"))
    assert dark is obs.NULL_REGISTRY and not dark.enabled
    dark.counter("x").inc()
    assert dark.render_text() == jax_obs.NULL_REGISTRY.render_text()


def _spans(mod, reg):
    """Nested spans on one thread, one traced root, one span that
    raises."""
    span = mod.spans.span
    with span(reg, "pipeline/transform_serving", rows=3):
        with span(reg, "serve/dispatch", fill=2, tier="beam"):
            with span(reg, "decode/batch", tier="beam"):
                pass
        ctx = mod.TraceContext.new("feedfacecafebeef")
        with span(reg, "serve/dispatch", parent=ctx, fill=1):
            pass
    with pytest.raises(KeyError):
        with span(reg, "train/profiler_capture"):
            raise KeyError("recorded anyway")
    return mod.tracer_for(reg)


def _strip(ev):
    """A span record without timestamps, durations, process, thread and
    span ids."""
    drop = {"ts", "dur", "ts_us", "dur_us", "pid", "tid", "span_id",
            "parent_id"}
    out = {k: v for k, v in ev.items() if k not in drop}
    if "args" in out:
        out["args"] = {k: v for k, v in out["args"].items() if k not in drop}
    return out


def test_span_trees_and_chrome_events_are_equal():
    jt = _spans(jax_obs, jax_obs.Registry())
    tt = _spans(obs, obs.Registry())
    tree = lambda t: [(r.name, r.depth, r.parent, r.attrs, r.trace_id)  # noqa: E731
                      for r in t.finished()]
    assert tree(tt) == tree(jt)
    assert [r.name for r in tt.finished()] == [
        "decode/batch", "serve/dispatch", "serve/dispatch",
        "pipeline/transform_serving", "train/profiler_capture"]
    assert [_strip(e) for e in tt.chrome_trace_events()] == \
        [_strip(e) for e in jt.chrome_trace_events()]
    assert [_strip(r.as_event()) for r in tt.finished()] == \
        [_strip(r.as_event()) for r in jt.finished()]


def test_the_flight_recorder_dumps_the_same_frames(tmp_path, monkeypatch):
    dumps = {}
    for name, fmod, omod in (("jax", jax_flightrec, jax_obs),
                             ("port", flightrec, obs)):
        ticks = iter(range(1_000_000, 2_000_000, 250))
        monkeypatch.setattr(fmod.time, "time", lambda: next(ticks) / 1e3)
        reg = omod.Registry()
        rec = fmod.install_flight_recorder(reg, str(tmp_path / name),
                                           capacity=4)
        for i in range(7):  # the ring keeps the newest 4
            fmod.record(reg, "serve_dispatch", fill=i, queue_depth=10 - i,
                        tier="beam")
        fmod.trigger(reg, "serve_dispatch", error="RuntimeError")
        fmod.trigger(reg, "serve_dispatch", error="RuntimeError")
        files = sorted(os.listdir(tmp_path / name))
        dumps[name] = {f: (tmp_path / name / f).read_text() for f in files}
        assert rec.frames()[-1]["fill"] == 6
        monkeypatch.undo()
    assert dumps["port"] == dumps["jax"]
    assert sorted(dumps["port"]) == ["flight_serve_dispatch-2.jsonl",
                                     "flight_serve_dispatch.jsonl"]
    lines = dumps["port"]["flight_serve_dispatch.jsonl"].splitlines()
    assert json.loads(lines[0])["frames"] == 4 and len(lines) == 5


def test_the_phase_ledger_is_the_jax_one_under_one_clock():
    """The same phases and walls on an injected clock give the JAX
    profiler's phase table, walls, coverage and slowest dispatches, and
    the same phase metrics (the sentinel's own parity is
    tests/test_torch_profile_sentinel.py's; the port has no compile
    ledger, and so none of its metric families)."""
    ledgers = []
    for pkg, obs_pkg in ((jax_profile, jax_obs), (profile, obs)):
        now = [0.0]
        reg = obs_pkg.Registry()
        prof = pkg.install_profiler(reg, clock=lambda: now[0])
        assert pkg.profiler_for(reg) is prof
        for dur in (0.25, 0.5, 0.125):
            w0 = prof.start()
            for phase, share in (("serve/evict", 0.1),
                                 ("serve/dispatch", 0.7)):
                t0 = prof.start()
                now[0] += dur * share
                prof.end(phase, t0, trace_id=f"t{dur}")
            now[0] += dur * 0.2  # unattributed
            prof.end_wall("serve/tick", w0)
        body = pkg.profile_payload(reg)
        ledgers.append(({k: body[k] for k in ("installed", "phases", "walls",
                                              "coverage")},
                        [{k: v for k, v in row.items() if k != "ts_us"}
                         for row in body["slowest"]],
                        prof.phase_stats(), prof.coverage(),
                        {k: v for k, v in reg.snapshot().items()
                         if k.startswith(("profile/phase", "profile/wall"))}))
    assert ledgers[0] == ledgers[1]
    assert ledgers[1][3] == pytest.approx(0.8)
    assert not profile.profile_payload(obs.Registry())["installed"]


def test_metrics_endpoint_serves_render_text(driven):
    _, treg = driven
    with obs_http.ObsHttpServer(treg, port=0) as srv:
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            body = r.read().decode()
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            health = json.loads(r.read().decode())
    assert body == treg.render_text()
    assert health["status"] == "ok"


def test_the_slo_engine_reads_the_repo_policy():
    want = os.path.join(REPO, "SLO_POLICY.json")
    assert os.path.realpath(slo.DEFAULT_POLICY_PATH) == os.path.realpath(want)
    assert slo.load_policy() == jax_slo.load_policy()
    with open(want, encoding="utf-8") as f:
        assert slo.load_policy() == json.load(f)
    treg, jreg = obs.Registry(), jax_obs.Registry()
    t_now, j_now = [0.0], [0.0]
    teng = slo.install_slo_engine(treg, clock=lambda: t_now[0])
    jeng = jax_slo.install_slo_engine(jreg, clock=lambda: j_now[0])
    assert teng is not None and jeng is not None
    for i in range(40):
        for eng, now in ((teng, t_now), (jeng, j_now)):
            now[0] = float(i)
            eng.record("paid", "beam", 0.05 if i % 4 else 9.0, i % 10 == 0)
    assert teng.evaluate(40.0) == jeng.evaluate(40.0)
    assert teng.states() == jeng.states()
    assert treg.render_text() == jreg.render_text()
