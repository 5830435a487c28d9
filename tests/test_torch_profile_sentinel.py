"""The port's profiler sentinel against the JAX package's, on the CPU:
the same virtual clock, primed costs and measured walls through both
``Profiler``s give the same achieved-rate gauges, divergence counter,
``perf_divergence`` dumps, ``divergence`` rows and ``alerts()``; the
/profile and /alerts bodies have JAX's keys; ``register_cost`` prices on
a daemon thread and a failing provider leaves the shape unpriced;
``profile_divergence_factor`` at or below 1 is refused with JAX's
message.

Mirrors the JAX package's tests/test_profile.py:113-125 (notes in the
payload) and :196-231 (the sentinel).  Exact equality throughout: both
sides do the same float arithmetic on the same inputs.  Each dump's
``ts_us`` (its write time) is left out of the comparison."""

import json
import os
import re
import threading
import urllib.request

import pytest

from textsummarization_on_flink_tpu import config as jax_config
from textsummarization_on_flink_tpu.obs import Registry as JaxRegistry
from textsummarization_on_flink_tpu.obs import flightrec as jax_flightrec
from textsummarization_on_flink_tpu.obs import profile as jax_profile
from textsummarization_on_flink_tpu_torch import config
from textsummarization_on_flink_tpu_torch.obs import Registry
from textsummarization_on_flink_tpu_torch.obs import flightrec
from textsummarization_on_flink_tpu_torch.obs import http as obs_http
from textsummarization_on_flink_tpu_torch.obs import profile

PACKAGES = {"jax": (jax_profile, jax_flightrec, JaxRegistry),
            "port": (profile, flightrec, Registry)}
#: (site, key, flops, bytes) primed on both profilers
COSTS = [("serve/dispatch", "slot_chunk25", 4.0e9, 3.0e7),
         ("serve/prefill", 400, 2.5e8, 6.0e6),
         ("train/step_dispatch", "step", 9.0e10, 4.0e8)]
#: (site, key, wall seconds): three warm-up dispatches per shape, one at
#: baseline, one 50x and one 3x past it (5x factor: only the 50x fires),
#: a second divergence of another shape, and an unpriced shape
WALLS = ([(s, k, w) for s, k, _, _ in COSTS for w in (0.02, 0.015, 0.03)]
         + [("serve/dispatch", "slot_chunk25", 0.016),
            ("serve/dispatch", "slot_chunk25", 0.75, "tr-div"),
            ("serve/dispatch", "slot_chunk25", 0.045),
            ("serve/prefill", 400, 0.9),
            ("train/step_dispatch", "step", 0.016),
            ("serve/dispatch", "tier_beam", 0.2)])


def drive(pkg, tmp_path, factor=5.0):
    """Phases, costs, walls and a note through one package's profiler
    on a virtual clock; its registry and the flight dir."""
    prof_lib, fr_lib, reg_cls = PACKAGES[pkg]
    reg = reg_cls()
    d = str(tmp_path / pkg)
    fr_lib.install_flight_recorder(reg, d, capacity=8)
    now = [0.0]
    prof = prof_lib.install_profiler(reg, clock=lambda: now[0],
                                     divergence_factor=factor)
    for site, key, flops, nbytes in COSTS:
        prof.prime_cost(site, key, flops=flops, bytes_=nbytes)
    for i, (site, key, wall, *trace) in enumerate(WALLS):
        fr_lib.record(reg, "serve_tick", tick=i)
        t0 = prof.start()
        now[0] += wall
        dt = prof.end(site, t0)
        prof.observe_dispatch(site, key, dt,
                              trace_id=trace[0] if trace else None)
    prof.note("profiler_capture", dir="/tmp/x", start_step=2, stop_step=7)
    return reg, d


def strip(rec):
    return {k: v for k, v in rec.items() if k != "ts_us"}


def read_dumps(d):
    return {f: [strip(json.loads(ln)) for ln in open(os.path.join(d, f))]
            for f in sorted(os.listdir(d))}


def sentinel_metrics(reg):
    return {k: v for k, v in reg.snapshot().items()
            if k.startswith(("profile/achieved", "profile/divergence"))}


def test_the_sentinel_is_the_jax_one_under_one_clock(tmp_path):
    regs = {pkg: drive(pkg, tmp_path) for pkg in PACKAGES}
    (jreg, jdir), (treg, tdir) = regs["jax"], regs["port"]
    jbody, tbody = (PACKAGES[p][0].profile_payload(r)
                    for p, (r, _) in regs.items())
    assert tbody["divergence"] == jbody["divergence"]
    assert sentinel_metrics(treg) == sentinel_metrics(jreg)
    assert treg.counter("profile/divergence_dumps_total").value == \
        jreg.counter("profile/divergence_dumps_total").value == 2
    assert read_dumps(tdir) == read_dumps(jdir)
    assert sorted(read_dumps(tdir)) == ["flight_perf_divergence-2.jsonl",
                                        "flight_perf_divergence.jsonl"]
    header = read_dumps(tdir)["flight_perf_divergence.jsonl"][0]
    assert header["context"]["trace_id"] == "tr-div"
    assert header["context"]["drift"] == pytest.approx(50.0, rel=0.1)
    assert profile.profile_alerts(treg) == jax_profile.profile_alerts(jreg)
    # /alerts holds the current drift: the chunk's later 3x dispatch
    # brought it back under the factor, the prefill's stays past it
    assert [r["key"] for r in profile.profile_alerts(treg)["divergence"]] \
        == ["400"]
    assert [strip(n) for n in tbody["notes"]] == \
        [strip(n) for n in jbody["notes"]]
    for k in ("phases", "walls", "coverage"):
        assert tbody[k] == jbody[k]


def test_payload_and_alerts_have_the_jax_keys(tmp_path):
    """/profile and /alerts read the same keys in both packages; the
    port's compile ledger is JAX's shape with nothing in it (eager
    PyTorch has no jit cache), installed or not."""
    treg, _ = drive("port", tmp_path)
    jreg, _ = drive("jax", tmp_path)
    for reg_t, reg_j in ((treg, jreg), (Registry(), JaxRegistry())):
        tb, jb = profile.profile_payload(reg_t), \
            jax_profile.profile_payload(reg_j)
        assert set(tb) == set(jb)
        assert set(tb["compile_ledger"]) == set(jb["compile_ledger"])
        assert set(profile.profile_alerts(reg_t)) == \
            set(jax_profile.profile_alerts(reg_j))
    assert profile.profile_payload(treg)["compile_ledger"] == {
        "warm_set": 0, "sites": {}, "events": [], "storm": None}
    assert profile.profile_alerts(treg)["compile_storm"] is None
    assert profile.profile_payload(Registry()) == \
        jax_profile.profile_payload(JaxRegistry())
    assert profile.profile_alerts(Registry()) == \
        jax_profile.profile_alerts(JaxRegistry())


def test_alerts_endpoint_serves_the_profile_key(tmp_path):
    """obs/http.py's /alerts carries profile_alerts under "profile", as
    the JAX endpoint does."""
    treg, _ = drive("port", tmp_path)
    with obs_http.ObsHttpServer(treg, port=0) as srv:
        url = f"http://127.0.0.1:{srv.port}/alerts"
        with urllib.request.urlopen(url, timeout=10) as r:
            body = json.loads(r.read().decode())
    assert body["profile"] == json.loads(json.dumps(
        profile.profile_alerts(treg)))


def test_register_cost_prices_off_thread_and_survives_a_failing_provider():
    """A provider runs once on a daemon thread (a second registration
    of the shape is a no-op); a provider that raises leaves its shape
    unpriced and its dispatches quiet."""
    reg = Registry()
    prof = profile.install_profiler(reg)
    calls, go = [], threading.Event()

    def provider():
        calls.append(threading.current_thread().name)
        go.wait(10)
        return {"flops": 8.0, "bytes": 4.0}

    def broken():
        raise RuntimeError("no price")

    prof.register_cost("serve/dispatch", "slot_chunk5", provider)
    prof.register_cost("serve/dispatch", "slot_chunk5", provider)
    prof.register_cost("serve/prefill", 100, broken)
    # in flight: the sentinel stays quiet for the shape
    prof.observe_dispatch("serve/dispatch", "slot_chunk5", 0.5)
    assert profile.profile_payload(reg)["divergence"] == []
    go.set()
    for t in list(threading.enumerate()):
        if t.name.startswith("profile-pricer-"):
            t.join(10)
    assert calls == ["profile-pricer-serve/dispatch"]
    prof.observe_dispatch("serve/dispatch", "slot_chunk5", 0.5)
    prof.observe_dispatch("serve/prefill", 100, 0.5)
    rows = profile.profile_payload(reg)["divergence"]
    assert [(r["site"], r["key"], r["flops"], r["bytes"],
             r["achieved_flops_per_s"]) for r in rows] == [
        ("serve/dispatch", "slot_chunk5", 8.0, 4.0, 16.0)]


def test_the_null_profiler_has_the_new_methods():
    """A dark registry's profiler takes every call and returns constants."""
    null = profile.profiler_for(Registry(enabled=False))
    assert null is profile.NULL_PROFILER
    assert null.register_cost("s", "k", lambda: {}) is None
    assert null.prime_cost("s", "k", 1.0, 1.0) is None
    assert null.observe_dispatch("s", "k", 1.0, trace_id="t") is None
    assert null.note("profiler_capture", dir="/x") is None


@pytest.mark.parametrize("factor", [1.0, 0.5])
def test_divergence_factor_at_or_below_one_is_refused(factor):
    """JAX's check and message (config.py:684-688)."""
    msgs = []
    for hps in (config.HParams(profile_divergence_factor=factor),
                jax_config.HParams(profile_divergence_factor=factor)):
        with pytest.raises(ValueError) as e:
            hps.validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert re.search("profile_divergence_factor must be > 1", msgs[0])
