"""Serving on a mesh: the port's slot engine sharded over dp and the
ServingServer over a sharded decoder, on four spawned gloo ranks (CPU,
dp=2 x tp=2), against the port's single rank and the JAX package's
unsharded engine.

* The JAX package's tests/test_parallel.py::TestUnifiedDpTpEndToEnd::
  test_serve_slot_engine_runs_sharded, ported: slots 4, chunk 3, four
  articles (two on each dp index, so two prefilled states cross dp),
  both families, dense and over a page arena: the chief's words equal the
  port's unsharded engine's and the JAX engine's exactly.
* The chief's arena: a continuous server over a tight arena, driven by
  tick_once, allocates, refills and backs off exactly as the single rank
  does (serve/arena_alloc_failures_total, slot_refills_total,
  prefill_total), with the same words.
* Micro-batch and continuous servers: every summary equals the single
  server's.
* The JAX package's tests/test_serve.py::
  test_sharded_decoder_rejects_non_beam_tiers_at_submit, ported (a stub
  decoder, no spawn).
* A stop and a kill with residents in flight, and an engine step that
  fails on the chief, release every rank (the world finishes within
  run_ranks' timeout); after the failure the mesh serves on.
* A hot swap on a mesh: every rank ends on the newer checkpoint's params
  fingerprint.

Tokens are compared exactly: no beam tie flipped under tp in these
cases (PR 19 measured 0 differing rows on its decode cases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh import load_json, run_ranks, save_npz, save_params
from _torch_parity import WORDS, abstract
from test_torch_slots import articles, family_case
from textsummarization_on_flink_tpu.data import batching as jax_batching
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu.decode import decoder as jax_dec
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.data import batching
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode import decoder as dec_lib
from textsummarization_on_flink_tpu_torch.serve.server import ServingServer

FAMILIES = ("pointer_generator", "transformer")
#: the engine's articles: one in each slot of dp indices 0 and 1
ENGINE_LENS = (1, 4, 9, 24)
#: the servers' articles
SERVE_LENS = (3, 24, 9, 1, 14, 6, 20, 4)
SLOTS, CHUNK = 4, 3
MESH = dict(dp=2, tp=2)
#: a paged arena too small for every engine article at once (1+1+3+6
#: pages of 4 tokens) and, for the tight server, for two long ones
ARENA_PAGES, TIGHT_PAGES = 12, 8
SERVE = dict(serve_slots=SLOTS, serve_refill_chunk=CHUNK,
             serve_max_wait_ms=20.0, serve_max_queue=64)
SERVERS = {
    "pg_microbatch": ("pointer_generator", "serve",
                      dict(serve_mode="microbatch")),
    "pg_continuous": ("pointer_generator", "serve",
                      dict(serve_mode="continuous")),
    "tf_tight_arena": ("transformer", "ticks",
                       dict(serve_mode="continuous",
                            serve_arena_pages=TIGHT_PAGES)),
    "pg_kill": ("pointer_generator", "kill", dict(serve_mode="continuous")),
    # dp=4, one slot per rank: the chief's step fails before any
    # collective of the op (a failure between a tp group's collectives
    # leaves its peers waiting out the process group's timeout)
    "pg_fail": ("pointer_generator", "fail", dict(serve_mode="continuous")),
    "pg_swap": ("pointer_generator", "swap", dict(serve_mode="microbatch")),
}


def _fields(thps, **kw):
    import dataclasses

    out = {f.name: getattr(thps, f.name)
           for f in dataclasses.fields(thps) if f.name != "device"}
    out.update(kw)
    return out


def _texts(lens):
    arts = articles(lens)
    return arts, [abstract(i) for i in range(len(arts))]


def _engine_cases(work):
    cases = []
    for family in FAMILIES:
        _, thps, p = family_case(family)
        save_params(work, f"params_{family}", p)
        arts, abss = _texts(ENGINE_LENS)
        for paged in (False, True):
            kw = dict(MESH, serve_arena_pages=ARENA_PAGES if paged else 0)
            cases.append({"name": f"engine_{family}_{_mode(paged)}",
                          "kind": "slot_engine", "slots": SLOTS,
                          "chunk": CHUNK, "params": f"params_{family}",
                          "words": list(WORDS), "articles": arts,
                          "abstracts": abss, "hps": _fields(thps, **kw)})
    return cases


def _mode(paged):
    return "paged" if paged else "dense"


def _server_hps(family, **kw):
    _, thps, _ = family_case(family)
    return thps.replace(**SERVE, **kw)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve4")
    cases = _engine_cases(work)
    _, _, pg_p = family_case("pointer_generator")
    save_npz(work, "newer", ckpt_lib._flatten({"params": _halved(pg_p)},
                                              ""))
    arts, abss = _texts(SERVE_LENS)
    for name, (family, how, kw) in SERVERS.items():
        mesh = dict(dp=4, tp=1) if how == "fail" else MESH
        cases.append({"name": name, "kind": "serve", "how": how,
                      "params": f"params_{family}", "newer": "newer",
                      "words": list(WORDS), "articles": arts,
                      "abstracts": abss,
                      "hps": _fields(_server_hps(family, **kw), **mesh)})
    run_ranks(work, 4, cases, timeout=300.0)
    return work


def _halved(p):
    if isinstance(p, dict):
        return {k: _halved(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_halved(v) for v in p]
    return p * np.float32(0.5)


def _run_engine(eng, exs, steps):
    for i, ex in enumerate(exs):
        eng.pack(i, ex)
    results = {}
    for _ in range(steps):
        for idx in eng.step():
            results[idx] = eng.unpack(idx, exs[idx])
        if len(results) == len(exs):
            break
    assert len(results) == len(exs)
    return [results[i].decoded_words for i in range(len(exs))]


def _port_engine_words(thps, p, root):
    vocab = Vocab(words=WORDS)
    arts, abss = _texts(ENGINE_LENS)
    exs = [batching.SummaryExample.build(a, [r], vocab, thps, uuid=f"u{i}")
           for i, (a, r) in enumerate(zip(arts, abss))]
    dec = dec_lib.BeamSearchDecoder(thps, vocab, batcher=None, params=p,
                                    decode_root=root)
    return _run_engine(dec.slot_engine(SLOTS, CHUNK), exs,
                       thps.max_dec_steps + 2)


def _jax_engine_words(jhps, p, root):
    vocab = JaxVocab(words=WORDS)
    arts, abss = _texts(ENGINE_LENS)
    exs = [jax_batching.SummaryExample.build(a, [r], vocab, jhps,
                                             uuid=f"u{i}")
           for i, (a, r) in enumerate(zip(arts, abss))]
    dec = jax_dec.BeamSearchDecoder(
        jhps, vocab, batcher=None,
        params=jax.tree_util.tree_map(jnp.asarray, p), decode_root=root)
    return _run_engine(dec.slot_engine(slots=SLOTS, chunk=CHUNK), exs,
                       jhps.max_dec_steps + 2)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("family", FAMILIES)
def test_serve_slot_engine_runs_sharded(world4, tmp_path, family, paged):
    """The JAX package's test, ported to four ranks: the chief's words
    equal the port's unsharded engine's and the JAX engine's; each rank
    holds slots/dp residents; two prefilled states crossed dp as
    tensors."""
    jhps, thps, p = family_case(family)
    pages = ARENA_PAGES if paged else 0
    want_port = _port_engine_words(thps.replace(serve_arena_pages=pages), p,
                                   str(tmp_path / "port"))
    want_jax = _jax_engine_words(jhps.replace(serve_arena_pages=pages), p,
                                 str(tmp_path / "jax"))
    assert want_port == want_jax
    name = f"engine_{family}_{_mode(paged)}"
    ranks = [load_json(world4, f"{name}.rank{r}") for r in range(4)]
    assert ranks[0]["words"] == want_port
    if paged:
        assert ranks[0]["free_pages"] == ARENA_PAGES  # every page back
    for info in ranks:
        lead = [v[0] for k, v in info["cache_sizes"].items()
                if k.startswith("beam.")]
        assert lead and set(lead) == {SLOTS // MESH["dp"]}
    for info in ranks[1:]:
        assert info["ops"] > 0
    # dp index 0's ranks (0, 1) sent two prefilled states to index 1's
    # (2, 3); the owners' tp-0 rank (2) sent two results to the chief
    for r in (0, 1, 2, 3):
        assert ranks[r]["bytes"].get("send_recv/dp", 0.0) > 0
    assert ranks[0]["bytes"]["command/world"] > 0


def _single_server(family, how, kw, root):
    """The port's single-rank server on the same articles: (words by uuid,
    its counters)."""
    from textsummarization_on_flink_tpu_torch.obs import Registry

    _, _, p = family_case(family)
    hps = _server_hps(family, **kw)
    arts, abss = _texts(SERVE_LENS)
    reg = Registry()
    server = ServingServer(hps, Vocab(words=WORDS), params=p,
                           decode_root=root, registry=reg)
    if how == "ticks":
        futs = {f"u{i}": server.submit(a, uuid=f"u{i}", reference=r)
                for i, (a, r) in enumerate(zip(arts, abss))}
        for _ in range(500):
            if all(f.done() for f in futs.values()):
                break
            server.tick_once()
        server.stop()
    else:
        with server:
            futs = {f"u{i}": server.submit(a, uuid=f"u{i}", reference=r,
                                           block=True)
                    for i, (a, r) in enumerate(zip(arts, abss))}
    words = {u: f.result(timeout=60).decoded_words for u, f in futs.items()}
    counters = {k: reg.counter(f"serve/{k}").value for k in (
        "arena_alloc_failures_total", "slot_refills_total",
        "completed_total", "errors_total", "prefill_total")}
    return words, counters


@pytest.mark.parametrize("name", ["pg_microbatch", "pg_continuous"])
def test_mesh_servers_equal_the_single_server(world4, tmp_path, name):
    family, how, kw = SERVERS[name]
    want, _ = _single_server(family, how, kw, str(tmp_path))
    chief = load_json(world4, f"{name}.rank0")
    assert chief["errors"] == {}
    assert chief["words"] == want
    for r in range(1, 4):
        assert load_json(world4, f"{name}.rank{r}")["ops"] > 0


def test_chief_arena_equals_the_single_rank(world4, tmp_path):
    """Admission, backpressure and the allocation failures of the chief's
    PageArena are the single rank's, tick for tick."""
    family, how, kw = SERVERS["tf_tight_arena"]
    want_words, want = _single_server(family, how, kw, str(tmp_path))
    chief = load_json(world4, "tf_tight_arena.rank0")
    assert want["arena_alloc_failures_total"] > 0  # the arena did bind
    assert chief["counters"] == want
    assert chief["words"] == want_words


def test_stop_and_kill_leave_no_rank_waiting(world4):
    """A stop (pg_continuous: residents in flight at the stop call, every
    request drained) and a kill after the first result: every rank's loop
    returned (the world finished), the kill's rejections are typed."""
    stopped = load_json(world4, "pg_continuous.rank0")
    assert len(stopped["words"]) == len(SERVE_LENS)
    killed = load_json(world4, "pg_kill.rank0")
    assert len(killed["words"]) + len(killed["errors"]) == len(SERVE_LENS)
    assert killed["rejected"] == len(killed["errors"])
    assert all("ReplicaKilledError" in e for e in killed["errors"].values())
    for name in ("pg_continuous", "pg_kill"):
        for r in range(1, 4):
            assert load_json(world4, f"{name}.rank{r}")["ops"] > 0


def test_failed_dispatch_reaches_the_followers(world4):
    """The chief's second engine step raises: the followers raise the same
    op (collectives.all_ok) and take the next; the residents of the
    failed tick are rejected with the cause, the rest are served."""
    chief = load_json(world4, "pg_fail.rank0")
    assert chief["errors"]
    assert all("injected step failure" in e
               for e in chief["errors"].values())
    assert chief["words"]
    assert len(chief["words"]) + len(chief["errors"]) == len(SERVE_LENS)


def test_hot_swap_moves_every_rank(world4):
    infos = [load_json(world4, f"pg_swap.rank{r}") for r in range(4)]
    chief = infos[0]
    assert chief["swapped"]
    first, second = chief["fingerprints"]
    assert first != second
    flat = ckpt_lib.load_arrays(str(world4 / "pg_swap" / "train" /
                                    "model.ckpt-2.npz"))
    want = ckpt_lib.content_fingerprint(
        ckpt_lib._unflatten_dicts(flat)["params"])
    assert second == want
    assert {i["fingerprint"] for i in infos} == {want}


def test_sharded_decoder_rejects_non_beam_tiers_at_submit():
    """JAX tests/test_serve.py's test, ported: a mesh decoder serves the
    beam tier only, and a refusal is synchronous, at submit."""
    from test_torch_serve import StubDecoder, make_vocab, tiny_hps

    dec = StubDecoder(has_draft=True)
    dec.sharded = True
    with obs.use_registry(obs.Registry()) as reg:
        server = ServingServer(tiny_hps(), make_vocab(), decoder=dec,
                               registry=reg)
        with server:
            with pytest.raises(ValueError, match="beam tier only"):
                server.submit("the cat .", tier="greedy")
            with pytest.raises(ValueError, match="beam tier only"):
                server.submit("the cat .", tier="spec")
            assert server.submit("the cat .", uuid="b0",
                                 tier="beam").result(timeout=30).uuid == "b0"


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serve_roles_follow_the_jax_table(tmp_path, paged):
    """The registry's serve specs (JAX parallel/sharding.py:235-307): the
    resident state's slot-leading leaves over dp, a paged state's pools
    replicated; a prefill batch over dp when its rows divide dp."""
    import dataclasses

    import torch.utils._pytree as pytree

    from textsummarization_on_flink_tpu_torch.parallel import sharding

    _, thps, p = family_case("pointer_generator")
    thps = thps.replace(serve_arena_pages=ARENA_PAGES if paged else 0)
    vocab = Vocab(words=WORDS)
    dec = dec_lib.BeamSearchDecoder(thps, vocab, batcher=None, params=p,
                                    decode_root=str(tmp_path))
    eng = dec.slot_engine(SLOTS, CHUNK)
    eng.pack(0, batching.SummaryExample.build(articles((5,))[0], [], vocab,
                                              thps))
    specs = sharding.slot_state_specs(eng._state)
    pools = ("enc_pages", "ext_pool", "attn_pool") if paged else ()
    for f in dataclasses.fields(specs):
        want = sharding.Spec() if f.name in pools else sharding.Spec("dp")
        for leaf in pytree.tree_leaves(getattr(specs, f.name),
                                       is_leaf=lambda x: isinstance(
                                           x, sharding.Spec)):
            assert leaf == want, f.name
    if paged:
        assert specs.attn_pool == sharding.arena_pool_spec() == \
            sharding.page_table_spec() == sharding.Spec()
    assert sharding.prefill_batch_spec(2, 1) == sharding.Spec()
    assert sharding.prefill_batch_spec(2, 4) == sharding.Spec("dp")
    assert sharding.prefill_batch_spec(4, 2) == sharding.Spec()
    # the registry's prefill state: its leaves take the batch's rule (one
    # rank here: dp = 1 divides the one row)
    from textsummarization_on_flink_tpu_torch.parallel import mesh

    reg = mesh.make_mesh(thps).registry
    pre = eng.prefill(batching.SummaryExample.build(
        articles((7,))[0], [], vocab, thps)).state
    pspecs = reg.prefill_state_specs(pre)
    assert pspecs.enc_mask == pspecs.ext_ids == reg.prefill_batch_spec(1)
    assert all(x == reg.prefill_batch_spec(1) for x in pytree.tree_leaves(
        pspecs.enc_view, is_leaf=lambda x: isinstance(x, sharding.Spec)))
    assert set(reg.prefill_batch_specs(4)) == set(reg.slot_batch_specs())
