"""The port's hierarchical summarization (serve/hiersum.py,
decode/reduce.py, the document framing of pipeline/codec.py and
``transform(hierarchical=True)``) on the CPU.

  * the pieces against the JAX package's on the same inputs:
    ``chunk_document`` over lengths, chunk widths and overlaps (the
    append path's boundaries among them), ``assemble_reduce_input`` (over
    budget, more chunks than words), ``ngram_containment``, and the
    framing: ``frame_document_rows``, ``parse_document_frame`` and
    ``DocumentAssembler`` with their errors;
  * ``HierarchicalSummarizer`` over a ServingServer and over a
    FleetRouter in both packages, at a tiny pointer-generator width over
    one numpy params tree: the same document summaries, chunk keys and
    cache hits on an append, and ``HierPartialFailureError`` naming the
    same chunks; ``transform(hierarchical=True)`` writes the JAX
    package's rows from one JAX checkpoint;
  * the JAX package's unit tests (tests/test_hiersum.py) against the
    port's classes.
"""

import json
import os
import shlex
import socketserver
import sys
import threading

import pytest

from _torch_parity import WORDS as PARITY_WORDS
from _torch_parity import article, decode_params, make_hps
from textsummarization_on_flink_tpu import config as jax_config
from textsummarization_on_flink_tpu import obs as jax_obs
from textsummarization_on_flink_tpu.checkpoint import (
    checkpointer as jax_ckpt,
)
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu.decode import reduce as jax_reduce
from textsummarization_on_flink_tpu.pipeline import codec as jax_codec
from textsummarization_on_flink_tpu.pipeline import estimator as jax_est
from textsummarization_on_flink_tpu.pipeline import io as jax_io
from textsummarization_on_flink_tpu.serve import errors as jax_errors
from textsummarization_on_flink_tpu.serve import fleet as jax_fleet
from textsummarization_on_flink_tpu.serve import hiersum as jax_hiersum
from textsummarization_on_flink_tpu.serve.server import (
    ServingServer as JaxServingServer,
)
from textsummarization_on_flink_tpu.train import trainer as jax_trainer
from textsummarization_on_flink_tpu_torch import config as torch_config
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.decode import reduce as torch_reduce
from textsummarization_on_flink_tpu_torch.decode.decoder import DecodedResult
from textsummarization_on_flink_tpu_torch.decode.reduce import (
    assemble_reduce_input,
)
from textsummarization_on_flink_tpu_torch.obs import Registry
from textsummarization_on_flink_tpu_torch.obs.export import MemorySink
from textsummarization_on_flink_tpu_torch.pipeline import codec as codec_lib
from textsummarization_on_flink_tpu_torch.pipeline import estimator as est_lib
from textsummarization_on_flink_tpu_torch.pipeline import io as io_lib
from textsummarization_on_flink_tpu_torch.serve import errors as torch_errors
from textsummarization_on_flink_tpu_torch.serve import fleet as torch_fleet
from textsummarization_on_flink_tpu_torch.serve import hiersum as torch_hiersum
from textsummarization_on_flink_tpu_torch.serve import server as server_mod
from textsummarization_on_flink_tpu_torch.serve.errors import (
    HierPartialFailureError,
)
from textsummarization_on_flink_tpu_torch.serve.frontdoor import article_key
from textsummarization_on_flink_tpu_torch.serve.hiersum import (
    DocumentSession,
    HierarchicalSummarizer,
    chunk_document,
    ngram_containment,
)
from textsummarization_on_flink_tpu_torch.serve.server import ServingServer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import trace_summary  # noqa: E402


def HParams(**kw):
    """The port's HParams (the stub servers touch no device)."""
    return torch_config.HParams(**kw)


# -- the pieces, against the JAX package's ---------------------------------

CHUNK_CASES = [(n, c, o) for n in (0, 1, 5, 16, 17, 40, 101)
               for c, o in ((1, 0), (4, 0), (4, 3), (16, 4), (16, 15))]


@pytest.mark.parametrize("n_words,chunk,overlap", CHUNK_CASES)
def test_chunk_document_equals_jax(n_words, chunk, overlap):
    doc = " ".join(f"w{i}" for i in range(n_words))
    got = chunk_document(doc, chunk, overlap)
    assert got == jax_hiersum.chunk_document(doc, chunk, overlap)
    assert [article_key(c, 16) for c in got] == [
        jax_hiersum.article_key(c, 16) for c in got]


@pytest.mark.parametrize("old,grown", [(24, 60), (20, 44), (60, 61),
                                       (64, 104)])
def test_append_boundaries_equal_jax(old, grown):
    """The append path: the chunks of the grown document that the old
    one already had whole keep their keys, in both packages."""
    words = [f"w{i}" for i in range(grown)]
    a, b = " ".join(words[:old]), " ".join(words)
    for fn in (chunk_document, jax_hiersum.chunk_document):
        before, after = fn(a, 24, 4), fn(b, 24, 4)
        full = [c for c in before if len(c.split()) == 24]
        assert after[:len(full)] == full
    assert chunk_document(b, 24, 4) == jax_hiersum.chunk_document(b, 24, 4)


@pytest.mark.parametrize("chunk,overlap", [(0, 0), (4, 4), (4, 5)])
def test_chunk_document_refusals_equal_jax(chunk, overlap):
    msgs = []
    for fn in (chunk_document, jax_hiersum.chunk_document):
        with pytest.raises(ValueError) as e:
            fn("a b c", chunk, overlap)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


REDUCE_CASES = [
    ([["a", "b"], ["c"]], 10),
    ([["a1", "a2", "a3"], ["b1", "b2", "b3"], ["c1", "c2", "c3"]], 6),
    ([["a1", "a2", "a3"], ["b1"], ["c1", "c2", "c3", "c4"]], 5),
    ([[f"w{i}"] for i in range(8)], 3),
    ([[f"w{i}", f"x{i}"] for i in range(30)], 7),
    ([[], ["a"], []], 4),
    ([[], []], 4),
    ([["a"] * 50], 24),
]


@pytest.mark.parametrize("summaries,max_words", REDUCE_CASES)
def test_assemble_reduce_input_equals_jax(summaries, max_words):
    got = assemble_reduce_input(summaries, max_words)
    assert got == jax_reduce.assemble_reduce_input(summaries, max_words)
    assert len(got.split()) <= max_words


def test_assemble_reduce_input_refusal_equals_jax():
    for fn in (torch_reduce.assemble_reduce_input,
               jax_reduce.assemble_reduce_input):
        with pytest.raises(ValueError, match="max_words must be >= 1"):
            fn([["a"]], 0)


CONTAINMENT_CASES = [
    ("a b c", ["x a b c y"], 2), ("a b z q", ["a b c d"], 2),
    ("a b c d", ["a b", "c d", "b c"], 2), ("a", ["a b"], 2),
    ("z", ["a b"], 2), ("", ["a"], 2), ("a b c d e", ["a b c", "d e"], 3),
    ("a b c d e", ["e d c b a"], 1),
]


@pytest.mark.parametrize("words,sources,n", CONTAINMENT_CASES)
def test_ngram_containment_equals_jax(words, sources, n):
    w, s = words.split(), [x.split() for x in sources]
    assert ngram_containment(w, s, n) == \
        jax_hiersum.ngram_containment(w, s, n)


FRAME_CASES = [("d1", "a b c d e", "ref", 2), ("d", "a b", "r", 8),
               ("doc#x", " ".join(f"w{i}" for i in range(301)), "", 300),
               ("d", "x " * 7, "r", 1)]


@pytest.mark.parametrize("uuid,text,ref,width", FRAME_CASES)
def test_frame_document_rows_byte_equal_jax(uuid, text, ref, width):
    got = codec_lib.frame_document_rows(uuid, text, ref, width)
    want = jax_codec.frame_document_rows(uuid, text, ref, width)
    assert got == want
    assert [json.dumps(r) for r in got] == [json.dumps(r) for r in want]


@pytest.mark.parametrize("uuid", ["d#1/3", "d#0/2", "a#b#2/2", "plain",
                                  "d#1/", "#1/1", "d#12/7", "d#x/2"])
def test_parse_document_frame_equals_jax(uuid):
    assert codec_lib.parse_document_frame(uuid) == \
        jax_codec.parse_document_frame(uuid)


ASSEMBLER_STREAMS = {
    "in order": [("d#1/2", "a b", "r"), ("d#2/2", "c", "")],
    "out of order": [("d#2/2", "c", ""), ("d#1/2", "a b", "r")],
    "unframed": [("plain", "text", "ref")],
    "revision": [("d#1/1", "first", "r"), ("d#1/1", "second", "")],
    "interleaved": [("a#1/2", "x", ""), ("b#1/1", "y", "q"),
                    ("a#2/2", "z", "s")],
    "total mismatch": [("d#1/3", "a", ""), ("d#2/4", "b", "")],
    "duplicate": [("d#1/2", "a", ""), ("d#1/2", "a", "")],
    "out of range": [("e#3/2", "x", "")],
    "zero total": [("e#0/0", "x", "")],
    "truncated": [("d#1/2", "a", "")],
}


def _assemble(codec, reg, stream):
    asm = codec.DocumentAssembler(registry=reg)
    out = []
    for row in stream:
        try:
            out.append(asm.feed(row))
        except ValueError as e:
            out.append((type(e).__name__, str(e)))
            break
    return out, asm.pending(), reg.counter(
        "pipeline/codec_errors_total").value


@pytest.mark.parametrize("name", sorted(ASSEMBLER_STREAMS))
def test_document_assembler_equals_jax(name):
    stream = ASSEMBLER_STREAMS[name]
    assert _assemble(codec_lib, Registry(), stream) == \
        _assemble(jax_codec, jax_obs.Registry(), stream)


@pytest.mark.parametrize("uuid,text,width,match", [
    ("d", "a", 0, "frame_words"), ("d", "  ", 4, "no words")])
def test_frame_refusals_equal_jax(uuid, text, width, match):
    for codec in (codec_lib, jax_codec):
        with pytest.raises(ValueError, match=match):
            codec.frame_document_rows(uuid, text, "", width)


# -- end to end over a tiny real model, against the JAX package ------------

HIER = dict(coverage=True, batch_size=4, serve_max_wait_ms=20.0,
            serve_coalesce=True, serve_cache_entries=64,
            hier_overlap_words=4)
#: 3 chunks of 24 words at stride 20 end exactly on a boundary; the
#: revision appends 40 words, two more chunks
REV_WORDS, TAIL_WORDS = 64, 40

PKGS = {
    "jax": dict(Server=JaxServingServer, Vocab=JaxVocab,
                Registry=jax_obs.Registry, hiersum=jax_hiersum,
                FleetRouter=jax_fleet.FleetRouter,
                HierError=jax_errors.HierPartialFailureError),
    "port": dict(Server=ServingServer, Vocab=Vocab, Registry=Registry,
                 hiersum=torch_hiersum, FleetRouter=torch_fleet.FleetRouter,
                 HierError=torch_errors.HierPartialFailureError),
}


def _document():
    words = " ".join(article(i, 20) for i in range(8)).split()
    return " ".join(words[:REV_WORDS]), " ".join(
        words[REV_WORDS:REV_WORDS + TAIL_WORDS])


@pytest.fixture(scope="module")
def hier_params():
    _, thps = make_hps(**HIER)
    return decode_params(thps, len(PARITY_WORDS) + 4, seed=23)


def _surface(pkg, kind, params, root, **kw):
    P = PKGS[pkg]
    jhps, thps = make_hps(**dict(HIER, **kw))
    hps = jhps if pkg == "jax" else thps
    n = 2 if kind == "fleet" else 1
    servers = [P["Server"](hps, P["Vocab"](words=PARITY_WORDS),
                           params=params, decode_root=str(root / f"r{i}"),
                           registry=P["Registry"]())
               for i in range(n)]
    reg = P["Registry"]()
    if kind == "fleet":
        return P["FleetRouter"](servers, hps, registry=reg), hps, reg
    # a lone server keeps its own registry: its front door counts there
    return servers[0], hps, servers[0].registry


def _hier_run(pkg, kind, params, root):
    """One document, then a revision that appends two chunks; returns
    the summaries, the chunk keys and the counters of both passes."""
    P = PKGS[pkg]
    surface, hps, reg = _surface(pkg, kind, params, root)
    hs = P["hiersum"].HierarchicalSummarizer(surface, hps, registry=reg)
    doc, tail = _document()
    sess = P["hiersum"].DocumentSession("doc", doc)
    out = {}
    with surface:
        r1 = hs.summarize("", session=sess).result(timeout=120)
        keys1 = list(sess.chunk_keys)
        hits1 = reg.counter("serve/hier_chunk_cache_hits_total").value
        sess.append(tail)
        r2 = hs.summarize("", session=sess).result(timeout=120)
    out.update(
        summaries=[r1.decoded_words, r2.decoded_words],
        keys=[keys1, list(sess.chunk_keys)],
        chunks=[r1.chunk_count, r2.chunk_count],
        reused=[r1.reused_chunks, r2.reused_chunks],
        hits=[hits1, reg.counter(
            "serve/hier_chunk_cache_hits_total").value - hits1],
        fidelity=[r1.copy_fidelity, r2.copy_fidelity],
        uuids=[r1.uuid, r2.uuid])
    return out


@pytest.fixture(scope="module")
def hier_runs(hier_params, tmp_path_factory):
    return {(pkg, kind): _hier_run(pkg, kind, hier_params,
                                   tmp_path_factory.mktemp(f"{pkg}{kind}"))
            for pkg in ("jax", "port") for kind in ("server", "fleet")}


@pytest.mark.parametrize("kind", ["server", "fleet"])
def test_hierarchical_summaries_equal_jax(hier_runs, kind):
    got, want = hier_runs[("port", kind)], hier_runs[("jax", kind)]
    assert got == want
    assert got["uuids"] == ["doc@r1", "doc@r2"]
    assert got["chunks"] == [3, 5]
    # the revision decoded only its two tail chunks: the three it kept
    # whole hit the front door's cache
    assert got["reused"] == [0, 3] and got["hits"] == [0, 3]
    assert got["keys"][1][:3] == got["keys"][0]
    assert all(got["summaries"])


def test_hierarchical_over_a_fleet_equals_over_a_server(hier_runs):
    a, b = hier_runs[("port", "server")], hier_runs[("port", "fleet")]
    assert a["summaries"] == b["summaries"] and a["keys"] == b["keys"]


def test_hierarchical_summary_is_the_chunks_then_one_reduce(
        hier_runs, hier_params, tmp_path):
    """The document's summary is what its chunks give decoded one at a
    time on the greedy tier, assembled, and decoded once on beam."""
    server, hps, _ = _surface("port", "server", hier_params, tmp_path,
                              serve_cache_entries=0, serve_coalesce=False)
    doc, _ = _document()
    chunks = chunk_document(doc, hps.max_enc_steps, hps.hier_overlap_words)
    with server:
        words = [server.submit(c, uuid=f"c{i}", tier="greedy").result(
            timeout=120).decoded_words for i, c in enumerate(chunks)]
        red = server.submit(
            assemble_reduce_input(words, hps.max_enc_steps), uuid="r",
            tier="beam").result(timeout=120)
    assert red.decoded_words == hier_runs[("port", "server")][
        "summaries"][0]


def _partial_failure(pkg, params, root):
    """serve.dispatch fires once with every chunk dispatched alone, the
    chunks queued before the dispatch thread starts: chunk 0 fails."""
    P = PKGS[pkg]
    surface, hps, reg = _surface(pkg, "server", params, root,
                                 serve_max_batch=1,
                                 faults="serve.dispatch:1.0:0:1")
    hs = P["hiersum"].HierarchicalSummarizer(surface, hps, registry=reg)
    fut = hs.summarize(_document()[0], uuid="doc")
    with surface:
        with pytest.raises(P["HierError"]) as e:
            fut.result(timeout=120)
    return (sorted(e.value.failed), e.value.chunks,
            reg.counter("serve/hier_reduce_total").value,
            reg.counter("serve/completed_total").value)


def test_partial_failure_names_the_jax_chunks(hier_params, tmp_path):
    got = _partial_failure("port", hier_params, tmp_path / "port")
    assert got == _partial_failure("jax", hier_params, tmp_path / "jax")
    assert got == ([0], 3, 0, 2)


TRANSFORM_FIELDS = dict(batch_size=4, hidden_dim=8, emb_dim=6,
                        max_enc_steps=12, max_dec_steps=6, beam_size=2,
                        min_dec_steps=1, max_oov_buckets=4, exp_name="exp",
                        mode="decode", serve_coalesce=True,
                        serve_cache_entries=32, hier_overlap_words=2)


def _hier_transform_model(pkg, root):
    vsize = len(PARITY_WORDS) + 4
    if pkg == "jax":
        m, hps = jax_est, jax_config.HParams(
            log_root=str(root), vocab_size=vsize, **TRANSFORM_FIELDS)
        vocab = JaxVocab(words=PARITY_WORDS)
    else:
        m, hps = est_lib, torch_config.HParams(
            log_root=str(root), vocab_size=vsize, device="cpu",
            **TRANSFORM_FIELDS)
        vocab = Vocab(words=PARITY_WORDS)
    model = m.SummarizationModel()
    (model.set_inference_selected_cols(["uuid", "article", "reference"])
     .set_inference_output_cols(["uuid", "article", "summary",
                                 "reference"]))
    model.set_inference_hyper_params(shlex.split(hps.to_argv()))
    return model.with_vocab(vocab)


def test_transform_hierarchical_writes_the_jax_rows(tmp_path):
    """One JAX checkpoint read by both: two documents as framed rows,
    then a revision of the first; one row per document revision."""
    vsize = len(PARITY_WORDS) + 4
    fields = {k: v for k, v in TRANSFORM_FIELDS.items()
              if k not in ("exp_name",)}
    p = decode_params(make_hps(**dict(fields, vocab_size=vsize))[1], vsize,
                      seed=5, stop_bias=1.0)
    doc, tail = _document()
    frames = (codec_lib.frame_document_rows("d1", doc, "ref one", 30)
              + codec_lib.frame_document_rows("d2", tail, "ref two", 30)
              + codec_lib.frame_document_rows("d1", tail, "", 30))
    rows = [(u, a, "", r) for u, a, r in frames]
    out = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        jhps = jax_config.HParams(vocab_size=vsize, **TRANSFORM_FIELDS)
        state = jax_trainer.init_train_state(jhps, vsize, params=p)
        jax_ckpt.Checkpointer(os.path.join(str(root), "exp", "train"),
                              hps=jhps).save(state)
        io_mod = jax_io if pkg == "jax" else io_lib
        reg = jax_obs.Registry() if pkg == "jax" else Registry()
        use = jax_obs.use_registry if pkg == "jax" else obs.use_registry
        with use(reg):
            sink = _hier_transform_model(pkg, root).transform(
                io_mod.CollectionSource(rows), hierarchical=True)
        out[pkg] = (sorted(sink.rows), reg)
    got, want = out["port"][0], out["jax"][0]
    assert [r[0] for r in got] == ["d1@r1", "d1@r2", "d2@r1"]
    assert got == want
    assert all(r[2] for r in got)
    reg = out["port"][1]
    assert reg.counter("pipeline/rows_out_total").value == 3
    assert reg.counter("serve/hier_documents_total").value == 3


# -- the JAX package's unit tests against the port -------------------------

WORDS = ["w"]


@pytest.fixture(autouse=True)
def _isolated_obs():
    with obs.use_registry(Registry()) as reg:
        yield reg


# -- chunking --------------------------------------------------------------

class TestChunkDocument:
    def test_no_overlap_splits_on_stride(self):
        assert chunk_document("a b c d e f", 2) == ["a b", "c d", "e f"]

    def test_overlap_repeats_boundary_words(self):
        assert chunk_document("a b c d e f g h", 4, 1) == \
            ["a b c d", "d e f g", "g h"]

    def test_last_chunk_reaches_document_end(self):
        chunks = chunk_document("a b c d e", 2)
        assert chunks[-1] == "e"
        assert " ".join(chunks) == "a b c d e"

    def test_single_chunk_document(self):
        assert chunk_document("a b", 8, 2) == ["a b"]

    def test_empty_document_yields_nothing(self):
        assert chunk_document("   ", 4) == []

    def test_append_keeps_prior_chunks_byte_identical(self):
        """The cache lever: chunk boundaries are a pure function of
        word index, so growing the document leaves every previously
        COMPLETE chunk unchanged (same words -> same article_key)."""
        words = [f"w{i}" for i in range(100)]
        doc = " ".join(words)
        grown = " ".join(words + [f"w{i}" for i in range(100, 180)])
        old = chunk_document(doc, 16, 4)
        new = chunk_document(grown, 16, 4)
        # every old chunk that was full (16 words) survives verbatim
        full = [c for c in old if len(c.split()) == 16]
        assert new[:len(full)] == full
        assert [article_key(c, 16) for c in new[:len(full)]] == \
            [article_key(c, 16) for c in full]

    def test_validation(self):
        with pytest.raises(ValueError, match="chunk_words"):
            chunk_document("a", 0)
        with pytest.raises(ValueError, match="overlap_words"):
            chunk_document("a", 4, 4)


# -- copy fidelity ---------------------------------------------------------

class TestNgramContainment:
    def test_fully_grounded_scores_one(self):
        assert ngram_containment("a b c".split(),
                                 ["x a b c y".split()]) == 1.0

    def test_fabricated_ngrams_lower_the_score(self):
        s = ngram_containment("a b z q".split(), ["a b c d".split()])
        assert 0.0 < s < 1.0

    def test_union_over_sources(self):
        assert ngram_containment(
            "a b c d".split(), ["a b".split(), "c d".split(),
                                "b c".split()]) == 1.0

    def test_short_text_falls_back_to_unigrams(self):
        assert ngram_containment(["a"], [["a", "b"]]) == 1.0
        assert ngram_containment(["z"], [["a", "b"]]) == 0.0

    def test_empty_target_scores_one(self):
        assert ngram_containment([], [["a"]]) == 1.0


# -- reduce-input budgeting ------------------------------------------------

class TestAssembleReduceInput:
    def test_verbatim_when_under_budget(self):
        assert assemble_reduce_input([["a", "b"], ["c"]], 10) == "a b c"

    def test_over_budget_keeps_every_chunk_represented(self):
        out = assemble_reduce_input(
            [["a1", "a2", "a3"], ["b1", "b2", "b3"], ["c1", "c2", "c3"]],
            6).split()
        # equal front-budget per chunk: no chunk is silently deleted
        assert out == ["a1", "a2", "b1", "b2", "c1", "c2"]

    def test_extreme_fanout_hard_cap_drops_trailing_chunks_last(self):
        out = assemble_reduce_input([[f"w{i}"] for i in range(8)], 3)
        assert out.split() == ["w0", "w1", "w2"]

    def test_empty_summaries_skipped_and_all_empty_yields_empty(self):
        assert assemble_reduce_input([[], ["a"], []], 4) == "a"
        assert assemble_reduce_input([[], []], 4) == ""

    def test_validation(self):
        with pytest.raises(ValueError, match="max_words"):
            assemble_reduce_input([["a"]], 0)


# -- document framing (pipeline/codec.py) ----------------------------------

class TestDocumentFraming:
    def test_frame_roundtrip(self, _isolated_obs):
        rows = codec_lib.frame_document_rows("d1", "a b c d e", "ref", 2)
        assert [r[0] for r in rows] == ["d1#1/3", "d1#2/3", "d1#3/3"]
        assert rows[0][2] == "ref" and rows[1][2] == ""
        asm = codec_lib.DocumentAssembler(registry=_isolated_obs)
        out = [asm.feed(r) for r in rows]
        assert out[:2] == [None, None]
        assert out[2] == ("d1", "a b c d e", "ref")

    def test_out_of_order_parts_reassemble(self, _isolated_obs):
        rows = codec_lib.frame_document_rows("d", "a b c d", "r", 2)
        asm = codec_lib.DocumentAssembler(registry=_isolated_obs)
        assert asm.feed(rows[1]) is None
        assert asm.feed(rows[0]) == ("d", "a b c d", "r")

    def test_unframed_rows_pass_through(self, _isolated_obs):
        asm = codec_lib.DocumentAssembler(registry=_isolated_obs)
        row = ("plain-uuid", "article", "ref")
        assert asm.feed(row) == row

    def test_single_frame_document_still_framed(self, _isolated_obs):
        rows = codec_lib.frame_document_rows("d", "a b", "r", 8)
        assert rows == [("d#1/1", "a b", "r")]
        asm = codec_lib.DocumentAssembler(registry=_isolated_obs)
        assert asm.feed(rows[0]) == ("d", "a b", "r")

    def test_doc_id_may_complete_again_as_a_revision(self, _isolated_obs):
        asm = codec_lib.DocumentAssembler(registry=_isolated_obs)
        assert asm.feed(("d#1/1", "first", "r")) == ("d", "first", "r")
        assert asm.feed(("d#1/1", "second", "")) == ("d", "second", "")

    def test_mismatched_total_raises_typed_and_counts(self, _isolated_obs):
        asm = codec_lib.DocumentAssembler(registry=_isolated_obs)
        asm.feed(("d#1/3", "a", ""))
        with pytest.raises(codec_lib.DocumentFramingError,
                           match="part total"):
            asm.feed(("d#2/4", "b", ""))
        assert _isolated_obs.counter(
            "pipeline/codec_errors_total").value == 1

    def test_duplicate_and_out_of_range_raise(self, _isolated_obs):
        asm = codec_lib.DocumentAssembler(registry=_isolated_obs)
        asm.feed(("d#1/2", "a", ""))
        with pytest.raises(codec_lib.DocumentFramingError,
                           match="duplicate"):
            asm.feed(("d#1/2", "a", ""))
        with pytest.raises(codec_lib.DocumentFramingError,
                           match="outside"):
            asm.feed(("e#3/2", "x", ""))

    def test_pending_names_incomplete_docs(self, _isolated_obs):
        asm = codec_lib.DocumentAssembler(registry=_isolated_obs)
        asm.feed(("d#1/2", "a", ""))
        assert asm.pending() == ["d"]

    def test_frame_validation(self):
        with pytest.raises(ValueError, match="frame_words"):
            codec_lib.frame_document_rows("d", "a", "", 0)
        with pytest.raises(ValueError, match="no words"):
            codec_lib.frame_document_rows("d", "  ", "", 4)


# -- fan-out driver over a fake fleet (trace threading) --------------------

class _FakeSubmitSurface:
    """Minimal submit surface: records (uuid, article, tier, trace) and
    hands back unresolved futures the test settles by hand."""

    serve_mode = "microbatch"

    def __init__(self, registry):
        self.registry = registry
        self.submits = []

    def submit(self, article, uuid="", reference="", block=False,
               timeout=None, tier="", trace=None, tenant=""):
        from textsummarization_on_flink_tpu_torch.serve.queue import ServeFuture

        fut = ServeFuture(uuid, registry=self.registry)
        fut.trace = trace
        self.submits.append(
            {"uuid": uuid, "article": article, "tier": tier,
             "trace": trace, "future": fut})
        return fut

    def resolve(self, uuid, words):
        for s in self.submits:
            if s["uuid"] == uuid and not s["future"].done():
                s["future"]._resolve(DecodedResult(
                    uuid=uuid, article=s["article"], decoded_words=words,
                    reference="", abstract_sents=[]))
                return
        raise AssertionError(f"no pending submit {uuid!r}")


def _hier_hps(**kw):
    base = dict(mode="decode", batch_size=4, vocab_size=8, device="cpu",
                max_enc_steps=16, max_dec_steps=6, beam_size=2,
                min_dec_steps=1, max_oov_buckets=4,
                hier_chunk_words=4, hier_overlap_words=0)
    base.update(kw)
    return HParams(**base)


class TestFanOutDriver:
    def test_one_parent_trace_threads_every_sub_request(
            self, _isolated_obs):
        surface = _FakeSubmitSurface(_isolated_obs)
        hs = HierarchicalSummarizer(surface, _hier_hps(),
                                    registry=_isolated_obs)
        parent = hs.summarize("a b c d e f g h", uuid="doc")
        assert [s["uuid"] for s in surface.submits] == \
            ["doc/c0", "doc/c1"]
        assert [s["tier"] for s in surface.submits] == \
            ["greedy", "greedy"]
        for s in surface.submits:
            assert s["trace"].trace_id == parent.trace.trace_id
            assert s["trace"].parent_id == parent.trace.span_id
        surface.resolve("doc/c0", ["s0", "."])
        surface.resolve("doc/c1", ["s1", "."])
        # the reduce fired off the LAST chunk resolution, beam tier,
        # same trace, concatenated chunk summaries as its article
        red = surface.submits[2]
        assert red["uuid"] == "doc/reduce"
        assert red["tier"] == "beam"
        assert red["article"] == "s0 . s1 ."
        assert red["trace"].trace_id == parent.trace.trace_id
        surface.resolve("doc/reduce", ["s0", "."])
        res = parent.result(timeout=1)
        assert res.uuid == "doc"
        assert res.summary == "s0 ."
        assert res.chunk_count == 2
        assert res.copy_fidelity == 1.0  # every bigram came from a chunk
        assert _isolated_obs.counter("serve/hier_documents_total").value \
            == 1
        assert _isolated_obs.counter("serve/hier_chunks_total").value == 2
        assert _isolated_obs.counter("serve/hier_reduce_total").value == 1

    def test_session_requires_empty_article_and_tracks_reuse(
            self, _isolated_obs):
        surface = _FakeSubmitSurface(_isolated_obs)
        hs = HierarchicalSummarizer(surface, _hier_hps(),
                                    registry=_isolated_obs)
        sess = DocumentSession("d", "a b c d")
        with pytest.raises(ValueError, match="session"):
            hs.summarize("explicit text", session=sess)
        fut = hs.summarize("", session=sess)
        assert fut.uuid == "d@r1"
        surface.resolve("d@r1/c0", ["s", "."])
        surface.resolve("d@r1/reduce", ["s", "."])
        assert fut.result(timeout=1).reused_chunks == 0
        sess.append("e f g h")
        fut2 = hs.summarize("", session=sess)
        assert fut2.uuid == "d@r2"
        # chunk 0 unchanged -> reused; chunk 1 is new
        surface.resolve("d@r2/c0", ["s", "."])
        surface.resolve("d@r2/c1", ["t", "."])
        surface.resolve("d@r2/reduce", ["s", ".", "t", "."])
        assert fut2.result(timeout=1).reused_chunks == 1
        assert _isolated_obs.counter(
            "serve/hier_chunks_reused_total").value == 1

    def test_empty_document_raises(self, _isolated_obs):
        surface = _FakeSubmitSurface(_isolated_obs)
        hs = HierarchicalSummarizer(surface, _hier_hps(),
                                    registry=_isolated_obs)
        with pytest.raises(ValueError, match="no words"):
            hs.summarize("   ", uuid="d")

    def test_failed_chunk_rejects_parent_typed_after_all_resolve(
            self, _isolated_obs):
        surface = _FakeSubmitSurface(_isolated_obs)
        hs = HierarchicalSummarizer(surface, _hier_hps(),
                                    registry=_isolated_obs)
        parent = hs.summarize("a b c d e f g h", uuid="doc")
        surface.submits[0]["future"]._reject(RuntimeError("boom"))
        assert not parent.done()  # waits for EVERY outstanding chunk
        surface.resolve("doc/c1", ["s1", "."])
        with pytest.raises(HierPartialFailureError) as ei:
            parent.result(timeout=1)
        assert ei.value.failed.keys() == {0}
        assert ei.value.chunks == 2
        assert len(surface.submits) == 2  # no reduce over a partial map
        assert _isolated_obs.counter(
            "serve/hier_partial_failures_total").value == 1
        assert _isolated_obs.counter("serve/hier_reduce_total").value == 0

    def test_reduce_failure_rejects_parent_typed(self, _isolated_obs):
        surface = _FakeSubmitSurface(_isolated_obs)
        hs = HierarchicalSummarizer(surface, _hier_hps(),
                                    registry=_isolated_obs)
        parent = hs.summarize("a b c d e f g h", uuid="doc")
        surface.resolve("doc/c0", ["s0", "."])
        surface.resolve("doc/c1", ["s1", "."])
        surface.submits[2]["future"]._reject(RuntimeError("boom"))
        with pytest.raises(HierPartialFailureError) as ei:
            parent.result(timeout=1)
        assert ei.value.failed.keys() == {"reduce"}


# -- the OTHER submit surface: hiersum over a FleetRouter ------------------

class TestHierOverFleet:
    def test_fanout_threads_one_trace_through_fleet_replicas(
            self, _isolated_obs):
        """The summarizer is surface-agnostic: the same fan-out runs
        over a FleetRouter, and the parent TraceContext threads through
        the router into every replica-level sub-request."""
        from test_torch_fleet import make_fleet

        router, servers, _ = make_fleet(
            3, registry=_isolated_obs, hier_chunk_words=4,
            max_enc_steps=16)
        hs = HierarchicalSummarizer(router, router._hps,
                                    registry=_isolated_obs)
        parent = hs.summarize("a b c d e f g h i j k l", uuid="doc")
        subs = [(u, f) for s in servers for (u, f) in s.submits]
        assert sorted(u for u, _ in subs) == \
            ["doc/c0", "doc/c1", "doc/c2"]
        for _, f in subs:
            assert f.trace is not None
            assert f.trace.trace_id == parent.trace.trace_id
        for u, f in subs:
            f._resolve(DecodedResult(
                uuid=u, article="", decoded_words=["s", "."],
                reference="", abstract_sents=[]))
        red = [(u, f) for s in servers for (u, f) in s.submits
               if u == "doc/reduce"]
        assert len(red) == 1
        assert red[0][1].trace.trace_id == parent.trace.trace_id
        red[0][1]._resolve(DecodedResult(
            uuid="doc/reduce", article="", decoded_words=["s", "."],
            reference="", abstract_sents=[]))
        res = parent.result(timeout=5)
        assert res.chunk_count == 3
        assert res.summary == "s ."


# -- extractive stub decoder (no device) -----------------------------------

class ExtractiveStubDecoder:
    """decode_batch stub whose summary is the article's first
    `summary_words` words — extractive by construction, so the reduce
    output's n-grams are grounded in its inputs and the copy-fidelity
    floor is meaningful, not vacuous."""

    def __init__(self, summary_words: int = 8):
        self.summary_words = summary_words
        self.decoded = 0  # real examples served (the dedup pins)

    def should_degrade(self, deadline):
        return False

    def decode_batch(self, batch, deadline=None, tier=None):
        out = []
        for b in range(len(batch.uuids)):
            if not batch.real_mask[b]:
                continue
            self.decoded += 1
            words = batch.original_articles[b].split()[:self.summary_words]
            out.append(DecodedResult(
                uuid=batch.uuids[b],
                article=batch.original_articles[b],
                decoded_words=words, reference=batch.references[b],
                abstract_sents=[], tier=tier or "beam"))
        return out

    def maybe_reload_checkpoint(self, last):
        return last


# -- chaos: one chunk's dispatch fails mid-fan-out -------------------------

class TestHierChaos:
    def test_dispatch_fault_fails_one_chunk_parent_rejects_once(
            self, _isolated_obs):
        """serve.dispatch fires exactly once (max=1) with every chunk
        dispatching alone (serve_max_batch=1): ONE chunk fails typed,
        the rest complete, the parent rejects exactly once naming the
        failed chunk, the reduce is never submitted, and no chunk
        future is orphaned."""
        vocab = Vocab(words=WORDS)
        hps = _hier_hps(
            vocab_size=vocab.size(), serve_max_queue=64,
            serve_max_batch=1, serve_max_wait_ms=5.0,
            faults="serve.dispatch:1.0:0:1")
        server = ServingServer(hps, vocab,
                               decoder=ExtractiveStubDecoder(),
                               registry=_isolated_obs)
        hs = HierarchicalSummarizer(server, hps, registry=_isolated_obs)
        with server:
            parent = hs.summarize(" ".join(f"w{i}" for i in range(16)),
                                  uuid="doc")
            with pytest.raises(HierPartialFailureError) as ei:
                parent.result(timeout=30)
        err = ei.value
        assert err.chunks == 4
        assert len(err.failed) == 1
        (idx, cause), = err.failed.items()
        assert isinstance(idx, int)
        assert isinstance(cause, RuntimeError)
        assert "injected serve.dispatch fault" in str(cause)
        reg = _isolated_obs
        assert reg.counter("serve/hier_partial_failures_total").value == 1
        assert reg.counter("serve/hier_reduce_total").value == 0
        # no orphans: every chunk resolved (3 completions + 1 error)
        assert reg.counter("serve/completed_total").value == 3
        assert reg.counter("serve/errors_total").value == 1
        # exactly-once on the parent: a second resolution would have
        # tripped ServeFuture's assertion inside the callbacks above


# -- end-to-end: 50k-token doc over a socket, append, fan-out tree ---------

CHUNK_WORDS = 512
OVERLAP_WORDS = 64
STRIDE = CHUNK_WORDS - OVERLAP_WORDS
DOC_CHUNKS = 112
APPEND_CHUNKS = 2
FRAME_WORDS = 2048
#: initial doc ends exactly on a chunk boundary, so every pre-append
#: chunk stays byte-identical after the append (the dedup pin)
DOC_WORDS = CHUNK_WORDS + (DOC_CHUNKS - 1) * STRIDE  # 50240 ~ 50k tokens


def _socket_source(lines, max_count):
    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in lines:
                self.wfile.write((line + "\n").encode())

    srv = socketserver.TCPServer(("127.0.0.1", 0), Handler)
    port = srv.server_address[1]
    threading.Thread(target=srv.handle_request, daemon=True).start()
    return srv, io_lib.SocketSource("127.0.0.1", port, max_count=max_count)


def _hier_model(tmp_path, argv):
    m = est_lib.SummarizationModel()
    (m.set_inference_selected_cols(["uuid", "article", "reference"])
      .set_inference_output_cols(["uuid", "article", "summary",
                                  "reference"])
      .set_inference_output_types([io_lib.DataTypes.STRING] * 4))
    m.set_inference_hyper_params(argv)
    return m


class TestHierPipelineEndToEnd:
    @pytest.fixture()
    def e2e(self, tmp_path, monkeypatch, _isolated_obs):
        """One full run: 50k-token doc framed over a REAL socket ->
        transform(hierarchical=True) -> append frame-set -> sink; the
        unified event stream lands in a MemorySink and is written out
        as events.jsonl for the trace-tree assertions."""
        import shlex

        vocab = Vocab(words=WORDS)
        decoder = ExtractiveStubDecoder()
        events = MemorySink()
        _isolated_obs.event_sink = events
        real_server = server_mod.ServingServer

        def stub_server(hps, vocab_, train_dir=None, decode_root=None,
                        registry=None):
            # the real ServingServer, minus the checkpoint-backed
            # decoder the transform path would otherwise construct
            return real_server(hps, vocab_, decoder=decoder,
                               registry=registry)

        monkeypatch.setattr(server_mod, "ServingServer", stub_server)
        hps = HParams(
            mode="decode", batch_size=4, vocab_size=vocab.size(),
            max_enc_steps=CHUNK_WORDS, max_dec_steps=8, beam_size=2,
            min_dec_steps=1, max_oov_buckets=4, serve_max_queue=256,
            serve_max_wait_ms=5.0, serve_coalesce=True,
            serve_cache_entries=256, hier_chunk_words=CHUNK_WORDS,
            hier_overlap_words=OVERLAP_WORDS,
            log_root=str(tmp_path), exp_name="exp", device="cpu")
        doc = " ".join(f"w{i}" for i in range(DOC_WORDS))
        tail = " ".join(f"w{DOC_WORDS + i}"
                        for i in range(APPEND_CHUNKS * STRIDE))
        frames = codec_lib.frame_document_rows("doc50k", doc, "the ref",
                                               FRAME_WORDS)
        frames += codec_lib.frame_document_rows("doc50k", tail, "",
                                                FRAME_WORDS)
        lines = [io_lib.Message(u, a, "", r).to_json()
                 for (u, a, r) in frames]
        srv, source = _socket_source(lines, max_count=len(lines))
        model = _hier_model(tmp_path, shlex.split(hps.to_argv()))
        sink = io_lib.CollectionSink()
        try:
            model.with_vocab(vocab).transform(source, sink,
                                              hierarchical=True)
        finally:
            srv.server_close()
        path = os.path.join(str(tmp_path), "events.jsonl")
        with open(path, "w", encoding="utf-8") as f:
            for rec in events.records():
                f.write(json.dumps(rec) + "\n")
        return {"sink": sink, "decoder": decoder, "reg": _isolated_obs,
                "events_path": path, "doc": doc, "tail": tail}

    def test_two_revisions_emitted_with_append_dedup_pinned(self, e2e):
        rows = e2e["sink"].rows
        assert [r[0] for r in rows] == ["doc50k@r1", "doc50k@r2"]
        # revision articles are the accumulated session text
        assert rows[0][1] == e2e["doc"]
        assert rows[1][1] == f"{e2e['doc']} {e2e['tail']}"
        assert rows[0][3] == "the ref"
        for r in rows:
            assert len(r) == 4 and r[2]  # non-empty summary out
        reg = e2e["reg"]
        assert reg.counter("serve/hier_documents_total").value == 2
        assert reg.counter("serve/hier_chunks_total").value == \
            2 * DOC_CHUNKS + APPEND_CHUNKS
        # THE dedup pins (by construction, not by policy): every
        # pre-append chunk cache-hits at submit; the engine decodes
        # only the appended chunks + one reduce on the second pass
        assert reg.counter(
            "serve/hier_chunk_cache_hits_total").value == DOC_CHUNKS
        assert reg.counter(
            "serve/hier_chunks_reused_total").value == DOC_CHUNKS
        assert e2e["decoder"].decoded == \
            (DOC_CHUNKS + 1) + (APPEND_CHUNKS + 1)
        assert reg.counter("serve/hier_partial_failures_total").value == 0

    def test_copy_fidelity_floor(self, e2e):
        h = e2e["reg"].histogram("serve/hier_copy_fidelity")
        assert h.count == 2  # one reduce scored per revision
        assert h.mean >= 0.5, (
            f"reduce output fidelity {h.mean:.3f} below the committed "
            f"0.5 floor — the reduce pass is fabricating n-grams its "
            f"chunk inputs never contained")

    def test_fanout_tree_reconstructs_from_events_jsonl(self, e2e):
        tl = trace_summary.request_timeline([e2e["events_path"]],
                                            "doc50k@r1")
        kids = tl["children"]
        assert len(kids) == DOC_CHUNKS + 1
        chunks = [c for c in kids if c["kind"] == "chunk"]
        assert [c["chunk"] for c in chunks] == list(range(DOC_CHUNKS))
        assert kids[-1]["kind"] == "reduce"
        assert all(c["tier"] == "greedy" for c in chunks)
        assert all(not c["cache_hit"] for c in chunks)  # cold pass
        assert all(c["bucket"] is not None for c in chunks)
        # the append revision: every pre-append chunk is a cache hit
        tl2 = trace_summary.request_timeline([e2e["events_path"]],
                                             "doc50k@r2")
        kids2 = tl2["children"]
        assert len(kids2) == DOC_CHUNKS + APPEND_CHUNKS + 1
        hits = [c for c in kids2 if c["cache_hit"]]
        assert len(hits) == DOC_CHUNKS
        assert [c["chunk"] for c in hits] == list(range(DOC_CHUNKS))

    def test_cli_renders_fanout_tree(self, e2e, capsys):
        rc = trace_summary.main(
            [e2e["events_path"], "--request", "doc50k@r1"])
        out = capsys.readouterr().out
        assert rc == 0
        assert f"fan-out ({DOC_CHUNKS} chunks + 1 reduce):" in out
        assert "doc50k@r1/c0" in out and "doc50k@r1/reduce" in out
        assert "tier greedy" in out and "tier beam" in out


# -- pipeline framing errors surface through the stage ---------------------

class TestHierTransformValidation:
    def test_truncated_frame_stream_fails_the_job(
            self, tmp_path, monkeypatch, _isolated_obs):
        import shlex

        vocab = Vocab(words=WORDS)
        real_server = server_mod.ServingServer
        monkeypatch.setattr(
            server_mod, "ServingServer",
            lambda hps, v, train_dir=None, decode_root=None,
            registry=None: real_server(
                hps, v, decoder=ExtractiveStubDecoder(),
                registry=registry))
        hps = HParams(
            mode="decode", batch_size=4, vocab_size=vocab.size(),
            max_enc_steps=16, max_dec_steps=6, beam_size=2,
            min_dec_steps=1, max_oov_buckets=4, serve_max_queue=16,
            serve_max_wait_ms=5.0, hier_chunk_words=8,
            log_root=str(tmp_path), exp_name="exp", device="cpu")
        model = _hier_model(tmp_path, shlex.split(hps.to_argv()))
        source = io_lib.CollectionSource(
            [("d#1/2", "half a document", "", "")])
        with pytest.raises(RuntimeError, match="incomplete document"):
            model.with_vocab(vocab).transform(source, hierarchical=True)
