"""The port's pipeline units against the JAX package's, on the CPU: the
hyperparameter string, the params layer and its JSON, row schemas, the
row codec and the tf.Example codec (bytes equal both ways), the record
queue, the socket source and sink over loopback with the idle timeout,
and the batcher's row order (single-pass train batches sorted by encoder
length, as the JAX batcher sorts them) and trickle latency (a partial
decode batch ships after 0.2 s)."""

import json
import shlex
import socketserver
import threading
import time

import numpy as np
import pytest

from _torch_parity import WORDS, article, make_hps
from textsummarization_on_flink_tpu import config as jax_config
from textsummarization_on_flink_tpu.data import batcher as jax_batcher
from textsummarization_on_flink_tpu.data import tfexample as jax_tfexample
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu.pipeline import app as jax_app
from textsummarization_on_flink_tpu.pipeline import codec as jax_codec
from textsummarization_on_flink_tpu.pipeline import estimator as jax_est
from textsummarization_on_flink_tpu.pipeline import io as jax_io
from textsummarization_on_flink_tpu.pipeline import params as jax_params
from textsummarization_on_flink_tpu_torch import config as torch_config
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.data import batcher
from textsummarization_on_flink_tpu_torch.data import tfexample
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.pipeline import bridge
from textsummarization_on_flink_tpu_torch.pipeline import codec
from textsummarization_on_flink_tpu_torch.pipeline import estimator as est
from textsummarization_on_flink_tpu_torch.pipeline import io
from textsummarization_on_flink_tpu_torch.pipeline import params
from textsummarization_on_flink_tpu_torch.resilience.errors import (
    StreamIdleError,
)

DT = io.DataTypes

# -- the hyperparameter string --


def test_to_argv_round_trips_through_from_string():
    h = torch_config.HParams(log_root="/a dir/with 'quotes'", exp_name="",
                             device="cpu", lr=0.25, coverage=True,
                             vocab_path="v")
    s = h.to_argv()
    assert "--exp_name= " in s and "--device=cpu" in s
    assert torch_config.HParams.from_string(s) == h
    assert torch_config.HParams.from_argv(shlex.split(s)) == h


def test_jax_rendered_argv_parses_in_the_port():
    j = jax_config.HParams(mode="decode", batch_size=3, coverage=True,
                           log_root="/tmp/a b", beam_size=5, lr=0.3)
    t = torch_config.HParams.from_string(j.to_argv())
    for f in ("mode", "batch_size", "coverage", "log_root", "beam_size",
              "lr", "max_oov_buckets", "hidden_dim", "seed"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.device == "cuda"  # the JAX package has no device field
    # and the port's string parses in the JAX package (device ignored)
    back = jax_config.HParams.from_string(t.replace(device="cpu").to_argv())
    assert (back.batch_size, back.log_root, back.lr) == (3, "/tmp/a b", 0.3)


# -- params --


@pytest.mark.parametrize("group", [
    "HasClusterConfig", "HasTrainPythonConfig", "HasInferencePythonConfig",
    "HasTrainSelectedCols", "HasTrainOutputCols", "HasTrainOutputTypes",
    "HasInferenceSelectedCols", "HasInferenceOutputCols",
    "HasInferenceOutputTypes"])
def test_param_groups_declare_what_the_jax_groups_declare(group):
    mine = getattr(params, group).param_infos()
    theirs = getattr(jax_params, group).param_infos()
    assert sorted(mine) == sorted(theirs)
    for name, info in mine.items():
        other = theirs[name]
        assert (info.type_, info.required, info.has_default, info.default) \
            == (other.type_, other.required, other.has_default,
                other.default), name


@pytest.mark.parametrize("value,error", [
    ("two", TypeError), (0, ValueError), (3, None)])
def test_param_validators_match_jax(value, error):
    for mod in (params, jax_params):
        c = mod.HasClusterConfig()
        if error is None:
            assert c.set_worker_num(value).get_worker_num() == value
        else:
            with pytest.raises(error):
                c.set_worker_num(value)
    for mod in (params, jax_params):
        s = mod.HasTrainSelectedCols()
        with pytest.raises(KeyError):  # required, not set
            s.get_train_selected_cols()
        with pytest.raises(ValueError):  # non-empty
            s.set_train_selected_cols([])
        assert mod.HasClusterConfig().get_zookeeper_connect_str() == \
            "127.0.0.1:2181"


def _configure(stage, dt, train=True):
    stage.set_worker_num(2).set_ps_num(0)
    stage.set_coordinator_address("10.0.0.1:2181")
    if train:
        (stage.set_train_selected_cols(["uuid", "article", "reference"])
         .set_train_output_cols(["uuid"])
         .set_train_output_types([dt.STRING]))
        stage.set_train_hyper_params(["--mode=train", "--num_steps=3"])
        stage.set_train_scripts(["train_entry"])
    (stage.set_inference_selected_cols(["uuid", "article", "reference"])
     .set_inference_output_cols(["uuid", "article", "summary", "reference"])
     .set_inference_output_types([dt.STRING] * 4))
    stage.set_inference_hyper_params(["--mode=decode", "--beam_size=3"])
    stage.set_inference_env_path("/venv")
    return stage


@pytest.mark.parametrize("stage", ["SummarizationEstimator",
                                   "SummarizationModel"])
def test_to_json_is_the_jax_string(stage):
    train = stage == "SummarizationEstimator"
    mine = _configure(getattr(est, stage)(), io.DataTypes, train)
    theirs = _configure(getattr(jax_est, stage)(), jax_io.DataTypes, train)
    assert mine.to_json() == theirs.to_json()
    again = getattr(est, stage)().load_json(theirs.to_json())
    assert again.to_json() == theirs.to_json()
    with pytest.raises(TypeError):  # typed re-validation on load
        getattr(est, stage)().load_json('{"worker_num": "three"}')


def test_model_json_written_by_jax_loads_in_the_port(tmp_path):
    jhps = jax_config.HParams(mode="decode", batch_size=4, hidden_dim=8,
                              emb_dim=6, vocab_size=24, beam_size=2,
                              log_root=str(tmp_path), coverage=True)
    jmodel = jax_app.App(jhps, jhps).create_model()
    model = est.SummarizationModel().load_json(jmodel.to_json())
    assert model.to_json() == jmodel.to_json()
    hps, want = model._hps(), jmodel._hps()
    shared = set(torch_config.HParams.__dataclass_fields__) & \
        set(jax_config.HParams.__dataclass_fields__)
    assert len(shared) > 30
    for f in sorted(shared):
        assert getattr(hps, f) == getattr(want, f), f
    assert model.get_inference_output_cols() == \
        ["uuid", "article", "summary", "reference"]


# -- rows and codecs --

ALL_TYPES = io.RowSchema(
    ["s", "b", "i8", "i16", "i32", "i64", "u16", "f32", "f64", "arr"],
    [DT.STRING, DT.BOOL, DT.INT_8, DT.INT_16, DT.INT_32, DT.INT_64,
     DT.UINT_16, DT.FLOAT_32, DT.FLOAT_64, DT.FLOAT_32_ARRAY])
ALL_ROWS = [("héllo", True, -7, 300, -(1 << 20), -(1 << 40), 65535, 0.5,
             2.25, [1.0, -2.5, 3.0]),
            ("", False, 0, 0, 0, 0, 0, -0.0, 1e-30, [])]


def test_row_schema_matches_jax():
    for mod in (io, jax_io):
        s = mod.ARTICLE_INPUT_SCHEMA
        sub = s.select(["uuid", "article", "reference"])
        assert sub.names == ["uuid", "article", "reference"]
        assert s.project_row(("u", "a", "s", "r"), ["uuid", "reference"]) \
            == ("u", "r")
        with pytest.raises(ValueError, match="Unsupported data type"):
            mod.RowSchema(["x"], ["COMPLEX128"])
        with pytest.raises(ValueError, match="length mismatch"):
            mod.RowSchema(["x", "y"], [mod.DataTypes.STRING])
        with pytest.raises(ValueError):  # unknown column
            s.select(["uuid", "nope"])
    assert io.ARTICLE_OUTPUT_SCHEMA.names == jax_io.ARTICLE_OUTPUT_SCHEMA.names
    assert io.DataTypes._ALL == jax_io.DataTypes._ALL
    assert issubclass(io.SchemaProjectionError, ValueError)


@pytest.mark.parametrize("row", ALL_ROWS)
def test_encode_row_gives_the_jax_bytes_and_reads_both(row):
    jschema = jax_io.RowSchema(ALL_TYPES.names, ALL_TYPES.types)
    mine = codec.encode_row(ALL_TYPES, row)
    theirs = jax_codec.encode_row(jschema, row)
    assert mine == theirs
    for data in (mine, theirs):
        back = codec.decode_example(ALL_TYPES, data)
        assert back == jax_codec.decode_example(jschema, data)
        assert back[:7] == row[:7]
        np.testing.assert_allclose(back[7:9], row[7:9], rtol=1e-7)
        np.testing.assert_allclose(back[9], row[9])
    with pytest.raises(ValueError, match="arity"):
        codec.encode_row(ALL_TYPES, row[:3])


def test_example_coding_matrix():
    schema = io.RowSchema(["a", "b"], [DT.STRING, DT.INT_32])
    row = ("x", 3)
    both = codec.ExampleCoding(schema, schema)
    assert both.decode(both.encode(row)) == row
    enc_only = codec.ExampleCoding(schema, None)
    wire = enc_only.encode(row)
    assert enc_only.decode(wire) is wire
    dec_only = codec.ExampleCoding(None, schema)
    assert dec_only.encode(row) is row and dec_only.decode(wire) == row


def test_tfexample_cross_parses_with_jax():
    feats = {"b": [b"x", "yé".encode()], "f": [0.5, -1.25],
             "i": [3, -(1 << 62), 0], "empty": []}
    mine = tfexample.Example(dict(feats)).serialize()
    theirs = jax_tfexample.Example(dict(feats)).serialize()
    assert mine == theirs
    assert tfexample.Example.parse(theirs) == tfexample.Example(feats)
    assert jax_tfexample.Example.parse(mine).features == feats
    ex = tfexample.Example().set_bytes("s", "abc").set_ints("n", 5)
    assert jax_tfexample.Example.parse(ex.serialize()).get_str("s") == "abc"
    assert ex.get_str("missing", default="d") == "d"
    with pytest.raises(ValueError, match="truncated"):
        tfexample.Example.parse(mine[:-3])


def test_message_round_trip_matches_jax():
    m = io.Message("u1", "art", "sum", "ref")
    assert m.to_json() == jax_io.Message("u1", "art", "sum", "ref").to_json()
    assert io.Message.from_json(m.to_json()).to_row() == \
        ("u1", "art", "sum", "ref")
    # a JAX frame with the serving transport's extra keys reads the same
    wire = jax_io.Message("u1", "art", "", "ref", tier="greedy").to_json()
    assert io.Message.from_json(wire).to_row() == ("u1", "art", "", "ref")
    assert io.Message.from_json('{"uuid": "x"}').to_row() == ("x", "", "", "")
    assert io.Message.from_row(("a", "b", "c", "d")).to_json() == \
        jax_io.Message.from_row(("a", "b", "c", "d")).to_json()


# -- the record queue (tests/test_bridge.py's contract) --


def test_record_queue_put_after_close_fails_fast():
    q = bridge.make_record_queue(capacity=4)
    assert isinstance(q, bridge.PyRecordQueue)
    assert q.put(b"before")
    q.close()
    assert not q.put(b"after") and not q.put(b"after", timeout=0.0)
    assert len(q) == 1


def test_record_queue_drains_then_ends_and_times_out():
    q = bridge.PyRecordQueue(capacity=4)
    assert q.get(timeout=0.05) is None and not q.closed  # a timeout
    for i in range(3):
        assert q.put(b"r%d" % i)
    q.close()
    assert [q.get(timeout=1) for _ in range(3)] == [b"r0", b"r1", b"r2"]
    assert q.get(timeout=0.0) is None and q.get() is None and q.closed
    q.close()  # idempotent
    assert q.closed


def test_record_queue_bounded_and_close_releases_parked_threads():
    q = bridge.PyRecordQueue(capacity=2)
    assert q.put(b"a") and q.put(b"b")
    assert not q.put(b"c", timeout=0.05)  # full: bounded
    assert len(q) == 2
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "put", q.put(b"c", timeout=10)))
    t.start()
    time.sleep(0.05)
    q.close()
    t.join(timeout=5)
    assert not t.is_alive() and out["put"] is False
    empty = bridge.PyRecordQueue()
    t = threading.Thread(target=lambda: out.setdefault(
        "get", empty.get(timeout=10)))
    t.start()
    time.sleep(0.05)
    empty.close()
    t.join(timeout=5)
    assert not t.is_alive() and out["get"] is None


# -- sources and sinks over loopback --


def _one_shot_server(handle):
    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            handle(self)

    server = socketserver.TCPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.handle_request, daemon=True).start()
    return server, server.server_address[1]


def test_socket_source_round_trip_counts_and_drops_malformed():
    lines = [io.Message(f"u{i}", f"art {i}", "", "ref").to_json()
             for i in range(3)]
    lines.insert(1, "{not json")

    def handle(h):
        for line in lines:
            h.wfile.write((line + "\n").encode())

    server, port = _one_shot_server(handle)
    reg = obs.Registry()
    with obs.use_registry(reg):
        got = list(io.SocketSource("127.0.0.1", port, max_count=3).rows())
    server.server_close()
    assert [r[0] for r in got] == ["u0", "u1", "u2"]
    assert reg.counter("pipeline/source_rows_total").value == 3
    assert reg.counter("pipeline/codec_errors_total").value == 1


def test_socket_source_raises_stream_idle_error():
    done = threading.Event()

    def handle(h):
        h.wfile.write((io.Message("u0", "a", "", "r").to_json() + "\n")
                      .encode())
        h.wfile.flush()
        done.wait(5)  # then silence

    server, port = _one_shot_server(handle)
    src = io.SocketSource("127.0.0.1", port, idle_timeout=0.2)
    rows = src.rows()
    assert next(rows)[0] == "u0"
    t0 = time.monotonic()
    with pytest.raises(StreamIdleError, match="no data"):
        next(rows)
    assert time.monotonic() - t0 < 3
    assert issubclass(StreamIdleError, TimeoutError)
    done.set()
    server.server_close()


def test_socket_source_schema_mismatch_raises_typed():
    def handle(h):
        h.wfile.write(b"[1, 2]\n")

    server, port = _one_shot_server(handle)
    with pytest.raises(io.SchemaProjectionError):
        list(io.SocketSource("127.0.0.1", port).rows())
    server.server_close()


def test_socket_and_queue_sinks_write_each_row_at_once():
    got = []

    def handle(h):
        got.extend(h.rfile.readline() for _ in range(2))

    server, port = _one_shot_server(handle)
    sink = io.SocketSink("127.0.0.1", port)
    rows = [("u0", "a", "s", "r"), ("u1", "b", "t", "q")]
    for r in rows:
        sink.write(r)
    sink.close()
    time.sleep(0.2)
    server.server_close()
    assert [io.Message.from_json(x.decode()).to_row() for x in got] == rows
    qs = io.QueueSink()
    qs.write(rows[0])
    assert qs.queue.get(timeout=1) == rows[0]
    cs = io.CollectionSink()
    for r in io.CollectionSource(rows).rows():
        cs.write(r)
    assert cs.rows == rows


def test_kafka_needs_kafka_python(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_kafka(name, *a, **kw):
        if name == "kafka" or name.startswith("kafka."):
            raise ImportError("no kafka")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_kafka)
    with pytest.raises(RuntimeError, match="kafka-python"):
        list(io.KafkaSource("t").rows())
    with pytest.raises(RuntimeError, match="kafka-python"):
        io.KafkaSink("t")._ensure()


# -- the batcher's row order and trickle latency --


def _rows(n):
    """(uuid, article, abstract, reference) tuples of ragged lengths."""
    out = []
    for i in range(n):
        art = article(i, n_words=4 + (7 * i) % 19)
        out.append((f"u{i}", art, f"<s> {WORDS[i]} sat . </s>", f"ref {i}"))
    return out


@pytest.mark.parametrize("n", [8, 11])
def test_single_pass_train_batches_follow_the_jax_order(n):
    jhps, thps = make_hps(mode="train", batch_size=4)
    items = _rows(n)
    jb = jax_batcher.Batcher("", JaxVocab(words=WORDS), jhps,
                             single_pass=True,
                             example_source=lambda: iter(items))
    tb = batcher.Batcher("", Vocab(words=WORDS), thps, single_pass=True,
                         example_source=lambda: iter(items))
    batches = 0
    while True:
        want, got = jb.next_batch(), tb.next_batch()
        assert (want is None) == (got is None)
        if want is None:
            break
        batches += 1
        assert got.uuids == want.uuids
        assert got.real_mask == want.real_mask
        assert list(got.enc_lens) == sorted(got.enc_lens)
        for k, v in want.as_arrays().items():
            np.testing.assert_array_equal(got.as_arrays()[k], v, err_msg=k)
    assert batches == -(-n // 4)


def test_decode_batch_ships_partial_after_the_trickle_wait():
    _, thps = make_hps(batch_size=4)
    items = _rows(3)

    def source():
        yield items[0]
        yield batcher.IDLE
        yield items[1]  # within the wait: joins the first batch
        t0 = time.monotonic()
        while time.monotonic() - t0 < 1.0:
            yield batcher.IDLE
        yield items[2]

    # the batcher's threads read the source from construction on, so the
    # wait is measured from there
    t0 = time.monotonic()
    b = batcher.Batcher("", Vocab(words=WORDS), thps, example_source=source)
    first = b.next_batch()
    waited = time.monotonic() - t0
    assert first.uuids[:2] == ["u0", "u1"]
    assert first.real_mask == [True, True, False, False]
    assert batcher.TRICKLE_WAIT_S <= waited < 0.9
    second = b.next_batch()  # the first article of a batch is waited for
    assert second.uuids[0] == "u2" and second.real_mask == [True] + [False] * 3
    assert b.next_batch() is None


def test_train_batches_wait_through_idle():
    _, thps = make_hps(mode="train", batch_size=2)
    items = _rows(2)

    def source():
        yield items[0]
        t0 = time.monotonic()
        while time.monotonic() - t0 < 0.3:
            yield batcher.IDLE
        yield items[1]

    b = batcher.Batcher("", Vocab(words=WORDS), thps, single_pass=True,
                        example_source=source)
    assert b.next_batch().real_mask == [True, True]


def test_rows_from_queue_signals_idle_then_ends():
    schema = io.ARTICLE_INPUT_SCHEMA.select(["uuid", "article", "reference"])
    coding = codec.ExampleCoding(schema, schema)
    q = bridge.PyRecordQueue()
    rows = est._rows_from_queue(q, coding)
    assert next(rows) is batcher.IDLE
    q.put(coding.encode(("u", "a", "r")))
    assert next(rows) == ("u", "a", "r")
    q.close()
    assert list(rows) == []
    assert list(est.rows_to_examples(iter([batcher.IDLE, ("u", "a", "r .")])))\
        == [batcher.IDLE, ("u", "a", "<s> r . </s>", "r .")]


def test_sentence_helpers_match_jax():
    for text in ("one sentence . another one ! third ?", "", "  x .  "):
        assert est.sent_tokenize(text) == jax_est.sent_tokenize(text)
        assert est.reference_to_abstract(text) == \
            jax_est.reference_to_abstract(text)


def test_obs_counts_and_spans():
    reg = obs.Registry()
    with obs.use_registry(reg):
        obs.counter("pipeline/rows_in_total").inc(2)
        assert obs.registry_for(None) is reg
        with pytest.raises(ValueError):
            obs.counter("pipeline/rows_in_total").inc(-1)
    assert obs.registry() is not reg
    with pytest.raises(KeyError):
        with obs.spans.span(reg, "pipeline/fit"):
            raise KeyError("recorded anyway")
    snap = reg.snapshot(compact=True)
    assert {k: v["value"] for k, v in snap.items()
            if v["type"] == "counter"} == {"pipeline/rows_in_total": 2.0}
    assert len([r for r in obs.tracer_for(reg).finished()
                if r.name == "pipeline/fit"]) == 1
    assert json.dumps(snap)
