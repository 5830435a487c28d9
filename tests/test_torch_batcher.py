"""The port's threaded bucketing batcher (data/batcher.py) and its chunk
readers (data/chunks.py::example_generator, text_pairs) against the JAX
package's, on the CPU: single-pass batches equal field by field on the same chunk
files (train, and decode in both batch modes), a streaming pass that
holds every record once, streaming batches that hold every example the
source gave, the restart budget of crashed workers, and a streaming
source with no article, which raises rather than spin."""

import collections
import random
import threading
import time

import numpy as np
import pytest

from _torch_parity import WORDS, abstract, article, make_hps
from textsummarization_on_flink_tpu.data import batcher as jax_batcher
from textsummarization_on_flink_tpu.data import chunks as jax_chunks
from textsummarization_on_flink_tpu.data.vocab import Vocab as JaxVocab
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.data import batcher, chunks
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.resilience.errors import (
    WorkerCrashError,
)


def _write_files(tmp_path, n, per_file=3):
    """n records of ragged lengths over ceil(n / per_file) chunk files,
    and one record with an empty article (skipped by both batchers)."""
    recs = [{"article": [article(i, n_words=4 + (7 * i) % 19)],
             "abstract": [abstract(i)]} for i in range(n)]
    recs.insert(n // 2, {"article": [""], "abstract": ["<s> x . </s>"]})
    for f in range(0, len(recs), per_file):
        chunks.write_chunk_file(str(tmp_path / f"data_{f // per_file:03d}.bin"),
                                recs[f:f + per_file])
    return str(tmp_path / "data_*.bin")


def _drain(b):
    out = []
    while True:
        batch = b.next_batch()
        if batch is None:
            return out
        out.append(batch)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.real_mask == w.real_mask
        assert g.original_articles == w.original_articles
        assert g.original_abstracts_sents == w.original_abstracts_sents
        for k, v in w.as_arrays().items():
            np.testing.assert_array_equal(g.as_arrays()[k], v, err_msg=k)


@pytest.mark.parametrize("mode,decode_mode", [("train", None),
                                              ("eval", None),
                                              ("decode", "distinct"),
                                              ("decode", "repeat")])
@pytest.mark.parametrize("n", [5, 8, 11])
def test_single_pass_batches_equal_the_jax_batchers(tmp_path, mode,
                                                    decode_mode, n):
    """One example thread and one batch thread, files in sorted order:
    every batch (rows, real_mask, arrays) equals the JAX batcher's."""
    path = _write_files(tmp_path, n)
    jhps, thps = make_hps(mode=mode, batch_size=4, single_pass=True)
    kw = {} if decode_mode is None else dict(decode_batch_mode=decode_mode)
    want = _drain(jax_batcher.Batcher(path, JaxVocab(words=WORDS), jhps,
                                      single_pass=True, **kw))
    got = _drain(batcher.Batcher(path, Vocab(words=WORDS), thps,
                                 single_pass=True, **kw))
    _assert_batches_equal(got, want)
    real = sum(sum(b.real_mask) for b in got)
    assert real == n


def test_a_streaming_pass_holds_every_record_once(tmp_path):
    """Streaming: each pass over the files is a permutation of the
    records (the file list shuffled by the explicit generator), passes
    differ, and the same seed gives the same order as the JAX reader."""
    path = _write_files(tmp_path, 14, per_file=2)
    n = len(list(chunks.example_generator(path, single_pass=True)))
    gen = chunks.example_generator(path, single_pass=False,
                                   rng=random.Random(7))
    want = collections.Counter(
        e.get_str("article")
        for e in chunks.example_generator(path, single_pass=True))
    passes = [[next(gen).get_str("article") for _ in range(n)]
              for _ in range(4)]
    assert all(collections.Counter(p) == want for p in passes)
    assert len({tuple(p) for p in passes}) > 1
    jgen = jax_chunks.example_generator(path, False, rng=random.Random(7))
    jax_first = [next(jgen).get_str("article") for _ in range(n)]
    gen = chunks.example_generator(path, single_pass=False,
                                   rng=random.Random(7))
    assert [next(gen).get_str("article") for _ in range(n)] == jax_first


def test_streaming_batches_hold_every_example_the_source_gave():
    """16 example threads each take one pass of the source (here: the
    records, then IDLE), 4 batch threads ship distinct decode batches:
    the real rows of the batches are 16 copies of the source, no more and
    no fewer."""
    _, thps = make_hps(mode="decode", batch_size=4, single_pass=False)
    items = [(f"u{i}", article(i), abstract(i), f"ref {i}")
             for i in range(6)]

    stop = threading.Event()

    def source():  # one pass, then nothing until the test ends
        yield from items
        while not stop.wait(0.05):
            yield batcher.IDLE

    b = batcher.Batcher("", Vocab(words=WORDS), thps, single_pass=False,
                        example_source=source)
    seen = collections.Counter()
    deadline = time.monotonic() + 60
    while sum(seen.values()) < 16 * len(items):
        assert time.monotonic() < deadline
        batch = b.next_batch()
        for uuid, real in zip(batch.uuids, batch.real_mask):
            if real:
                seen[uuid] += 1
    stop.set()  # the sources end: the threads fail out and stop
    assert seen == {f"u{i}": 16 for i in range(len(items))}


def test_streaming_train_batches_are_length_buckets_of_the_files(tmp_path):
    """Streaming train batches: every row real, drawn from the files, and
    each batch sorted by encoder length (one bucket of the sorted
    cache)."""
    path = _write_files(tmp_path, 7)
    _, thps = make_hps(mode="train", batch_size=2, single_pass=False)
    reg = obs.Registry()
    with obs.use_registry(reg):
        b = batcher.Batcher(path, Vocab(words=WORDS), thps, single_pass=False)
        arts = {article(i, n_words=4 + (7 * i) % 19) for i in range(7)}
        for _ in range(5):
            batch = b.next_batch()
            assert all(batch.real_mask)
            assert set(batch.original_articles) <= arts
            assert list(batch.enc_lens) == sorted(batch.enc_lens)
    assert reg.counter("data/examples_total").value >= 200
    assert reg.counter("data/empty_articles_total").value >= 1
    assert reg.counter("data/batches_total").value >= 5


@pytest.mark.parametrize("budget,fires", [(3, 2), (1, 2), (0, 1)])
def test_a_crashed_worker_restarts_against_the_budget(tmp_path, budget,
                                                      fires):
    """etl.worker faults crash the example thread; it restarts in place
    (re-reading its source) while the shared budget lasts, and then the
    batches equal an undisturbed run; past the budget next_batch() raises
    WorkerCrashError with the injected error chained."""
    path = _write_files(tmp_path, 6)
    _, thps = make_hps(mode="train", batch_size=4, single_pass=True)
    want = _drain(batcher.Batcher(path, Vocab(words=WORDS), thps,
                                  single_pass=True))
    hps = thps.replace(faults=f"etl.worker:1.0:0:{fires}")
    reg = obs.Registry()
    with obs.use_registry(reg):
        b = batcher.Batcher(path, Vocab(words=WORDS), hps, single_pass=True,
                            max_worker_restarts=budget)
        if fires <= budget:
            _assert_batches_equal(_drain(b), want)
        else:
            with pytest.raises(WorkerCrashError) as e:
                _drain(b)
            assert "injected etl.worker fault" in str(e.value.__cause__)
    assert reg.counter("resilience/etl_worker_restarts_total").value == \
        min(fires, budget)


def test_a_streaming_pass_with_no_article_raises(tmp_path):
    """Files whose every article is empty: a streaming pass finds nothing
    to yield, so text_pairs raises instead of re-reading them forever
    (each skip counted), and the streaming batcher's next_batch() raises
    WorkerCrashError once the restart budget is spent, not block."""
    path = str(tmp_path / "empty_*.bin")
    for f in range(2):
        chunks.write_chunk_file(str(tmp_path / f"empty_{f:03d}.bin"),
                                [{"article": [""], "abstract": [abstract(f)]}])
    skipped = []
    with pytest.raises(ValueError, match="no record with an article"):
        list(chunks.text_pairs(path, single_pass=False,
                               on_empty=lambda: skipped.append(1)))
    assert len(skipped) == 2
    assert list(chunks.text_pairs(path)) == []
    _, thps = make_hps(mode="train", batch_size=2, single_pass=False)
    reg = obs.Registry()
    with obs.use_registry(reg):
        b = batcher.Batcher(path, Vocab(words=WORDS), thps, single_pass=False)
        with pytest.raises(WorkerCrashError) as e:
            b.next_batch()
    assert "no record with an article" in str(e.value.__cause__)
    assert reg.counter("data/empty_articles_total").value >= 2
