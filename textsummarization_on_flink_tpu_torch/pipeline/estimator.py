"""Estimator/Model pipeline stages (TFEstimator/TFModel parity).

The port's counterpart of the JAX package's pipeline/estimator.py, after
the reference's generic pipeline classes (TFEstimator.java,
TFModel.java), without the Flink runtime:

  * ``SummarizationEstimator.fit(source) -> SummarizationModel`` selects
    the train columns (TFEstimator.java:32-38), parses the
    hyperparameter argv string from the params (TFEstimator.java:52 ->
    run_summarization.py:418-420), streams rows through the bridge as
    serialized tf.Example records (CodingUtils.java), resumes from the
    newest checkpoint of ``<log_root>/<exp_name>/train`` if there is one,
    trains, and returns a model configured with the inference params
    (TFEstimator.java:86-96);
  * the returned model carries configuration only: the weights travel
    through the checkpoint directory, as in the reference (SURVEY.md
    §3.1);
  * ``SummarizationModel.transform(source, sink)`` mirrors
    TFModel.transform (TFModel.java:56-76): it selects the inference
    columns (uuid, article, reference), beam-decodes, and writes
    (uuid, article, summary, reference) rows, each to the sink as soon
    as its batch is decoded;
  * ``to_json()``/``load_json()`` persist params-JSON only
    (TensorFlowTest.testJsonExportImport, :142-168).

fit() and transform() run in one process, so ``Pipeline(estimator ->
model)`` composes.  On a mesh (``--dp``, ``--tp``, ``--sp`` with a
product above 1, one process per rank under torchrun, as cli.py runs)
fit and transform join the world themselves and every rank calls them
with the same stages; the chief alone reads the Source and writes the
Sink.  fit splits each global batch of the chief's over dp as the JAX
package's ``shard_batch`` does (rank d of dp takes rows d*B/dp ..), so
the sharded fit is the single-rank fit on the same rows; transform
decodes through the sharded decoder (every rank in its decode loop) or,
with ``serving=True``, a mesh ServingServer (serve/mesh.py: the chief
serves, the others follow).  Both run on ``cuda`` unless the hyperparameters say
``--device=cpu``, and raise with no card otherwise.  ``--debug`` is
applied by the trainer, as for ``cli.py --mode=train``: the batch of a
non-finite loss is dumped.  ``transform(serving=True)`` runs the rows
through the concurrent serve layer (serve/server.py: an admission
queue, micro-batches, deadlines) instead of the synchronous decode
loop, with the same output rows.  ``transform(hierarchical=True)`` takes long
documents as framed rows (pipeline/codec.py), reassembles them, and
map-reduces each over a ServingServer (serve/hiersum.py): one summary
row per document revision.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Iterator, List, Optional, Tuple

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.checkpoint import (
    checkpointer as ckpt_lib,
)
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data.batcher import IDLE, Batcher
from textsummarization_on_flink_tpu_torch.data.vocab import (
    SENTENCE_END,
    SENTENCE_START,
    Vocab,
)
from textsummarization_on_flink_tpu_torch.decode.decoder import (
    BeamSearchDecoder,
)
from textsummarization_on_flink_tpu_torch.device import resolve_device
from textsummarization_on_flink_tpu_torch.parallel import collectives
from textsummarization_on_flink_tpu_torch.parallel import distributed
from textsummarization_on_flink_tpu_torch.parallel import mesh as mesh_lib
from textsummarization_on_flink_tpu_torch.pipeline import bridge as bridge_lib
from textsummarization_on_flink_tpu_torch.pipeline import params as P
from textsummarization_on_flink_tpu_torch.pipeline.codec import ExampleCoding
from textsummarization_on_flink_tpu_torch.pipeline.io import (
    ARTICLE_OUTPUT_SCHEMA,
    CollectionSink,
    CollectionSource,
    Row,
    RowSchema,
    Sink,
    Source,
)
from textsummarization_on_flink_tpu_torch.train import trainer as trainer_lib

log = logging.getLogger(__name__)

_SENT_RE = re.compile(r"(?<=[.!?])\s+")

#: seconds the queue reader waits for a record before it yields IDLE, so
#: the decode batcher can time out a partial batch
_POLL_S = 0.05


def sent_tokenize(text: str) -> List[str]:
    """Sentence split for streamed reference summaries
    (FlinkTrainBatcher's nltk sent_tokenize, batcher.py:643).  Tries nltk,
    falls back to a punctuation split (nltk's punkt data may be absent)."""
    text = text.strip()
    if not text:
        return []
    try:  # pragma: no cover - depends on nltk data presence
        import nltk

        return nltk.tokenize.sent_tokenize(text)
    except (ImportError, LookupError):
        return [s for s in _SENT_RE.split(text) if s]


def reference_to_abstract(reference: str) -> str:
    """'<s> sent </s>'-wrap each sentence (batcher.py:642-644)."""
    return " ".join(f"{SENTENCE_START} {s} {SENTENCE_END}"
                    for s in sent_tokenize(reference))


def rows_to_examples(rows: Iterator[Row]) -> Iterator[Tuple[str, str, str, str]]:
    """(uuid, article, reference) rows -> batcher 4-tuples (the one
    adapter between the streaming row schema and SummaryExample).  An
    ``IDLE`` from the rows passes through."""
    for row in rows:
        if row is IDLE:
            yield IDLE
            continue
        uuid, article, reference = str(row[0]), str(row[1]), str(row[2])
        yield uuid, article, reference_to_abstract(reference), reference


class _MeshBatches:
    """The chief's global batches split over dp, for a Trainer on a mesh:
    every rank's ``next_batch`` takes the chief's next batch (or its end)
    over a process group of its own (the trainer's prefetch thread calls
    it while the step's collectives run on the others) and returns this
    rank's dp rows.  ``batcher`` is the chief's (None on the others)."""

    class _Rows:
        def __init__(self, arrays):
            self._arrays = arrays

        def as_arrays(self):
            return self._arrays

    def __init__(self, hps: HParams, batcher: Optional[Batcher]):
        self._plan = collectives.with_own_world(mesh_lib.make_mesh(hps))
        self._batcher = batcher

    def next_batch(self):
        batch = self._batcher.next_batch() if self._batcher else None
        arrays = collectives.broadcast_object(
            self._plan, None if batch is None else batch.as_arrays())
        if arrays is None:
            return None
        return self._Rows(self._plan.registry.dp_rows(arrays))


def train_dir_for(hps: HParams) -> str:
    """``<log_root>/<exp_name>/train``: the weights hand-off directory
    (train.py:64; SURVEY.md §3.1)."""
    return os.path.join(hps.log_root or ".", hps.exp_name or "exp", "train")


class PipelineStage(P.WithParams):
    """Base with params-JSON persistence (PipelineStage.toJson parity)."""

    def to_json(self) -> str:
        return self.params.to_json()

    def load_json(self, s: str) -> "PipelineStage":
        self.load_params_json(s)  # typed re-validation of declared params
        return self


class Estimator(PipelineStage):
    """flink-ml Estimator: fit(source) -> Model."""

    def fit(self, source: Source) -> "Model":
        raise NotImplementedError


class Model(PipelineStage):
    """flink-ml Model/Transformer: transform(source) -> rows."""

    def transform(self, source: Source, sink: Optional[Sink] = None) -> Sink:
        raise NotImplementedError

    def output_schema(self, input_schema: RowSchema) -> RowSchema:
        """Schema of transform()'s output rows, given the input table's;
        Pipeline chaining wraps intermediate rows in a CollectionSource
        with it.  Pass-through by default; stages that reshape the table
        override it."""
        return input_schema


class _BridgeFeeder:
    """Feed pump: source rows -> coded records -> RecordQueue,
    on a daemon thread (Flink streaming rows into Flink-AI-Extended's
    example-coding queue, SURVEY.md §2.6 item 3).

    A source error (socket drop, bad JSON, Kafka failure) is kept and
    raised on the consumer's side by ``finish()``: a failed stream must
    fail the job, not silently truncate the dataset.  A row the codec
    cannot encode counts ``pipeline/codec_errors_total`` and fails the
    stream the same way.  A consumer that stops early closes the queue,
    and the feeder stops reading its source.
    """

    def __init__(self, source: Source, selected_cols: List[str],
                 coding: ExampleCoding, q: bridge_lib.RecordQueue,
                 registry: obs.Registry):
        self._source = source
        self._cols = selected_cols
        self._coding = coding
        self._q = q
        self._reg = registry
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self.thread.start()

    def _run(self) -> None:
        c_rows = self._reg.counter("pipeline/rows_in_total")
        c_codec = self._reg.counter("pipeline/codec_errors_total")
        try:
            for row in self._source.rows():
                projected = self._source.schema.project_row(row, self._cols)
                try:
                    rec = self._coding.encode(projected)
                except (TypeError, ValueError, KeyError):
                    # a row the codec cannot encode poisons the stream:
                    # count it, then fail the job
                    c_codec.inc()
                    raise
                c_rows.inc()
                if not self._q.put(rec) and self._q.closed:
                    log.info("record queue closed by consumer; "
                             "cancelling source stream")
                    return
        except BaseException as e:  # raised again by finish()
            self.error = e
            self._reg.counter("pipeline/feeder_errors_total").inc()
            log.exception("source stream failed")
        finally:
            self._q.close()

    def finish(self) -> None:
        """Cancel any remaining stream, reap the thread, raise a source
        failure.  Callers run this after the consumer stops, early or
        not, so a stopped job neither leaks the feeder nor hides a
        source failure."""
        self._q.close()
        self.thread.join(timeout=10.0)
        if self.thread.is_alive():  # pragma: no cover - defensive
            log.warning("bridge feeder did not stop within 10s")
        if self.error is not None:
            raise RuntimeError("source stream failed mid-job; partial data "
                               "would corrupt the result") from self.error


def _rows_from_queue(q: bridge_lib.RecordQueue, coding: ExampleCoding,
                     ) -> Iterator[Row]:
    """Decoded rows until the queue is closed and drained; ``IDLE`` each
    time no record arrived within ``_POLL_S``."""
    while True:
        rec = q.get(timeout=_POLL_S)
        if rec is None:
            if q.closed and len(q) == 0:
                return
            yield IDLE
            continue
        yield coding.decode(rec)


def _bridge(source: Source, cols: List[str], hps: HParams):
    """One job's feeder (built, not started) and the batcher's example
    source over its queue."""
    in_schema = source.schema.select(cols)
    coding = ExampleCoding(in_schema, in_schema)
    q = bridge_lib.make_record_queue()
    feeder = _BridgeFeeder(source, cols, coding, q,
                           registry=obs.registry_for(hps))

    def example_source():
        # inference has no gold abstract; the reference text rides along
        return rows_to_examples(_rows_from_queue(q, coding))

    return feeder, example_source


class SummarizationModel(Model,
                         P.HasClusterConfig,
                         P.HasInferencePythonConfig,
                         P.HasInferenceSelectedCols,
                         P.HasInferenceOutputCols,
                         P.HasInferenceOutputTypes):
    """Generic inference stage (TFModel.java parity).

    transform() consumes (uuid, article, reference) rows, beam-decodes
    each article, and emits (uuid, article, summary, reference), the
    write_for_flink row (decode.py:159-185, flink_writer.py:22-34).
    """

    def __init__(self) -> None:
        P.WithParams.__init__(self)
        self._vocab_override: Optional[Vocab] = None

    def with_vocab(self, vocab: Vocab) -> "SummarizationModel":
        """Use ``vocab`` instead of reading ``vocab_path`` from disk."""
        self._vocab_override = vocab
        return self

    def _hps(self) -> HParams:
        argv = self.get_inference_hyper_params() or []
        return HParams.from_string(" ".join(argv)).replace(mode="decode")

    def _vocab(self, hps: HParams) -> Vocab:
        if self._vocab_override is not None:
            return self._vocab_override
        return Vocab(hps.vocab_path, hps.vocab_size)

    def output_schema(self, input_schema: RowSchema) -> RowSchema:
        return ARTICLE_OUTPUT_SCHEMA  # (uuid, article, summary, reference)

    def transform(self, source: Source, sink: Optional[Sink] = None,
                  max_batches: int = 0, serving: bool = False,
                  hierarchical: bool = False) -> Sink:
        """The synchronous path: bridge feeder -> batcher (distinct
        articles, partial batches after TRICKLE_WAIT_S) -> the decoder's
        loop over the newest checkpoint of the train directory; every
        decoded row goes to ``sink`` (a new CollectionSink when None) as
        soon as its batch is done.  ``max_batches`` > 0 stops after that
        many batches and cancels the rest of the stream."""
        if hierarchical:
            return self._transform_hierarchical(source, sink,
                                                max_batches=max_batches)
        if serving:
            return self._transform_serving(source, sink,
                                           max_batches=max_batches)
        hps = self._hps()
        hps.validate()
        vocab = self._vocab(hps)
        out_sink = sink if sink is not None else CollectionSink()
        mesh_lib.join_world(hps)
        # on a mesh the chief alone reads the source (the decoder
        # broadcasts its batches)
        chief = distributed.is_chief()
        feeder, batcher = None, None
        if chief:
            feeder, example_source = _bridge(
                source, self.get_inference_selected_cols(), hps)
            batcher = Batcher("", vocab, hps, single_pass=True,
                              example_source=example_source)
        # raises with no card and no --device=cpu, before the feeder starts
        decoder = BeamSearchDecoder(
            hps.replace(single_pass=False), vocab, batcher,
            train_dir=train_dir_for(hps),
            decode_root=os.path.join(hps.log_root or ".",
                                     hps.exp_name or "exp"))
        reg = obs.registry_for(hps)
        c_out = reg.counter("pipeline/rows_out_total")

        def emit(res):
            out_sink.write(res.as_row())
            c_out.inc()

        if feeder is not None:
            feeder.start()
        try:
            with obs.spans.span(reg, "pipeline/transform"):
                decoder.decode(result_sink=emit, max_batches=max_batches,
                               log_results=False)
        finally:
            if feeder is not None:
                feeder.finish()
        return out_sink

    def _transform_serving(self, source: Source,
                           sink: Optional[Sink] = None,
                           max_batches: int = 0) -> Sink:
        """Concurrent transform: a ServingServer drives the source/sink
        pair through its admission-controlled queue (JAX
        pipeline/estimator.py:320-355).  Serving batches are dynamic, so
        ``max_batches`` bounds the rows to ``max_batches * batch_size``
        (0 = the whole source)."""
        from textsummarization_on_flink_tpu_torch.serve.server import (
            ServingServer,
        )

        hps = self._hps()
        hps.validate()
        vocab = self._vocab(hps)
        out_sink = sink if sink is not None else CollectionSink()
        reg = obs.registry_for(hps)
        c_out = reg.counter("pipeline/rows_out_total")
        mesh_lib.join_world(hps)

        class _CountedSink(Sink):
            # the synchronous path's row accounting, into the caller's
            # own sink
            def write(self, row: Row) -> None:
                out_sink.write(row)
                c_out.inc()

        # raises with no card and no --device=cpu
        server = ServingServer(
            hps.replace(single_pass=False), vocab,
            train_dir=train_dir_for(hps),
            decode_root=os.path.join(hps.log_root or ".",
                                     hps.exp_name or "exp"),
            registry=reg)
        if not distributed.is_chief():
            server.follow()  # a mesh follower: the chief serves the rows
            return out_sink
        with obs.spans.span(reg, "pipeline/transform_serving"):
            with server:
                server.serve(source, _CountedSink(),
                             cols=self.get_inference_selected_cols(),
                             max_count=max_batches * hps.batch_size)
        return out_sink


    def _transform_hierarchical(self, source: Source,
                                sink: Optional[Sink] = None,
                                max_batches: int = 0) -> Sink:
        """Long-document transform: frames -> documents -> map-reduce.

        The stage owns the driver-side streaming state the server must
        not know about: the ``DocumentAssembler`` (frame reassembly) and
        one ``DocumentSession`` per doc id, so a doc id whose frame-set
        completes AGAIN is an append + re-summarize — the session's
        prior chunk keys make the front door dedup pinnable.  Chunk
        submits use block=True (pipeline backpressure, same stance as
        ``server.serve``); completed documents write to the sink from
        the parent future's done-callback, so sink order follows
        completion.  ``max_batches`` bounds completed DOCUMENT
        revisions (``max_batches * batch_size``), mirroring the other
        transform paths' row bound."""
        from textsummarization_on_flink_tpu_torch.pipeline.codec import (
            DocumentAssembler,
        )
        from textsummarization_on_flink_tpu_torch.serve.hiersum import (
            DocumentSession,
            HierarchicalSummarizer,
        )
        from textsummarization_on_flink_tpu_torch.serve.server import (
            ServingServer,
        )

        hps = self._hps()
        hps.validate()
        vocab = self._vocab(hps)
        out_sink = sink if sink is not None else CollectionSink()
        reg = obs.registry_for(hps)
        c_out = reg.counter("pipeline/rows_out_total")
        mesh_lib.join_world(hps)
        sel = self.get_inference_selected_cols()  # uuid, article, reference
        max_docs = max_batches * hps.batch_size
        assembler = DocumentAssembler(registry=reg)
        sessions = {}  # doc id -> DocumentSession
        last = {}  # doc id -> most recent revision's parent future
        futures: List = []
        errors: List[BaseException] = []
        lock = threading.Lock()

        def _emit(fut) -> None:
            # runs on the server's resolve thread — cheap append only
            if fut.error is not None:
                with lock:
                    errors.append(fut.error)
                return
            row = fut.result(timeout=0).as_row()
            with lock:
                out_sink.write(row)
                c_out.inc()

        # raises with no card and no --device=cpu
        server = ServingServer(
            hps.replace(single_pass=False), vocab,
            train_dir=train_dir_for(hps),
            decode_root=os.path.join(hps.log_root or ".",
                                     hps.exp_name or "exp"),
            registry=reg)
        if not distributed.is_chief():
            server.follow()  # a mesh follower: the chief serves the rows
            return out_sink
        truncated = False
        with obs.spans.span(reg, "pipeline/transform_hierarchical"):
            with server:
                hs = HierarchicalSummarizer(server, hps, registry=reg)
                for row in source.rows():
                    doc = assembler.feed(
                        source.schema.project_row(row, sel))
                    if doc is None:
                        continue
                    doc_id, article, reference = doc
                    sess = sessions.get(doc_id)
                    if sess is None:
                        sess = sessions[doc_id] = DocumentSession(
                            doc_id, article)
                    else:
                        # a revision: the new frame-set is APPENDED text.
                        # Serialize revisions per stream first — revision
                        # N+1's dedup rides the front-door CACHE, which
                        # only holds a chunk's entry once revision N's
                        # copy retired; overlapping in-flight revisions
                        # would coalesce instead of cache-hit.  One open
                        # document is one in-order stream.
                        prev = last.get(doc_id)
                        if prev is not None:
                            try:
                                prev.result()
                            except Exception:  # tslint: disable=TS005 — barrier only: the typed cause already landed in `errors` via _emit's done-callback and re-raises after the drain
                                pass
                        sess.append(article)
                    fut = hs.summarize("", reference=reference,
                                       session=sess, block=True)
                    last[doc_id] = fut
                    fut.add_done_callback(_emit)
                    futures.append(fut)
                    if max_docs and len(futures) >= max_docs:
                        truncated = True
                        break
                for fut in futures:
                    try:
                        fut.result()  # errors re-raise below, in order
                    except Exception:  # tslint: disable=TS005 — drain barrier: every rejection was captured typed in `errors` by _emit and the first re-raises after the loop
                        pass
        pending = assembler.pending()
        if pending and not truncated:
            raise RuntimeError(
                f"source stream ended with incomplete document "
                f"frame-sets: {pending}; partial documents would "
                f"corrupt the result")
        if errors:
            raise errors[0]
        return out_sink


class SummarizationEstimator(Estimator,
                             P.HasClusterConfig,
                             P.HasTrainPythonConfig,
                             P.HasInferencePythonConfig,
                             P.HasTrainSelectedCols,
                             P.HasTrainOutputCols,
                             P.HasTrainOutputTypes,
                             P.HasInferenceSelectedCols,
                             P.HasInferenceOutputCols,
                             P.HasInferenceOutputTypes):
    """Generic trainable stage (TFEstimator.java parity)."""

    def __init__(self) -> None:
        P.WithParams.__init__(self)
        self._vocab_override: Optional[Vocab] = None

    def with_vocab(self, vocab: Vocab) -> "SummarizationEstimator":
        """Use ``vocab`` instead of reading ``vocab_path`` from disk."""
        self._vocab_override = vocab
        return self

    def _hps(self) -> HParams:
        argv = self.get_train_hyper_params() or []
        return HParams.from_string(" ".join(argv)).replace(mode="train")

    def _vocab(self, hps: HParams) -> Vocab:
        if self._vocab_override is not None:
            return self._vocab_override
        return Vocab(hps.vocab_path, hps.vocab_size)

    def fit(self, source: Source) -> SummarizationModel:
        """Train ``hps.num_steps`` steps (0: until the stream ends) from
        the stream, in one pass, resuming from the newest checkpoint of
        the train directory; the final state is saved there."""
        hps = self._hps()
        hps.validate()
        device = resolve_device(hps.device)  # no card, no cpu: raise
        vocab = self._vocab(hps)
        on_mesh = mesh_lib.join_world(hps)
        feeder, batcher = None, None
        if distributed.is_chief():
            # the global batch: on a mesh split over dp by _MeshBatches
            feeder, example_source = _bridge(
                source, self.get_train_selected_cols(), hps)
            batcher = Batcher("", vocab, hps, single_pass=True,
                              example_source=example_source)
        if on_mesh:
            batcher = _MeshBatches(hps, batcher)
        train_dir = train_dir_for(hps)
        checkpointer = ckpt_lib.Checkpointer(train_dir, hps=hps)
        state = checkpointer.restore(device=device)
        if state is not None:
            log.info("resuming training from step %d", state.step)
        trainer = trainer_lib.Trainer(hps, vocab.size(), batcher,
                                      state=state, checkpointer=checkpointer,
                                      train_dir=train_dir)
        if feeder is not None:
            feeder.start()
        try:
            with obs.spans.span(obs.registry_for(hps), "pipeline/fit"):
                trainer.train(num_steps=hps.num_steps)
        finally:
            if feeder is not None:
                feeder.finish()
        return self._model()

    def _model(self) -> SummarizationModel:
        """A model configured with the inference side of these params
        (TFEstimator.java:86-96)."""
        model = SummarizationModel()
        model.set_coordinator_address(self.get_coordinator_address())
        model.set_worker_num(self.get_worker_num())
        model.set_ps_num(self.get_ps_num())
        if self.get_inference_scripts() is not None:
            model.set_inference_scripts(self.get_inference_scripts())
        model.set_inference_map_func(self.get_inference_map_func())
        model.set_inference_hyper_params_key(
            self.get_inference_hyper_params_key())
        if self.get_inference_hyper_params() is not None:
            model.set_inference_hyper_params(self.get_inference_hyper_params())
        if self.get_inference_env_path() is not None:
            model.set_inference_env_path(self.get_inference_env_path())
        model.set_inference_selected_cols(self.get_inference_selected_cols())
        model.set_inference_output_cols(self.get_inference_output_cols())
        model.set_inference_output_types(self.get_inference_output_types())
        if self._vocab_override is not None:
            model.with_vocab(self._vocab_override)
        return model


class Pipeline:
    """Pipeline(stages) with appendStage/fit semantics
    (TensorFlowTest.testPipeline, :170-202): an Estimator inside a
    pipeline works because fit and transform share one process."""

    def __init__(self, stages: Optional[List[PipelineStage]] = None):
        self.stages: List[PipelineStage] = list(stages or [])

    def append_stage(self, stage: PipelineStage) -> "Pipeline":
        self.stages.append(stage)
        return self

    @staticmethod
    def _apply(stage: Model, source: Source) -> Source:
        """Run one Model/Transformer stage, its output rows materialized
        as the next stage's source."""
        mid = stage.transform(source, CollectionSink())
        return CollectionSource(mid.rows,
                                schema=stage.output_schema(source.schema))

    def fit(self, source: Source) -> "Pipeline":
        """Fit every Estimator on the table as transformed by every
        preceding stage (flink-ml Pipeline.fit).  Chaining is lazy: the
        preceding stages run only when a later Estimator fits, so an
        estimator -> model pipeline never decodes its own training set."""
        fitted: List[PipelineStage] = []
        cur_source = source
        pending: List[Model] = []  # stages not yet applied to cur_source
        for stage in self.stages:
            if isinstance(stage, Estimator):
                for prior in pending:
                    cur_source = self._apply(prior, cur_source)
                pending = []
                model = stage.fit(cur_source)
                fitted.append(model)
                pending.append(model)
            else:
                fitted.append(stage)
                pending.append(stage)
        return Pipeline(fitted)

    def transform(self, source: Source, sink: Optional[Sink] = None) -> Sink:
        """Chain every Model stage: each stage's output rows become the
        next stage's source; the last stage writes into ``sink``."""
        models = [s for s in self.stages if isinstance(s, Model)]
        if not models:
            raise ValueError("pipeline has no Model stage to transform with")
        out = sink if sink is not None else CollectionSink()
        cur_source = source
        for stage in models[:-1]:
            cur_source = self._apply(stage, cur_source)
        return models[-1].transform(cur_source, out)
