"""Streaming summarization application (me/littlebo/App.java parity).

The port's counterpart of the JAX package's pipeline/app.py.  The
reference App wires two Kafka-driven jobs (App.java:202-207):

  1. ``start_training()``: consume ``flink_train``, fit the estimator,
     return the model's config JSON (App.java:83-106);
  2. ``start_inference(model_json)``: consume ``flink_input``, transform,
     sink summaries to ``flink_output`` (App.java:108-132).

They run one after the other in one process.  Sources and sinks are
pluggable: Kafka by default (topics App.java:32-34), or any Source/Sink,
as the reference's socket test does (TensorFlowTest.java:123-140).

Hyperparameters follow App.java:40-81: one argv string per role, rendered
from an HParams.  The defaults mirror the reference's app settings
(batch 2/4, encoder 50/400 steps, decoder 10/100, beam 4, vocab 50k,
coverage on) and run on ``cuda``; pass ``device="cpu"`` in both HParams
to run on the CPU.
"""

from __future__ import annotations

import logging
import shlex
from typing import Optional

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
from textsummarization_on_flink_tpu_torch.pipeline.estimator import (
    SummarizationEstimator,
    SummarizationModel,
)
from textsummarization_on_flink_tpu_torch.pipeline.io import (
    DataTypes,
    KafkaSink,
    KafkaSource,
    Sink,
    Source,
)

log = logging.getLogger(__name__)

# App.java:32-34
TRAIN_TOPIC = "flink_train"
INPUT_TOPIC = "flink_input"
OUTPUT_TOPIC = "flink_output"

_COLS = ["uuid", "article", "reference"]
_OUTPUT_COLS = ["uuid", "article", "summary", "reference"]


def default_train_hps(log_root: str, exp_name: str = "exp",
                      vocab_path: str = "", num_steps: int = 0) -> HParams:
    """App.java:55-68 training hyperparameters (train side)."""
    return HParams(mode="train", num_steps=num_steps, batch_size=2,
                   max_enc_steps=50, max_dec_steps=10, vocab_size=50000,
                   log_root=log_root, exp_name=exp_name,
                   vocab_path=vocab_path, coverage=True)


def default_inference_hps(log_root: str, exp_name: str = "exp",
                          vocab_path: str = "") -> HParams:
    """App.java:69-81 inference hyperparameters (decode side)."""
    return HParams(mode="decode", batch_size=4, max_enc_steps=400,
                   max_dec_steps=100, beam_size=4, min_dec_steps=35,
                   vocab_size=50000, log_root=log_root, exp_name=exp_name,
                   vocab_path=vocab_path, coverage=True, single_pass=False)


class App:
    """The application.  Construct with explicit sources and sinks, or
    rely on the Kafka defaults (App.java topology)."""

    def __init__(self, train_hps: HParams, inference_hps: HParams,
                 vocab: Optional[Vocab] = None,
                 bootstrap_servers: str = "localhost:9092"):
        self.train_hps = train_hps
        self.inference_hps = inference_hps
        self.vocab = vocab
        self.bootstrap_servers = bootstrap_servers

    # -- wiring (createEstimator / createModel, App.java:147-200) --
    def create_estimator(self) -> SummarizationEstimator:
        e = SummarizationEstimator()
        e.set_worker_num(1).set_ps_num(0)  # App.java:148-149
        (e.set_train_selected_cols(_COLS)
          .set_train_output_cols(["uuid"])
          .set_train_output_types([DataTypes.STRING]))
        e.set_train_hyper_params(shlex.split(self.train_hps.to_argv()))
        (e.set_inference_selected_cols(_COLS)
          .set_inference_output_cols(_OUTPUT_COLS)
          .set_inference_output_types([DataTypes.STRING] * 4))
        e.set_inference_hyper_params(shlex.split(self.inference_hps.to_argv()))
        if self.vocab is not None:
            e.with_vocab(self.vocab)
        return e

    def create_model(self) -> SummarizationModel:
        m = SummarizationModel()
        m.set_worker_num(1).set_ps_num(0)
        (m.set_inference_selected_cols(_COLS)
          .set_inference_output_cols(_OUTPUT_COLS)
          .set_inference_output_types([DataTypes.STRING] * 4))
        m.set_inference_hyper_params(shlex.split(self.inference_hps.to_argv()))
        if self.vocab is not None:
            m.with_vocab(self.vocab)
        return m

    # -- jobs --
    def start_training(self, source: Optional[Source] = None,
                       max_count: int = 1000) -> str:
        """Train from the stream; returns the fitted model's config JSON
        (App.startTraining, :83-106; max_count bounds the Kafka stream
        like MessageDeserializationSchema.java:34-40)."""
        src = source or KafkaSource(TRAIN_TOPIC, self.bootstrap_servers,
                                    max_count=max_count)
        estimator = self.create_estimator()
        reg = obs.registry_for(self.train_hps)
        with obs.spans.span(reg, "pipeline/train_job"):
            model = estimator.fit(src)
        reg.counter("pipeline/train_jobs_total").inc()
        model_json = model.to_json()
        log.info("trained model config: %s", model_json)
        return model_json

    def start_inference(self, model_json: Optional[str] = None,
                        source: Optional[Source] = None,
                        sink: Optional[Sink] = None,
                        max_count: int = 0, serving: bool = False) -> Sink:
        """Serve summaries from the stream (App.startInference, :108-132).
        ``serving=True`` routes the rows through the concurrent serve
        layer (micro-batches, admission control; serve/server.py) instead
        of the synchronous decode loop: the same sources, sinks and
        output rows (JAX pipeline/app.py:127-150)."""
        src = source or KafkaSource(INPUT_TOPIC, self.bootstrap_servers,
                                    max_count=max_count)
        out = sink or KafkaSink(OUTPUT_TOPIC, self.bootstrap_servers)
        if model_json is not None:
            model = SummarizationModel().load_json(model_json)
            if self.vocab is not None:
                model.with_vocab(self.vocab)
        else:
            model = self.create_model()
        reg = obs.registry_for(self.inference_hps)
        with obs.spans.span(reg, "pipeline/inference_job"):
            result = model.transform(src, out, serving=serving)
        reg.counter("pipeline/inference_jobs_total").inc()
        return result

    def main(self, train_source: Optional[Source] = None,
             infer_source: Optional[Source] = None,
             sink: Optional[Sink] = None) -> Sink:
        """Sequential train-then-serve (App.main, :202-207)."""
        model_json = self.start_training(train_source)
        return self.start_inference(model_json, infer_source, sink)
