"""TF1 pretrained-checkpoint importer (the pretrained_model_tf1.2.1 layout).

Port of the JAX package's checkpoint/tf1_import.py: it maps the reference
graph's TF1 variable names onto the pointer-generator's params tree, so
the published checkpoint can be trained on or served without retraining.
The names follow the variable scopes of the reference's model.py
(seq2seq/embedding:210, encoder:89, reduce_final_st:108,
output_projection:228) and attention_decoder.py (W_h:66, v:70,
coverage/w_c:73, Attention/Linear:91+219, calculate_pgen:165,
AttnOutputProjection:172); LSTM cells use TF >= 1.2's fused
``lstm_cell/kernel`` naming.

  * ``import_tf1_arrays(name -> ndarray)``: pure numpy, no TensorFlow —
    feed it from any tool that reads a TF bundle;
  * ``import_tf1_checkpoint(path)``: reads the bundle with TensorFlow
    where it imports, else raises with instructions;
  * ``import_to_train_dir``: bundle -> a training checkpoint of the port.

Conv-shaped attention tensors are squeezed: W_h [1, 1, 2H, D] -> [2H, D],
w_c [1, 1, 1, D] -> [D].
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from textsummarization_on_flink_tpu_torch.config import HParams

_DEC = "seq2seq/decoder/attention_decoder"

# TF1 variable name -> (tree path, squeeze)
TF1_NAME_MAP: Dict[str, Any] = {
    "seq2seq/embedding/embedding": (("embedding",), False),
    "seq2seq/encoder/bidirectional_rnn/fw/lstm_cell/kernel":
        (("encoder", "fw", "kernel"), False),
    "seq2seq/encoder/bidirectional_rnn/fw/lstm_cell/bias":
        (("encoder", "fw", "bias"), False),
    "seq2seq/encoder/bidirectional_rnn/bw/lstm_cell/kernel":
        (("encoder", "bw", "kernel"), False),
    "seq2seq/encoder/bidirectional_rnn/bw/lstm_cell/bias":
        (("encoder", "bw", "bias"), False),
    "seq2seq/reduce_final_st/w_reduce_c": (("reduce", "w_reduce_c"), False),
    "seq2seq/reduce_final_st/w_reduce_h": (("reduce", "w_reduce_h"), False),
    "seq2seq/reduce_final_st/bias_reduce_c":
        (("reduce", "bias_reduce_c"), False),
    "seq2seq/reduce_final_st/bias_reduce_h":
        (("reduce", "bias_reduce_h"), False),
    f"{_DEC}/W_h": (("decoder", "attention", "W_h"), True),
    f"{_DEC}/v": (("decoder", "attention", "v"), False),
    f"{_DEC}/coverage/w_c": (("decoder", "attention", "w_c"), True),
    f"{_DEC}/Attention/Linear/Matrix":
        (("decoder", "attention", "linear_kernel"), False),
    f"{_DEC}/Attention/Linear/Bias":
        (("decoder", "attention", "linear_bias"), False),
    f"{_DEC}/Linear/Matrix": (("decoder", "input_linear", "kernel"), False),
    f"{_DEC}/Linear/Bias": (("decoder", "input_linear", "bias"), False),
    f"{_DEC}/lstm_cell/kernel": (("decoder", "cell", "kernel"), False),
    f"{_DEC}/lstm_cell/bias": (("decoder", "cell", "bias"), False),
    f"{_DEC}/calculate_pgen/Linear/Matrix":
        (("decoder", "pgen_linear", "kernel"), False),
    f"{_DEC}/calculate_pgen/Linear/Bias":
        (("decoder", "pgen_linear", "bias"), False),
    f"{_DEC}/AttnOutputProjection/Linear/Matrix":
        (("decoder", "output_linear", "kernel"), False),
    f"{_DEC}/AttnOutputProjection/Linear/Bias":
        (("decoder", "output_linear", "bias"), False),
    "seq2seq/output_projection/w": (("output_projection", "w"), False),
    "seq2seq/output_projection/v": (("output_projection", "v"), False),
}

# skipped: optimizer slots and bookkeeping
_SKIP_SUFFIXES = ("/Adagrad",)
_SKIP_NAMES = ("global_step", "train_step/last_loss")


def import_tf1_arrays(tf1_vars: Dict[str, np.ndarray],
                      strict: bool = True) -> Dict[str, Any]:
    """The params tree (numpy f32 leaves) from a {tf1_name: ndarray} dict.
    A missing ``coverage/w_c`` is taken (a non-coverage checkpoint; see
    params.add_coverage_params); with ``strict`` an unmapped name raises,
    and a missing required one always does."""
    params: Dict[str, Any] = {}
    seen = set()
    for name, value in tf1_vars.items():
        if name in _SKIP_NAMES or any(name.endswith(s)
                                      for s in _SKIP_SUFFIXES):
            continue
        if name not in TF1_NAME_MAP:
            if strict:
                raise KeyError(f"unmapped TF1 variable: {name!r} "
                               f"shape {np.shape(value)}")
            continue
        path, squeeze = TF1_NAME_MAP[name]
        v = np.asarray(value, dtype=np.float32)
        if squeeze:
            v = np.squeeze(v)
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
        seen.add(name)
    missing = set(TF1_NAME_MAP) - {f"{_DEC}/coverage/w_c"} - seen
    if missing:
        raise KeyError(f"TF1 checkpoint missing variables: {sorted(missing)}")
    return params


def import_tf1_checkpoint(path: str, strict: bool = True) -> Dict[str, Any]:
    """Read a TF checkpoint bundle (needs TensorFlow)."""
    try:
        from tensorflow.python.training import py_checkpoint_reader
        reader = py_checkpoint_reader.NewCheckpointReader(path)
    except ImportError as e:
        raise ImportError(
            "tensorflow is not available in this environment; dump the "
            "checkpoint to {name: ndarray} with any TF installation and "
            "call import_tf1_arrays instead") from e
    shapes = reader.get_variable_to_shape_map()
    return import_tf1_arrays({n: reader.get_tensor(n) for n in shapes},
                             strict=strict)


def infer_hps_from_params(params: Dict[str, Any],
                          base: Optional[HParams] = None) -> HParams:
    """The model dims the checkpoint was trained with (embedding [V, E],
    the encoder's fused kernel [E + H, 4H]); ``base`` gives the other
    fields."""
    base = base if base is not None else HParams()
    vsize, emb = np.shape(params["embedding"])
    hidden = np.shape(params["encoder"]["fw"]["kernel"])[1] // 4
    has_cov = "w_c" in params["decoder"]["attention"]
    return base.replace(vocab_size=int(vsize), emb_dim=int(emb),
                        hidden_dim=int(hidden),
                        coverage=bool(base.coverage or has_cov))


def import_to_train_dir(bundle_path: str, train_dir: str,
                        hps: Optional[HParams] = None, strict: bool = True,
                        seed: int = 0) -> str:
    """TF1 bundle -> a training checkpoint in ``train_dir``, with fresh
    Adagrad accumulators (the reference's restore_best_model drops them
    too, run_summarization.py:132-154) and, under coverage hps, fresh
    coverage params for a bundle without them (:157-178).  Returns the
    saved checkpoint's path."""
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )
    from textsummarization_on_flink_tpu_torch.params import (
        add_coverage_params,
    )
    from textsummarization_on_flink_tpu_torch.train import (
        trainer as trainer_lib,
    )

    params = import_tf1_checkpoint(bundle_path, strict=strict)
    hps = infer_hps_from_params(params, base=hps)
    if hps.coverage and "w_c" not in params["decoder"]["attention"]:
        params = add_coverage_params(params, seed)
    state = trainer_lib.init_train_state(hps, hps.vocab_size, params=params,
                                         device="cpu")
    return ckpt_lib.Checkpointer(train_dir, hps=hps).save(state)
