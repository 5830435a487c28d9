"""The port's cost model of its own dispatches: the analytic price the
profiler's divergence sentinel (obs/profile.py) holds each dispatch's
measured wall against.

The JAX package prices a dispatch shape with XLA's cost analysis of the
compiled program (``__graft_entry__``'s ``train_step_cost``,
``decode_step_cost`` and ``prefill_cost``).  Eager PyTorch compiles no
program to ask, and ``torch.utils.flop_counter`` neither sees the ctypes
kernels on the card nor is cheap enough to run at full width beside a
host-bound loop.  So this module counts in closed form, from hps and the
shape alone (no tensor is made):

  * ``flops``: 2 x the multiply-adds of every matrix product the
    dispatch runs, as the port's code writes them (``@``, ``einsum``,
    ``bmm``): the biLSTM and decoder-LSTM gates, the additive attention's
    context product and decoder features, the transformer's projections,
    flash and cross-attention products and FFNs, the AAN's gate and
    FFNs, the vocab projection.  Elementwise work (the additive
    attention's tanh energies, softmaxes, LayerNorms, the optimizer) is
    not counted.  Training counts each forward product's backward as two
    products (one per operand that takes a gradient: one where the other
    operand is a constant, such as the zero initial LSTM state), the
    fused attention's backward as its one product, a flash attention's
    backward as its five (the recomputed scores, dP, dV, dK, dQ), and
    the recompute of ``--remat`` (up to a remat'd layer's last product,
    where the checkpoint's recompute stops) and ``--loss_chunk``.  A flash
    attention's scores are priced over the full [T, T] square, causal or
    not, as the plain version computes them.
  * ``bytes``: the parameters read once per forward (in training plus
    the gradients written and the Adagrad accumulators read and written,
    at ``--opt_state_dtype``), plus the dominant activations: for decode
    the encoder-side state and the KV cache the step reads, for training
    the encoder states and, unless ``--loss_chunk`` streams them, the
    [T_dec, B, V] f32 scores.

The sentinel compares a shape only with its own warm baseline, so what
it needs is a price that is the same for every dispatch of a shape;
tests/test_torch_cost.py holds the FLOPs to ``FlopCounterMode``'s count
of the same dispatch on the CPU.  On a mesh (``dp * tp * sp > 1``) a
rank is priced at its share: the products and activations split over
the ranks, the parameters over tp.
"""

from __future__ import annotations

from typing import Dict, Optional

from textsummarization_on_flink_tpu_torch.config import (
    HParams,
    resolve_draft_hidden,
)

F32 = 4


def _bytes_of(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else F32


class _Tally:
    """Multiply-adds of a dispatch's forward and backward products, and
    the weight matrices its products read (by name, once each)."""

    def __init__(self) -> None:
        self.fwd = 0
        self.bwd = 0
        self.weights: Dict[str, int] = {}

    def mm(self, m: int, k: int, n: int, weight: Optional[str] = None,
           bwd: int = 2) -> None:
        """An [m, k] @ [k, n] product; ``bwd`` products of its size in
        the backward; ``weight`` names a [k, n] parameter operand."""
        self.fwd += m * k * n
        self.bwd += bwd * m * k * n
        if weight is not None:
            self.weights[weight] = k * n

    def weight_elems(self) -> int:
        return sum(self.weights.values())


# --------------------------------------------------------------------------
# Parameter counts (params.py's trees, in closed form)
# --------------------------------------------------------------------------

def _ln_params(H: int) -> int:
    return 2 * H


def _ffn_params(H: int, F: int) -> int:
    return H * F + F + F * H + H


def _tf_layer_params(H: int, F: int, decoder: bool) -> int:
    attn = 4 * H * H
    if not decoder:
        return attn + 2 * _ln_params(H) + _ffn_params(H, F)
    cross = 4 * H * H
    return attn + cross + 3 * _ln_params(H) + _ffn_params(H, F)


def param_count(hps: HParams) -> int:
    """The number of parameters of ``hps``'s family (params.py's tree)."""
    V = hps.vocab_size
    H = hps.hidden_dim
    if hps.model_family == "pointer_generator":
        E, D = hps.emb_dim, 2 * hps.hidden_dim
        lstm = (E + H) * 4 * H + 4 * H
        attention = D * D + 2 * H * D + D + 2 * D
        return (V * E + 2 * lstm + 2 * (2 * H * H + H) + attention
                + (E + D) * E + E + lstm + (D + 2 * H + E) + 1
                + (H + D) * H + H + H * V + V)
    F = hps.ffn_width
    T_pos = hps.max_enc_steps + hps.max_dec_steps + 1
    enc = hps.enc_layers * _tf_layer_params(H, F, False) \
        + _ln_params(H)
    if hps.model_family == "transformer":
        dec = hps.dec_layers * _tf_layer_params(H, F, True) \
            + _ln_params(H)
        return V * H + T_pos * H + enc + dec + 2 * H + 1 + V
    Hd = resolve_draft_hidden(hps)
    Fd = hps.ffn_dim or 4 * Hd
    layer = (Hd * Hd + 2 * H * Hd + Hd * Hd + 3 * _ln_params(Hd)
             + _ffn_params(Hd, Fd) + _ffn_params(Hd, Fd)
             + 2 * Hd * 2 * Hd + 2 * Hd)
    dec = hps.dec_layers * layer + _ln_params(Hd)
    extra = (H * Hd if Hd != H else 0)
    head = (Hd * hps.draft_vocab_rank + hps.draft_vocab_rank * V
            if hps.draft_vocab_rank else 0)
    return V * H + T_pos * H + enc + dec + 2 * Hd + 1 + V + extra + head


# --------------------------------------------------------------------------
# The pointer-generator
# --------------------------------------------------------------------------

def _pg_encoder(t: _Tally, hps: HParams, B: int, T: int) -> None:
    """Embedding -> biLSTM (input half hoisted, both directions in one
    product per step) -> state reduction -> encoder features."""
    E, H = hps.emb_dim, hps.hidden_dim
    D = 2 * H
    t.mm(2 * B * T, E, 4 * H, "enc_kernel_x")
    for step in range(T):
        # the first step's h is a constant zero state
        t.mm(2 * B, H, 4 * H, "enc_kernel_h", bwd=1 if step == 0 else 2)
    t.mm(2 * B, D, H, "reduce")
    t.mm(B * T, D, D, "W_h")


def _pg_attend(t: _Tally, hps: HParams, R: int, T_att: int) -> None:
    """Decoder features and the context product of one attention query
    per row over T_att encoder positions (the fused attention's
    backward has one product: es . g_ctx)."""
    D = 2 * hps.hidden_dim
    t.mm(R, D, D, "attn_linear")
    t.mm(R, T_att, D, bwd=1)


def _pg_decode_step(t: _Tally, hps: HParams, B: int, K: int,
                    T_att: int) -> None:
    """One beam step of B articles x K hypotheses (the previous-state
    attention, the input merge, the cell, the new-state attention, the
    heads and the vocab projection)."""
    E, H = hps.emb_dim, hps.hidden_dim
    D = 2 * H
    R = B * K
    _pg_attend(t, hps, R, T_att)
    t.mm(R, E + D, E, "input_linear")
    t.mm(R, E + H, 4 * H, "cell")
    _pg_attend(t, hps, R, T_att)
    t.mm(R, D + 2 * H + E, 1, "pgen")
    t.mm(R, H + D, H, "output_linear")
    t.mm(R, H, hps.vocab_size, "output_projection")


def _pg_train(t: _Tally, hps: HParams, B: int) -> None:
    E, H = hps.emb_dim, hps.hidden_dim
    D = 2 * H
    T_enc, T_dec = hps.max_enc_steps, hps.max_dec_steps
    _pg_encoder(t, hps, B, T_enc)
    t.mm(B * T_dec, E, E, "input_linear_x")
    for step in range(T_dec):
        # the first step's context is a constant zero
        t.mm(B, D, E, "input_linear_ctx", bwd=1 if step == 0 else 2)
        t.mm(B, E + H, 4 * H, "cell")
        _pg_attend(t, hps, B, T_enc)
        t.mm(B, D + 2 * H + E, 1, "pgen", bwd=2 if hps.pointer_gen else 0)
        t.mm(B, H + D, H, "output_linear")
    _vocab_train(t, hps, B * T_dec, H, "output_projection",
                 remat=hps.remat and not hps.loss_chunk)


def _vocab_train(t: _Tally, hps: HParams, rows: int, H: int,
                 name: str, remat: bool) -> None:
    """The training vocab projection: materialised (recomputed under
    --remat) or streamed in chunks of decoder steps, recomputed in the
    backward, over the steps padded to a whole chunk."""
    V = hps.vocab_size
    if hps.loss_chunk > 0:
        T = hps.max_dec_steps
        c = min(hps.loss_chunk, T)
        padded = -(-T // c) * c
        t.mm(rows // T * padded, H, V, name, bwd=3)
    else:
        t.mm(rows, H, V, name, bwd=3 if remat else 2)


# --------------------------------------------------------------------------
# The transformer and the AAN
# --------------------------------------------------------------------------

def _flash(t: _Tally, B: int, T: int, H: int, train: bool) -> None:
    """One flash attention over [T, T] scores (H = heads x head dim):
    forward QK^T and PV, backward the five products."""
    t.mm(B * T, H, T, bwd=3 if train else 0)
    t.mm(B * T, T, H, bwd=2 if train else 0)


def _tf_encoder(t: _Tally, hps: HParams, B: int, T: int,
                train: bool) -> None:
    H, F = hps.hidden_dim, hps.ffn_width
    remat = train and hps.remat  # a remat'd layer's forward runs twice
    b = 3 if remat else 2
    for li in range(hps.enc_layers):
        for w in ("wq", "wk", "wv", "wo"):
            t.mm(B * T, H, H, f"enc{li}_{w}", bwd=b)
        _flash(t, B, T, H, train)
        if remat:
            _flash(t, B, T, H, False)
        t.mm(B * T, H, F, f"enc{li}_w1", bwd=b)
        # the layer's last product: the recompute stops before it (the
        # non-reentrant checkpoint ends once the saved tensors are back)
        t.mm(B * T, F, H, f"enc{li}_w2")


def _cross_kv(t: _Tally, hps: HParams, B: int, T: int, Hd: int) -> None:
    for li in range(hps.dec_layers):
        t.mm(B * T, hps.hidden_dim, Hd, f"dec{li}_cross_wk")
        t.mm(B * T, hps.hidden_dim, Hd, f"dec{li}_cross_wv")


def _decoder_widths(hps: HParams):
    if hps.model_family == "avg_attention":
        Hd = resolve_draft_hidden(hps)
        return Hd, hps.ffn_dim or 4 * Hd
    return hps.hidden_dim, hps.ffn_width


def _vocab_rows(t: _Tally, hps: HParams, R: int, Hd: int,
                train: bool) -> None:
    """The vocab projection of R rows: the tied embedding's transpose,
    or the narrow AAN draft's factored head, (h @ w1) @ w2, which the
    streaming losses of training form as w1 @ w2 once.  The loss head is
    outside the remat'd layers."""
    V = hps.vocab_size
    r = hps.draft_vocab_rank if hps.model_family == "avg_attention" else 0
    if r and not (train and hps.loss_chunk):
        t.mm(R, Hd, r, "vocab_w1")
        t.mm(R, r, V, "vocab_w2")
    elif train:
        if r:
            t.mm(Hd, r, V, "vocab_w1w2")
        _vocab_train(t, hps, R, Hd, "embedding_T", remat=False)
    else:
        t.mm(R, Hd, V, "embedding_T")


def _tf_decode_step(t: _Tally, hps: HParams, B: int, K: int, T_att: int,
                    T_cache: int) -> None:
    """One beam step of B articles x K hypotheses: per decoder layer the
    self-attention over the whole cache (masked past each step) or the
    AAN's average branch, the cross-attention over T_att keys, the FFN;
    then p_gen and the vocab projection."""
    H = hps.hidden_dim
    Hd, Fd = _decoder_widths(hps)
    R = B * K
    aan = hps.model_family == "avg_attention"
    if aan and Hd != H:
        t.mm(R, H, Hd, "emb_proj")
    for li in range(hps.dec_layers):
        if aan:
            t.mm(R, Hd, Fd, f"dec{li}_aan_w1")
            t.mm(R, Fd, Hd, f"dec{li}_aan_w2")
            t.mm(R, 2 * Hd, 2 * Hd, f"dec{li}_gate")
        else:
            for w in ("wq", "wk", "wv"):
                t.mm(R, Hd, Hd, f"dec{li}_{w}")
            t.mm(R, Hd, T_cache)
            t.mm(R, T_cache, Hd)
            t.mm(R, Hd, Hd, f"dec{li}_wo")
        t.mm(R, Hd, Hd, f"dec{li}_cross_wq")
        t.mm(R, Hd, T_att)
        t.mm(R, T_att, Hd)
        t.mm(R, Hd, Hd, f"dec{li}_cross_wo")
        t.mm(R, Hd, Fd, f"dec{li}_w1")
        t.mm(R, Fd, Hd, f"dec{li}_w2")
    _vocab_rows(t, hps, R, Hd, train=False)
    t.mm(R, 2 * Hd, 1, "pgen")


def _tf_train(t: _Tally, hps: HParams, B: int) -> None:
    H = hps.hidden_dim
    Hd, Fd = _decoder_widths(hps)
    T_enc, T_dec = hps.max_enc_steps, hps.max_dec_steps
    aan = hps.model_family == "avg_attention"
    _tf_encoder(t, hps, B, T_enc, True)
    R = B * T_dec
    b = 3 if hps.remat else 2  # a remat'd layer's forward runs twice
    if aan and Hd != H:
        t.mm(R, H, Hd, "emb_proj")
    for li in range(hps.dec_layers):
        if aan:
            t.mm(R, Hd, Fd, f"dec{li}_aan_w1", bwd=b)
            t.mm(R, Fd, Hd, f"dec{li}_aan_w2", bwd=b)
            t.mm(R, 2 * Hd, 2 * Hd, f"dec{li}_gate", bwd=b)
        else:
            for w in ("wq", "wk", "wv", "wo"):
                t.mm(R, Hd, Hd, f"dec{li}_{w}", bwd=b)
            _flash(t, B, T_dec, Hd, True)
            if hps.remat:
                _flash(t, B, T_dec, Hd, False)
        t.mm(R, Hd, Hd, f"dec{li}_cross_wq", bwd=b)
        t.mm(B * T_enc, H, Hd, f"dec{li}_cross_wk", bwd=b)
        t.mm(B * T_enc, H, Hd, f"dec{li}_cross_wv", bwd=b)
        t.mm(R, Hd, T_enc, bwd=b)
        t.mm(R, T_enc, Hd, bwd=b)
        t.mm(R, Hd, Hd, f"dec{li}_cross_wo", bwd=b)
        t.mm(R, Hd, Fd, f"dec{li}_w1", bwd=b)
        t.mm(R, Fd, Hd, f"dec{li}_w2")  # last: not recomputed
    # p_gen takes a gradient only where the pointer mixture reads it
    t.mm(R, 2 * Hd, 1, "pgen", bwd=2 if hps.pointer_gen else 0)
    _vocab_rows(t, hps, R, Hd, train=True)


# --------------------------------------------------------------------------
# The three dispatch prices
# --------------------------------------------------------------------------

def _ranks(hps: HParams) -> int:
    return max(hps.dp * hps.tp * hps.sp, 1)


def _price(t: _Tally, weight_bytes: float, act_bytes: float,
           train: bool, hps: HParams) -> Dict[str, float]:
    macs = t.fwd + (t.bwd if train else 0)
    return {"flops": 2.0 * macs / _ranks(hps),
            "bytes": float(weight_bytes / max(hps.tp, 1)
                           + act_bytes / _ranks(hps))}


def _act_bytes(hps: HParams) -> int:
    return _bytes_of(hps.compute_dtype)


def train_step_cost(hps: HParams, steps: int = 1) -> Dict[str, float]:
    """The price of a train dispatch of ``steps`` steps of ``hps``'s
    family at batch_size x max_enc_steps x max_dec_steps."""
    t = _Tally()
    B = hps.batch_size
    if hps.model_family == "pointer_generator":
        _pg_train(t, hps, B)
        enc = B * hps.max_enc_steps * 2 * hps.hidden_dim
    else:
        _tf_train(t, hps, B)
        enc = B * hps.max_enc_steps * hps.hidden_dim
    P = param_count(hps)
    acc = _bytes_of(hps.opt_state_dtype)
    weights = P * (F32 + F32 + 2 * acc)
    act = enc * _act_bytes(hps)
    if hps.loss_chunk == 0:
        act += hps.max_dec_steps * B * hps.vocab_size * F32
    one = _price(t, weights, act, True, hps)
    return {k: v * steps for k, v in one.items()}


def decode_step_cost(hps: HParams, path: str = "batch",
                     chunk: Optional[int] = None,
                     enc_len: Optional[int] = None) -> Dict[str, float]:
    """The price of a decode dispatch.  ``path="batch"``: the batch
    search of batch_size articles, its encoder and ``chunk`` (default
    max_dec_steps) beam steps.  ``path="slot"``: one slot-engine chunk of
    ``chunk`` (default min(max_dec_steps, 25), the JAX package's) beam
    steps over batch_size resident slots, the cross-attention over
    ``enc_len`` (default max_enc_steps) encoder positions."""
    if path not in ("batch", "slot"):
        raise ValueError(f"path must be 'batch' or 'slot', got {path!r}")
    B, K = hps.batch_size, hps.beam_size
    T_enc = hps.max_enc_steps
    T_att = int(enc_len) if enc_len is not None else T_enc
    if path == "slot":
        steps = int(chunk or min(hps.max_dec_steps, 25))
    else:
        steps = int(chunk or hps.max_dec_steps)
    enc = _Tally()
    if path == "batch":
        _encode(enc, hps, B, T_enc)
    step = _Tally()
    if hps.model_family == "pointer_generator":
        _pg_decode_step(step, hps, B, K, T_att)
        # the encoder states and features each step reads
        enc_read = 2 * B * T_att * 2 * hps.hidden_dim * _act_bytes(hps)
        cache = 0
    else:
        Hd, _ = _decoder_widths(hps)
        _tf_decode_step(step, hps, B, K, T_att, hps.max_dec_steps + 1)
        enc_read = 2 * hps.dec_layers * B * T_att * Hd * _act_bytes(hps)
        cache = 0
        if hps.model_family == "transformer":
            cache = (2 * hps.dec_layers * B * K * (hps.max_dec_steps + 1)
                     * Hd * _bytes_of(hps.decode_cache_dtype))
    t = _Tally()
    t.fwd = enc.fwd + steps * step.fwd
    weights = (enc.weight_elems() + steps * step.weight_elems()) * F32
    return _price(t, weights, steps * (enc_read + cache), False, hps)


def _encode(t: _Tally, hps: HParams, B: int, T: int) -> None:
    """The beam encoder of B articles of T positions (the transformer's
    and the AAN's with their cross-attention K/V)."""
    if hps.model_family == "pointer_generator":
        _pg_encoder(t, hps, B, T)
    else:
        _tf_encoder(t, hps, B, T, False)
        _cross_kv(t, hps, B, T, _decoder_widths(hps)[0])


def prefill_cost(hps: HParams, bucket: int) -> Dict[str, float]:
    """The price of one prefill: the encoder of one article at ``bucket``
    positions, and the encoder view it writes."""
    t = _Tally()
    T = int(bucket)
    _encode(t, hps, 1, T)
    if hps.model_family == "pointer_generator":
        out = 2 * T * 2 * hps.hidden_dim
    else:
        out = 2 * hps.dec_layers * T * _decoder_widths(hps)[0]
    return _price(t, t.weight_elems() * F32, out * _act_bytes(hps), False,
                  hps)
