"""LSTM cell + length-aware bidirectional encoder, TF1-compatible math.

Port of the JAX package's ops/lstm.py.  The reference cells are
`tf.contrib.rnn.LSTMCell` (model.py:90-92,138): gate order [i, j, f, o]
on the fused kernel and forget_bias=1.0,

    z = [x, h] @ kernel + bias
    i, j, f, o = split(z, 4)
    c' = c * sigmoid(f + 1.0) + sigmoid(i) * tanh(j)
    h' = tanh(c') * sigmoid(o)

so a TF1 checkpoint's fused kernel/bias load verbatim.  The encoder
matches `tf.nn.bidirectional_dynamic_rnn` with sequence_length
(model.py:92): outputs past each length are zeros, the carried state
freezes at the last valid step, and the backward direction runs over the
length-aware reversed sequence.  Both directions share one loop over
time, stacked on a leading direction axis, and the input half of each
kernel is hoisted out of the loop as one whole-sequence matmul; only
the recurrent ``h @ k_h`` half is sequential.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

LSTMState = Tuple[torch.Tensor, torch.Tensor]  # (c, h)


def _apply_gates(z: torch.Tensor, c: torch.Tensor, forget_bias: float,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TF1 LSTMCell gate math on pre-activations z.  Returns (c', h')."""
    i, j, f, o = torch.chunk(z, 4, dim=-1)
    new_c = c * torch.sigmoid(f + forget_bias) \
        + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return new_c, new_h


def lstm_cell(params: Dict[str, torch.Tensor], x: torch.Tensor,
              state: LSTMState, forget_bias: float = 1.0,
              ) -> Tuple[torch.Tensor, LSTMState]:
    """One LSTM step. x: [..., I]; state: ([..., H], [..., H])."""
    c, h = state
    z = torch.cat([x, h], dim=-1) @ params["kernel"] + params["bias"]
    new_c, new_h = _apply_gates(z, c, forget_bias)
    return new_h, (new_c, new_h)


def reverse_sequence(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """tf.reverse_sequence along dim 1: reverse only the first `lens[b]`
    entries of each row; padding stays in place."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]  # [1, T]
    lens = lens.to(torch.long)[:, None]
    idx = torch.where(t < lens, lens - 1 - t, t)  # [B, T]
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def bidirectional_encoder(fw_params: Dict[str, torch.Tensor],
                          bw_params: Dict[str, torch.Tensor],
                          inputs: torch.Tensor, lens: torch.Tensor,
                          mask: torch.Tensor, forget_bias: float = 1.0,
                          ) -> Tuple[torch.Tensor, LSTMState, LSTMState]:
    """bidirectional_dynamic_rnn parity (model.py:76-94).

    inputs [B, T, I]; lens [B]; mask [B, T].  Returns (outputs [B, T, 2H]
    fw||bw, fw_state, bw_state), in the inputs' dtype: the weights are
    cast to it, so bf16 inputs run the whole recurrence in bf16, as the
    JAX package's does."""
    B, T, I = inputs.shape
    H = fw_params["kernel"].shape[1] // 4
    rev_inputs = reverse_sequence(inputs, lens)
    inputs2 = torch.stack([inputs, rev_inputs])  # [2, B, T, I]
    kernel2 = torch.stack([fw_params["kernel"], bw_params["kernel"]]
                          ).to(inputs.dtype)
    bias2 = torch.stack([fw_params["bias"], bw_params["bias"]]
                        ).to(inputs.dtype)  # [2, 4H]
    k_x2, k_h2 = kernel2[:, :I], kernel2[:, I:]  # [2, I, 4H], [2, H, 4H]
    # input half hoisted out of the recurrence, both directions at once
    x_proj2 = torch.einsum("dbti,dif->dbtf", inputs2, k_x2) \
        + bias2[:, None, None, :]  # [2, B, T, 4H]
    m_all = (mask > 0)[None, :, :, None]  # [1, B, T, 1]
    c = inputs.new_zeros((2, B, H))
    h = inputs.new_zeros((2, B, H))
    outs = []
    for t in range(T):
        m = m_all[:, :, t]  # [1, B, 1]
        z = x_proj2[:, :, t] + torch.bmm(h, k_h2)
        new_c, new_h = _apply_gates(z, c, forget_bias)
        c = torch.where(m, new_c, c)
        h = torch.where(m, new_h, h)
        outs.append(new_h * m.to(new_h.dtype))
    out = torch.stack(outs, dim=2)  # [2, B, T, H]
    fw_out = out[0]
    bw_out = reverse_sequence(out[1], lens)
    return (torch.cat([fw_out, bw_out], dim=-1), (c[0], h[0]), (c[1], h[1]))
