"""Fused RNN operator (modes ``rnn_relu``, ``rnn_tanh``, ``lstm``,
``gru``).

Counterpart of ``mxnet_tpu/ops/rnn.py``, with the same parameter packing
(for each layer, for each direction: W [G*H, I_l] then U [G*H, H]; after
all weight blocks, for each layer and direction: b_W [G*H] then b_U
[G*H]), the same gate order (LSTM i, f, g, o; GRU r, z, n) and the same
inputs and outputs: data [T, B, I] (time-major), parameters (packed
1-D), state [L*D, B, H], state_cell [L*D, B, H] (lstm only) → output
[T, B, H*D] (+ state_output, statecell_output with ``state_outputs``).

The input projection of the whole sequence, with both biases folded in,
is one ``torch.matmul`` outside any kernel.  A float32 LSTM runs its
recurrence on the CUDA kernel ``lstm_scan`` (``ops/cuda_kernels.py``)
inside ``_LSTMScanFn``, whose backward rematerializes through the plain
recurrence, as the JAX package's ``_lstm_bwd_rule`` does; the reverse
direction flips the projection outside the kernel.  Every other mode or
dtype runs the plain step-by-step recurrence, as the JAX package runs
``lax.scan`` there.

Dropout between layers (``p > 0``, training only) drops each layer's
output but the last's with ``nn.dropout``, outside the recurrence: in a
graph layer ``l``'s mask comes from a generator seeded with
``random.sub_key(node_key, l)`` (the JAX op's ``fold_in(key, l)``;
``OpContext.sub_generator``); an eager call draws the layers' masks
from its generator in turn.
"""

from __future__ import annotations

import torch

from ..base import MXNetError, attr_bool, attr_float, attr_int
from . import cuda_kernels as ck
from . import nn
from .registry import register

__all__ = ["rnn_param_size"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers: int, input_size: int, state_size: int,
                   bidirectional: bool, mode: str) -> int:
    """Packed parameter count, ``H*(H+I+2)*G`` per layer and direction."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    size = h * (h + input_size + 2) * g
    if num_layers > 1:
        size += (num_layers - 1) * h * (h + d * h + 2) * g
    return size * d


def _unpack_params(params, num_layers, input_size, h, d, g):
    """Split the flat parameter vector into ``[layer][dir] = [W, U, bW,
    bU]`` views."""
    weights = []
    off = 0
    for layer in range(num_layers):
        i_l = input_size if layer == 0 else h * d
        per_dir = []
        for _ in range(d):
            w = params[off:off + g * h * i_l].reshape(g * h, i_l)
            off += g * h * i_l
            u = params[off:off + g * h * h].reshape(g * h, h)
            off += g * h * h
            per_dir.append([w, u])
        weights.append(per_dir)
    for layer in range(num_layers):
        for dd in range(d):
            bw = params[off:off + g * h]
            off += g * h
            bu = params[off:off + g * h]
            off += g * h
            weights[layer][dd].extend([bw, bu])
    return weights


def _cell_step(mode, h_size):
    """fn(carry, pre) -> (carry, out_h) for the modes whose recurrent
    projection enters the pre-activation whole (all but GRU)."""
    if mode == "rnn_relu":
        def step(carry, pre):
            h = torch.relu(pre)
            return (h,), h
    elif mode == "rnn_tanh":
        def step(carry, pre):
            h = torch.tanh(pre)
            return (h,), h
    elif mode == "lstm":
        def step(carry, pre):
            _, c_prev = carry
            i, f, gte, o = torch.split(pre, h_size, dim=-1)
            i = torch.sigmoid(i)
            f = torch.sigmoid(f)
            gte = torch.tanh(gte)
            o = torch.sigmoid(o)
            c = f * c_prev + i * gte
            h = o * torch.tanh(c)
            return (h, c), h
    else:
        raise MXNetError(f"unhandled rnn cell mode {mode}")
    return step


def _scan(step, carry, xs, reverse):
    """``lax.scan`` over axis 0 as a loop: (final carry, stacked outputs
    in the order of ``xs``)."""
    ys = [None] * xs.shape[0]
    order = range(xs.shape[0] - 1, -1, -1) if reverse \
        else range(xs.shape[0])
    for t in order:
        carry, ys[t] = step(carry, xs[t])
    return carry, torch.stack(ys)


class _LSTMScanFn(torch.autograd.Function):
    """The LSTM recurrence on ``cuda_kernels.lstm_scan``; the backward
    reruns the plain recurrence on the saved inputs under autograd
    (remat: the forward keeps no activations)."""

    @staticmethod
    def forward(ctx, xw, h0, c0, ut):
        ctx.save_for_backward(xw, h0, c0, ut)
        return ck.lstm_scan(xw, h0, c0, ut)

    @staticmethod
    def backward(ctx, gy, ghT, gcT):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ck.lstm_scan_plain(*inputs)
            return torch.autograd.grad(outs, inputs, (gy, ghT, gcT))


def _scan_direction(x, h0, c0, w, u, bw, bu, mode, reverse):
    """One (layer, direction).  x [T, B, I] → (y [T, B, H], hT, cT)."""
    if mode == "gru":
        # the reset gate multiplies the candidate's recurrent projection,
        # so U stays inside the step: n = tanh(W_n x + b_Wn + r*(U_n h + b_Un))
        xw = torch.matmul(x, w.t()) + bw
        u_r, u_z, u_n = torch.chunk(u, 3, dim=0)
        b_r, b_z, b_n = torch.chunk(bu, 3)

        def gru_step(carry, x_t):
            (h_prev,) = carry
            x_r, x_z, x_n = torch.chunk(x_t, 3, dim=-1)
            r = torch.sigmoid(x_r + h_prev @ u_r.t() + b_r)
            z = torch.sigmoid(x_z + h_prev @ u_z.t() + b_z)
            n = torch.tanh(x_n + r * (h_prev @ u_n.t() + b_n))
            h_new = (1 - z) * n + z * h_prev
            return (h_new,), h_new

        (hT,), y = _scan(gru_step, (h0,), xw, reverse)
        return y, hT, None

    xw = torch.matmul(x, w.t()) + bw + bu
    if mode == "lstm" and xw.dtype == torch.float32:
        xw_d = torch.flip(xw, (0,)) if reverse else xw
        y, hT, cT = _LSTMScanFn.apply(xw_d.contiguous(), h0.contiguous(),
                                      c0.contiguous(), u.t().contiguous())
        if reverse:
            y = torch.flip(y, (0,))
        return y, hT, cT

    cell = _cell_step(mode, h0.shape[-1])

    def step(carry, x_t):
        return cell(carry, x_t + carry[0] @ u.t())

    carry0 = (h0, c0) if mode == "lstm" else (h0,)
    carry, y = _scan(step, carry0, xw, reverse)
    return y, carry[0], carry[1] if mode == "lstm" else None


def _rnn_forward(data, params, state, state_cell, attrs, op_ctx):
    h = attr_int(attrs["state_size"])
    num_layers = attr_int(attrs["num_layers"])
    bidirectional = attr_bool(attrs.get("bidirectional"), False)
    mode = attrs["mode"]
    p_drop = attr_float(attrs.get("p", 0.0), 0.0)
    d = 2 if bidirectional else 1
    g = _GATES[mode]
    t, b, input_size = data.shape

    weights = _unpack_params(params, num_layers, input_size, h, d, g)
    state = state.reshape(num_layers, d, b, h)
    cell = state_cell.reshape(num_layers, d, b, h) \
        if state_cell is not None else None

    x = data
    h_finals, c_finals = [], []
    for layer in range(num_layers):
        ys = []
        for dd in range(d):
            w, u, bw, bu = weights[layer][dd]
            y, hT, cT = _scan_direction(
                x, state[layer, dd],
                cell[layer, dd] if cell is not None else None,
                w, u, bw, bu, mode, reverse=(dd == 1))
            ys.append(y)
            h_finals.append(hT)
            if cT is not None:
                c_finals.append(cT)
        x = ys[0] if d == 1 else torch.cat(ys, dim=-1)
        if p_drop > 0.0 and op_ctx.is_train and layer < num_layers - 1:
            g = op_ctx.sub_generator(layer, x.device)
            x = nn.dropout(x, p_drop, g)

    h_out = torch.stack(h_finals).reshape(num_layers * d, b, h)
    c_out = torch.stack(c_finals).reshape(num_layers * d, b, h) \
        if c_finals else None
    return x, h_out, c_out


def _rnn_args(attrs):
    if attrs.get("mode") == "lstm":
        return ["data", "parameters", "state", "state_cell"]
    return ["data", "parameters", "state"]


def _rnn_outs(attrs):
    outs = ["output"]
    if attr_bool(attrs.get("state_outputs"), False):
        outs.append("state_output")
        if attrs.get("mode") == "lstm":
            outs.append("statecell_output")
    return outs


def _rnn_infer(attrs, in_shapes):
    h = attr_int(attrs["state_size"])
    num_layers = attr_int(attrs["num_layers"])
    bidirectional = attr_bool(attrs.get("bidirectional"), False)
    mode = attrs["mode"]
    d = 2 if bidirectional else 1
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None] * len(_rnn_outs(attrs)), []
    if len(data) != 3:
        raise MXNetError(f"RNN data must be [seq_len, batch, input]; got "
                         f"{data}")
    t, b, i = data
    state_shape = (num_layers * d, b, h)
    in_out = [tuple(data),
              (rnn_param_size(num_layers, i, h, bidirectional, mode),),
              state_shape]
    if mode == "lstm":
        in_out.append(state_shape)
    outs = [(t, b, h * d)]
    if attr_bool(attrs.get("state_outputs"), False):
        outs.append(state_shape)
        if mode == "lstm":
            outs.append(state_shape)
    return in_out, outs, []


@register("RNN", arg_names=_rnn_args, out_names=_rnn_outs, needs_rng=True,
          infer_shape=_rnn_infer,
          kernel=lambda attrs: str(attrs.get("mode", "")) == "lstm",
          doc="Fused multi-layer (bi)directional RNN/LSTM/GRU; the fp32 "
              "LSTM recurrence runs on the lstm_scan kernel")
def _rnn(op_ctx, attrs, inputs, aux):
    mode = attrs.get("mode")
    if mode not in _GATES:
        raise MXNetError(f"RNN mode {mode!r} not in {sorted(_GATES)}")
    state_cell = inputs[3] if mode == "lstm" else None
    out, h_out, c_out = _rnn_forward(inputs[0], inputs[1], inputs[2],
                                     state_cell, attrs, op_ctx)
    outs = [out]
    if attr_bool(attrs.get("state_outputs"), False):
        outs.append(h_out)
        if mode == "lstm":
            outs.append(c_out)
    return outs
