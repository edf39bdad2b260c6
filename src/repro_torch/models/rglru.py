"""RG-LRU recurrent block (the recurrentgemma-9b hybrid family).

The port of ``repro.models.rglru``'s full-sequence path.  Real-Gated
Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

in Griffin's recurrent-block shape: two input projections (signal and gelu
gate), a short causal conv on the signal branch, block-diagonal gates and
an output projection.  Weights keep the reference's layouts (``in_x`` and
``in_gate`` (d, w), ``conv_w`` (k, w), ``w_a`` and ``w_i`` (gb, w/gb,
w/gb), ``out`` (w, d)); ``b_a``, ``b_i`` and ``Lambda`` are float32
whatever ``param_dtype`` says.  The recurrence is
``repro_torch.kernels.rglru_scan`` (the CUDA kernel on the card, its
eager twin on the CPU), in place of the reference's chunked associative
scan, which computes the same function.  The prefill that also returns
the decode cache takes the final state as the scan's last row; one-token
decode is the recurrence's single step in eager PyTorch, as the
reference writes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.dist import constrained
from repro_torch.models.layers import (activation_fn, causal_conv1d,
                                       causal_conv1d_step, conv_tail,
                                       dense_init, softplus)

_C = 8.0  # temperature of the a_t parameterization (Griffin)


def rglru_init(generator, cfg, dtype, device=None):
    r = cfg.rglru
    d = cfg.d_model
    w = r.lru_width or d
    bw = w // r.gate_blocks

    def f32(value):
        return torch.full((w,), value, dtype=torch.float32, device=device)

    return {
        "in_x": dense_init(generator, (d, w), dtype, device=device),
        "in_gate": dense_init(generator, (d, w), dtype, device=device),
        "conv_w": dense_init(generator, (r.conv_kernel, w), dtype,
                             fan_in=r.conv_kernel, device=device),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        # block-diagonal gates (Griffin §2.4): gb blocks of (w/gb, w/gb)
        "w_a": dense_init(generator, (r.gate_blocks, bw, bw), dtype,
                          fan_in=bw, device=device),
        "b_a": f32(0.0),
        "w_i": dense_init(generator, (r.gate_blocks, bw, bw), dtype,
                          fan_in=bw, device=device),
        "b_i": f32(0.0),
        # Lambda init so that a ~ U(0.9, 0.999) at r=1 (Griffin appendix)
        "Lambda": f32(0.7),
        "out": dense_init(generator, (w, d), dtype, fan_in=w, device=device),
    }


def _block_matmul(x, w_blocks):
    """x (..., w) @ block-diag(w_blocks (gb, w/gb, w/gb)) -> (..., w)."""
    gb, bw, _ = w_blocks.shape
    xb = x.reshape(x.shape[:-1] + (gb, bw))
    return torch.einsum("...gb,gbc->...gc", xb, w_blocks).reshape(x.shape)


def _gates(p, xc):
    """xc (b, s, w) post-conv activations -> (a, gated x), float32."""
    r = torch.sigmoid(_block_matmul(xc, p["w_a"]).float() + p["b_a"])
    i = torch.sigmoid(_block_matmul(xc, p["w_i"]).float() + p["b_i"])
    log_a = -_C * softplus(p["Lambda"]) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via expm1
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    gated_x = beta * (i * xc.float())
    return a, gated_x


def rglru_apply(p, x, cfg, constrain=None):
    """Full-sequence recurrent block.  x (b, s, d) -> (b, s, d)."""
    gelu = activation_fn("gelu")
    xi = x @ p["in_x"]
    gate = gelu(x @ p["in_gate"])
    xc = constrained(constrain, causal_conv1d(xi, p["conv_w"], p["conv_b"]),
                     "rnn_inner")
    a, bx = _gates(p, xc)
    h = rglru_scan(a, bx)
    del a, bx
    y = h.to(x.dtype) * gate
    return y @ p["out"]


def rglru_prefill(p, x, cfg, constrain=None):
    """Full-sequence forward that also returns the decode cache
    ``{"h": the last state (b, w) float32, "conv": the last k-1 conv
    inputs (b, k-1, w)}``."""
    gelu = activation_fn("gelu")
    xi = x @ p["in_x"]
    gate = gelu(x @ p["in_gate"])
    xc = constrained(constrain, causal_conv1d(xi, p["conv_w"], p["conv_b"]),
                     "rnn_inner")
    a, bx = _gates(p, xc)
    h = rglru_scan(a, bx)
    del a, bx
    y = h.to(x.dtype) * gate
    cache = {"h": h[:, -1].clone(),
             "conv": conv_tail(xi, cfg.rglru.conv_kernel).to(x.dtype)}
    return y @ p["out"], cache


def init_rglru_cache(cfg, batch, dtype=torch.float32, device=None):
    """A zero decode cache: the state (batch, w) float32 and the conv
    inputs (batch, k-1, w) in ``dtype``."""
    r = cfg.rglru
    w = r.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, r.conv_kernel - 1, w), dtype=dtype,
                                device=device)}


def rglru_decode(p, x, cache, cfg):
    """One-token decode.  x (b, 1, d) -> ((b, 1, d), new cache)."""
    gelu = activation_fn("gelu")
    xi = x[:, 0] @ p["in_x"]
    gate = gelu(x[:, 0] @ p["in_gate"])
    xc, conv = causal_conv1d_step(xi, cache["conv"], p["conv_w"],
                                  p["conv_b"])
    a, bx = _gates(p, xc)
    h = a * cache["h"] + bx
    y = h.to(x.dtype) * gate
    return (y @ p["out"])[:, None], {"h": h, "conv": conv}
