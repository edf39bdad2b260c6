"""Shared neural building blocks: norm, MLP, position embeddings, init.

The port of ``repro.models.layers``.
Weights keep the reference's layouts (``w_up``/``w_gate`` (d, d_ff),
``w_down`` (d_ff, d)); numerics follow it where it fixes them: the norm
computes in float32 and multiplies by ``1 + weight``, rope and M-RoPE
angles are float32 and the rotation runs in float32 before casting back.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.dist import constrained, seq_gathered

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def dense_init(generator, shape, dtype, fan_in=None, device=None):
    """Normal(0, 1) × 1/√fan_in drawn in float32 from ``generator`` (on
    the generator's device), cast to ``dtype`` and moved to ``device``;
    ``fan_in`` defaults to ``shape[0]`` as in the reference.  On the meta
    device nothing is drawn or allocated: the leaf's shape and dtype."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(1, fan_in))
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return w.to(device=device, dtype=dtype)


def rmsnorm(x, weight, eps=1e-6):
    """RMS norm over the last dim in float32, times ``1 + weight``.  On a
    mesh its output is gathered along the sequence (``seq_gathered``):
    every sub-layer and the head read the residual through it, as
    sequence parallelism all-gathers after the norm."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return seq_gathered((x * (1.0 + weight.float())).to(dt))


def softplus(x):
    """``jax.nn.softplus``, as it computes it: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _relu2(x):
    return torch.square(F.relu(x))


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name in ("gelu", "gelu_plain"):
        return _gelu
    if name == "relu2":  # nemotron squared-ReLU
        return _relu2
    raise ValueError(name)


# ----------------------------------------------------------------- MLP

def mlp_init(generator, d_model, d_ff, cfg, dtype, device=None):
    p = {"w_up": dense_init(generator, (d_model, d_ff), dtype, device=device),
         "w_down": dense_init(generator, (d_ff, d_model), dtype, fan_in=d_ff,
                              device=device)}
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(generator, (d_model, d_ff), dtype,
                                 device=device)
    return p


def mlp_apply(p, x, cfg, constrain=None):
    act = activation_fn(cfg.activation)
    up = x @ p["w_up"]
    if cfg.mlp_gated:
        h = act(x @ p["w_gate"]) * up
    else:
        h = act(up)
    return constrained(constrain, h, "ffn_hidden") @ p["w_down"]


# ---------------------------------------------------------------- RoPE

def rope_angles(positions, dim, theta):
    """positions (...,) -> float32 cos/sin of shape (..., dim//2)."""
    freqs = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                    device=positions.device) / dim)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta=10000.0, fraction=1.0):
    """x (b, s, h, hd); positions (b, s).  Rotates the leading
    ``fraction`` of hd in interleaved pairs (x[..., ::2], x[..., 1::2]),
    the reference's convention, not the half-split one."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    cos, sin = rope_angles(positions, rot, theta)           # (b, s, rot/2)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = xr[..., ::2].float(), xr[..., 1::2].float()
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([y, xp], dim=-1) if rot < hd else y


def apply_mrope(x, positions3, sections, theta=10000.0):
    """Qwen2-VL's multimodal rope.  x (b, s, h, hd); positions3 (b, 3, s)
    the (temporal, height, width) ids.  ``sections`` gives how many of the
    hd/2 interleaved (cos, sin) pairs each of the three position streams
    takes, in order; sum(sections) == hd // 2.  Rotates in float32, as
    ``apply_rope``."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"hd/2 = {hd // 2}")
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)      # (hd/2,)
    ang_all = positions3[..., None].float() * freqs           # (b,3,s,hd/2)
    parts, off = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[:, i, :, off:off + sec])
        off += sec
    ang = torch.cat(parts, dim=-1)                              # (b,s,hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def sinusoidal_embedding(positions, dim, max_scale=10000.0):
    """positions (b, s) -> float32 (b, s, dim): sines of the first half,
    cosines of the second, at frequencies max_scale^(-i / (dim/2))."""
    half = dim // 2
    freqs = max_scale ** (-torch.arange(half, dtype=torch.float32,
                                        device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------------------------------------ causal conv1d

def causal_conv1d(x, weight, bias):
    """Depthwise causal conv.  x (b, s, d); weight (k, d); bias (d).
    Written as the reference writes it, k shifted multiply-adds in the
    input's dtype (not ``F.conv1d``, which cuDNN may run in TF32)."""
    k = weight.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * weight[i] for i in range(k))
    return out + bias


def conv_tail(x, k):
    """The conv's decode state after a prefill: the last k-1 inputs of x
    (b, s, d), zero-padded at the front when s < k-1."""
    tail = x[:, -(k - 1):, :]
    if tail.shape[1] < k - 1:
        tail = F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))
    return tail


def causal_conv1d_step(x_t, conv_state, weight, bias):
    """One decode step of ``causal_conv1d``.  x_t (b, d); conv_state
    (b, k-1, d) the past inputs, oldest first.  Returns (out (b, d), the
    new state).  The reference's einsum over the k taps: products summed
    in float32 and rounded once to the input's dtype, as a dot product
    is."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (b, k, d)
    out = sum(window[:, i].float() * weight[i].float()
              for i in range(weight.shape[0]))
    return out.to(x_t.dtype) + bias, window[:, 1:]
