"""Mamba-1 selective-state-space block (the falcon-mamba-7b family).

The port of ``repro.models.ssm``'s full-sequence path.  Weights keep the
reference's layouts (``in_proj`` (d, 2·d_in), ``conv_w`` (k, d_in),
``x_proj`` (d_in, dt_rank + 2n), ``dt_proj`` (dt_rank, d_in), ``out_proj``
(d_in, d)); ``A_log`` and ``D`` are float32 whatever ``param_dtype``
says.  The scan is ``repro_torch.kernels.selective_scan`` (the CUDA kernel
on the card, its eager twin on the CPU), in place of the reference's
chunked associative scan, which computes the same function.  The prefill
that also returns the decode cache takes the scan's final state from the
same kernel; one-token decode is the recurrence's single step in eager
PyTorch, as the reference writes it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.dist import constrained
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_step,
                                       conv_tail, dense_init, softplus)


def mamba_init(generator, cfg, dtype, device=None):
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    dt_rank = cfg.dt_rank
    A = torch.arange(1, s.state_dim + 1, dtype=torch.float32).repeat(d_in, 1)
    # the reference draws dt_bias from numpy's RandomState(0), whatever key
    dt_bias = np.log(np.expm1(np.clip(np.random.RandomState(0).uniform(
        1e-3, 1e-1, d_in), 1e-4, None)))
    return {
        "in_proj": dense_init(generator, (d, 2 * d_in), dtype, device=device),
        "conv_w": dense_init(generator, (s.conv_kernel, d_in), dtype,
                             fan_in=s.conv_kernel, device=device),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "x_proj": dense_init(generator, (d_in, dt_rank + 2 * s.state_dim),
                             dtype, device=device),
        "dt_proj": dense_init(generator, (dt_rank, d_in), dtype,
                              fan_in=dt_rank, device=device),
        "dt_bias": torch.from_numpy(dt_bias).to(device=device, dtype=dtype),
        "A_log": torch.log(A).to(device),
        "D": torch.ones((d_in,), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, (d_in, d), dtype, fan_in=d_in,
                               device=device),
    }


def _ssm_inputs(p, xc, cfg):
    """xc (b, s, d_in) post-conv activations -> (dA, dBx, C) scan inputs:
    float32, or bfloat16 under ``cfg.ssm_scan_bf16`` (the scan still
    combines in float32)."""
    s = cfg.ssm
    dt_rank = cfg.dt_rank
    proj = xc @ p["x_proj"]
    dt, B, C = torch.split(proj, [dt_rank, s.state_dim, s.state_dim], dim=-1)
    dt = softplus((dt @ p["dt_proj"]).float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"])                               # (d_in, n)
    dA = (dt[..., None] * A).exp_()                          # (b,s,d_in,n)
    dBx = (dt * xc.float())[..., None] * B.float()[:, :, None, :]
    if getattr(cfg, "ssm_scan_bf16", False):
        return (dA.to(torch.bfloat16), dBx.to(torch.bfloat16),
                C.to(torch.bfloat16))
    return dA, dBx, C.float()


def mamba_apply(p, x, cfg, constrain=None):
    """Full-sequence mamba block.  x (b, s, d) -> (b, s, d)."""
    d_in = cfg.ssm.expand * cfg.d_model
    xz = x @ p["in_proj"]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    xc = constrained(constrain,
                     F.silu(causal_conv1d(xi, p["conv_w"], p["conv_b"])),
                     "ssm_inner")
    dA, dBx, C = _ssm_inputs(p, xc, cfg)
    y = selective_scan(dA, dBx, C)
    del dA, dBx
    y = y + xc.float() * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"]


def mamba_prefill(p, x, cfg, constrain=None):
    """Full-sequence forward that also returns the decode cache
    ``{"h": the scan's final state (b, d_in, n) float32, "conv": the last
    k-1 conv inputs (b, k-1, d_in)}``."""
    d_in = cfg.ssm.expand * cfg.d_model
    xz = x @ p["in_proj"]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    xc = constrained(constrain,
                     F.silu(causal_conv1d(xi, p["conv_w"], p["conv_b"])),
                     "ssm_inner")
    dA, dBx, C = _ssm_inputs(p, xc, cfg)
    y, h_final = selective_scan(dA, dBx, C, final_state=True)
    del dA, dBx
    y = y + xc.float() * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    cache = {"h": h_final,
             "conv": conv_tail(xi, cfg.ssm.conv_kernel).to(x.dtype)}
    return y @ p["out_proj"], cache


def init_mamba_cache(cfg, batch, dtype=torch.float32, device=None):
    """A zero decode cache: the state (batch, d_in, n) float32 and the
    conv inputs (batch, k-1, d_in) in ``dtype``; its size does not depend
    on the context length."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {"h": torch.zeros((batch, d_in, s.state_dim), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, s.conv_kernel - 1, d_in),
                                dtype=dtype, device=device)}


def mamba_decode(p, x, cache, cfg):
    """One-token decode.  x (b, 1, d) -> ((b, 1, d), new cache)."""
    d_in = cfg.ssm.expand * cfg.d_model
    xz = x[:, 0] @ p["in_proj"]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    xc, conv = causal_conv1d_step(xi, cache["conv"], p["conv_w"],
                                  p["conv_b"])
    xc = F.silu(xc)
    dA, dBx, C = _ssm_inputs(p, xc[:, None], cfg)
    h = dA[:, 0].float() * cache["h"] + dBx[:, 0].float()
    y = torch.einsum("bdn,bn->bd", h, C[:, 0].float())
    y = y + xc.float() * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    return (y @ p["out_proj"])[:, None], {"h": h, "conv": conv}
