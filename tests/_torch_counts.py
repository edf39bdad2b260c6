"""The reference's FLOP counts, split into products and the rest, for the
port's counter tests.

``split_count`` walks a jaxpr with the rules of
``repro.launch.flopcount.count_jaxpr`` and returns (dot FLOPs, other
FLOPs); their sum is what the reference's ``count_fn`` counts (the tests
hold it so).  ``ref_step`` builds the reference's step of one (arch,
input shape) as its dry-run does, without a mesh, and counts it.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.launch import flopcount as jfc

_CALLS = ("pjit", "closed_call", "core_call", "custom_jvp_call",
          "custom_vjp_call", "custom_vjp_call_jaxpr", "remat", "remat2",
          "checkpoint", "custom_lin")


def split_jaxpr(jaxpr):
    """(dot, other) FLOPs of one jaxpr body, by the reference's rules."""
    dot = other = 0.0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim in _CALLS:
            for k in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                if k in eqn.params:
                    inner = eqn.params[k]
                    d, o = split_jaxpr(getattr(inner, "jaxpr", inner))
                    dot, other = dot + d, other + o
                    break
            continue
        if prim in ("scan", "while"):
            body = eqn.params["jaxpr" if prim == "scan" else "body_jaxpr"]
            n = eqn.params["length"] if prim == "scan" else 1
            d, o = split_jaxpr(body.jaxpr)
            dot, other = dot + n * d, other + n * o
            continue
        if prim == "cond":
            d, o = max((split_jaxpr(br.jaxpr) for br in
                        eqn.params["branches"]), key=sum)
            dot, other = dot + d, other + o
            continue
        out_elems = sum(jfc._numel(v.aval) for v in eqn.outvars)
        if prim == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval
            k = int(np.prod([lhs.shape[i] for i in lc], dtype=np.int64)) or 1
            dot += 2.0 * out_elems * k
        elif prim not in jfc._FREE:
            other += out_elems
    return dot, other


def split_count(fn, *args):
    """(dot, other) of ``fn`` at abstract ``args``."""
    return split_jaxpr(jax.make_jaxpr(fn)(*args).jaxpr)


def sds(shape, dtype=jnp.bfloat16):
    return jax.ShapeDtypeStruct(tuple(shape), dtype)


def ref_config(arch, **sets):
    """The reference's config of ``arch``; MoE archs under the gather
    dispatch (the port's one dispatch), plus ``sets``."""
    from repro.configs import get_config
    cfg = get_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch="gather"))
    return dataclasses.replace(cfg, **sets) if sets else cfg


def ref_step(cfg, shape_name):
    """(dot, other, total, bytes) of the reference's step of one input
    shape at full size, as its dry-run builds it (no mesh)."""
    from repro.configs import INPUT_SHAPES
    from repro.launch import specs, steps
    from repro.optim.optimizers import make_optimizer
    kind = INPUT_SHAPES[shape_name]["kind"]
    p = specs.params_specs(cfg)
    sp = specs.input_specs(cfg, shape_name)
    if kind == "train":
        init, _ = make_optimizer(cfg.optimizer)
        args = (steps.make_train_step(cfg), p, jax.eval_shape(init, p),
                sp["batch"])
    elif kind == "prefill":
        args = (steps.make_prefill_step(cfg), p, sp["batch"])
    else:
        args = (steps.make_serve_step(cfg), p, sp["tokens"], sp["cache"],
                sp["pos"], sp["extras"])
    dot, other = split_count(*args)
    total, nbytes = jfc.count_fn(*args)
    return dot, other, total, nbytes


def cut_depth(cfg):
    """``cfg`` cut to its dense prefix and two periods of its block
    pattern, and to at most 2 microbatches (the counts per layer and per
    microbatch do not depend on how many there are)."""
    first = cfg.moe.first_k_dense if cfg.moe is not None else 0
    n = first + 2 * len(cfg.block_pattern)
    return dataclasses.replace(cfg, num_layers=min(cfg.num_layers, n),
                               grad_accum=min(cfg.grad_accum, 2))


def _rematted(cfg):
    """Per layer, whether a training step rematerialises it: the body's
    whole periods under ``cfg.remat``, never the prefix or a partial
    last period (both packages)."""
    prefix, (pattern, periods), _ = cfg.scan_segments
    end = len(prefix) + len(pattern) * periods
    return [bool(cfg.remat) and len(prefix) <= i < end
            for i in range(len(cfg.layer_kinds))]


def attention_sites(cfg, b, s):
    """(layer, (b, sq, sk, h, kvh, hd, causal, window)) of every flash call
    of one forward of ``b`` rows of ``s`` tokens (self attention per
    attention layer, cross attention per ``xattn`` layer)."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out = []
    for i, kind in enumerate(cfg.layer_kinds):
        if kind in ("attn", "attn_moe", "xattn", "local_attn"):
            window = cfg.rglru.local_window if kind == "local_attn" \
                else cfg.sliding_window
            out.append((i, (b, s, s, h, kvh, hd, True, window)))
        if kind == "xattn":
            out.append((i, (b, s, cfg.cond_len, h, kvh, hd, False, 0)))
    return out


def train_dot_corrections(cfg, batch, seq):
    """port dot − reference dot of a training step, named and computed
    from the shapes (per microbatch of batch/A rows, times A):

    * attention: the port runs the flash forward (again in a
      rematerialised layer) and its backward's seven products
      (``flash_attention._bwd_cost``); the reference's autodiff of its twin
      runs the twin's forward once, again in a rematerialised layer, once
      more for ``blockwise_attention`` (its query blocks are checkpointed),
      and two products per forward product;
    * selective scan: the same for y = <h, C>; the port's backward forms
      g_C once;
    * MoE combine: in a rematerialised layer the reference's recompute
      drops the product that weights the experts' outputs by the gates
      (2·G·gs·k·d; no gradient needs its output, and the jaxpr's remat is
      dead-code eliminated), the port's checkpoint recomputes the period
      up to its last saved tensor, that product included;
    * loss: the reference forms the label logit as a contraction with the
      one-hot labels, and its transpose in the backward (2·b·s·V each);
      the port gathers it.
    """
    from repro_torch.kernels.flash_attention import attention_cost
    from repro_torch.kernels.selective_scan import CHUNK
    A = cfg.grad_accum
    b = batch // A
    remat = _rematted(cfg)
    corr = 0.0
    for i, (bb, sq, sk, h, kvh, hd, causal, window) in attention_sites(
            cfg, b, seq):
        fwd = attention_cost(bb, sq, sk, h, kvh, hd, causal, window,
                             cfg.attn_causal_skip)[0]
        inner = 1 if causal and sq > 2048 else 0
        port = fwd * (1 + remat[i]) + 14.0 * bb * h * sq * sk * hd
        corr += port - fwd * (3 + remat[i] + inner)
    for i, kind in enumerate(cfg.layer_kinds):
        if kind == "mamba":
            d_in, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
            s_pad = -(-seq // CHUNK) * CHUNK
            fwd = 2.0 * b * s_pad * d_in * n
            port = fwd * (1 + remat[i]) + 2.0 * b * seq * d_in * n
            corr += port - fwd * (3 + remat[i])
        if kind == "attn_moe" and remat[i]:
            tokens = b * seq
            gs = min(cfg.moe.group_size, tokens)
            groups = -(-tokens // gs)
            corr += 2.0 * groups * gs * cfg.moe.top_k * cfg.d_model
    corr -= 4.0 * b * seq * cfg.vocab_size * (cfg.num_codebooks or 1)
    return A * corr


def prefill_dot_corrections(cfg, batch, seq):
    """port dot − reference dot of a prefill: the reference's forward also
    computes the MoE load-balance loss (its router product, 2·S·d·E per
    MoE layer), which prefill drops; the port's prefill skips it."""
    n_moe = sum(k == "attn_moe" for k in cfg.layer_kinds)
    if not n_moe:
        return 0.0
    return -n_moe * 2.0 * batch * seq * cfg.d_model * cfg.moe.num_experts


def decode_corrections(cfg, batch, ctx):
    """(dot, other) of port − reference for a decode step: the reference's
    conv step is a contraction over the k taps (2·b·k·width per Mamba or
    RG-LRU layer), the port's shifted multiply-adds are elementwise; the
    reference writes the ring slot as a select over the whole cache (2 ·
    b·W·kvh·hd per attention layer), the port writes one slot in place."""
    from repro_torch.models.model import block_window
    dot = other = 0.0
    for kind in cfg.layer_kinds:
        if kind == "mamba":
            dot -= 2.0 * batch * cfg.ssm.conv_kernel * cfg.ssm.expand \
                * cfg.d_model
        elif kind == "rglru":
            dot -= 2.0 * batch * cfg.rglru.conv_kernel * (
                cfg.rglru.lru_width or cfg.d_model)
        else:
            w = block_window(kind, cfg) or (
                cfg.long_context_window if ctx > 65536 else ctx)
            w = min(w, ctx)
            other -= 2.0 * batch * w * cfg.num_kv_heads \
                * cfg.resolved_head_dim
    return dot, other
