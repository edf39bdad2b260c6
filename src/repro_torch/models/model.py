"""Decoder model over every block kind of the reference.

The port of ``repro.models.model`` for ``"attn"``, ``"attn_moe"``,
``"mamba"``, ``"rglru"``, ``"local_attn"`` and ``"xattn"`` (self
attention, cross attention to a conditioning sequence, MLP) blocks:
parameters are a dict ``{"embed", "final_norm", "head", "blocks"}`` with
one dict per
layer in ``blocks`` (the reference stacks its body periods along a
leading axis for ``lax.scan``; the port's forward is a plain loop over
layers, and ``params_from_jax`` unstacks that axis).

Public API:
    init_params(cfg, generator, device)            -> params
    params_from_jax(tree, cfg, device)             -> params
    opt_state_from_jax(state, cfg, device)         -> optimizer state
    stack_groups(params, cfg)                      -> Adafactor's groups
    forward(params, batch, cfg[, collect_cache])   -> logits (float32)
                                                      [, cache]
    forward(params, batch, cfg, with_aux=True)     -> (logits, aux)
    loss_fn(params, batch, cfg[, aux_weight])      -> (total, {"ce", "aux"})
    prefill(params, batch, cfg, max_ctx)           -> (logits, cache)
    init_cache(cfg, batch, ctx_len, sliding, device) -> cache
    decode_step(params, tokens, cache, pos, cfg)   -> (logits, cache)
    cache_from_jax(tree, cfg, device)              -> cache

A batch holds ``tokens`` (b, s), or (b, s, cb) under ``num_codebooks``
(musicgen: the cb codebooks' embeddings are summed and the head gives
logits (b, s, cb, vocab)); optionally explicit ``positions`` (b, s)
(offset or packed rows; without them they are ``0..s-1``); under M-RoPE
(qwen2-vl) ``positions3`` (b, 3, s), the (temporal, height, width) ids,
else ``positions`` on all three streams; with a visual front end
``visual_embeds`` (b, s, d) that replace the token embeddings where
``visual_mask`` (b, s) is true; with cross attention ``cond`` (b,
cond_len, d), else zeros; and, for ``loss_fn``, ``labels`` of the
tokens' shape (under codebooks one label per codebook).
``pos_emb="sinusoidal"`` adds ``sinusoidal_embedding`` of the positions
to the embeddings.  Entries a config does not use are ignored, as the
reference ignores them.  With grad enabled and ``cfg.remat`` each
period of the body's block pattern runs under ``torch.utils.checkpoint``
(non-reentrant), as the reference's ``jax.checkpoint`` of each scanned
period; the dense prefix and a partial last period are not
rematerialised, as in the reference.  A
decode cache is a list with one dict per layer, as ``params["blocks"]``:
``{"k", "v"}`` ring buffers for the attention blocks (an ``xattn``
block's cross attention caches nothing: it projects ``cond`` again each
step, as the reference does), ``{"h", "conv"}`` states for the Mamba and
RG-LRU blocks.  ``constrain`` (the reference's ``with_sharding_constraint``
hook; ``launch.sharding.make_constrain`` on a mesh) is the identity
without a mesh, so a call without one computes what it always did.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.dist import constrained
from repro_torch.models.layers import (dense_init, dtype_of, mlp_apply,
                                       mlp_init, rmsnorm,
                                       sinusoidal_embedding)
from repro_torch.optim.optimizers import AdafactorState, AdamWState
from repro_torch.tree import tree_flatten, tree_leaves

#: the block kinds the port runs
PORTED_KINDS = ("attn", "attn_moe", "mamba", "rglru", "local_attn", "xattn")

#: the position schemes the port runs
POS_EMBS = ("rope", "mrope", "sinusoidal", "none")

#: the batch entries the port reads
BATCH_KEYS = ("tokens", "positions", "labels", "positions3",
              "visual_embeds", "visual_mask", "cond")


def check_supported(cfg, batch=None):
    """Raise for a config or batch the port cannot run: block kinds other
    than ``PORTED_KINDS``, position schemes other than ``POS_EMBS``, and
    batch entries other than ``BATCH_KEYS`` (a ValueError each)."""
    for kind in cfg.layer_kinds:
        if kind not in PORTED_KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
    if cfg.pos_emb not in POS_EMBS:
        raise ValueError(f"unknown position scheme {cfg.pos_emb!r}")
    for key in batch or ():
        if key not in BATCH_KEYS:
            raise ValueError(f"unknown batch entry {key!r}; the model reads "
                             f"{BATCH_KEYS}")


# ------------------------------------------------------------ parameters

def init_block(generator, kind, cfg, device=None):
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model

    def norm():
        return torch.zeros((d,), dtype=dtype, device=device)

    if kind == "mamba":
        return {"norm1": norm(),
                "mamba": ssm_mod.mamba_init(generator, cfg, dtype,
                                            device=device)}
    if kind == "rglru":
        return {"norm1": norm(),
                "rglru": rglru_mod.rglru_init(generator, cfg, dtype,
                                              device=device),
                "norm2": norm(),
                "mlp": mlp_init(generator, d, cfg.d_ff, cfg, dtype,
                                device=device)}
    block = {"norm1": norm(),
             "attn": attn.attn_init(generator, cfg, dtype, device=device)}
    if kind == "xattn":
        block["norm_x"] = norm()
        block["xattn"] = attn.attn_init(generator, cfg, dtype, device=device)
    block["norm2"] = norm()
    if kind == "attn_moe":
        block["moe"] = moe_mod.moe_init(generator, cfg, dtype, device=device)
    else:
        block["mlp"] = mlp_init(generator, d, cfg.d_ff, cfg, dtype,
                                device=device)
    return block


def init_params(cfg, generator=None, device="cuda"):
    """Random parameters with the reference's distribution (``dense_init``:
    normal × 1/√fan_in in float32, cast to ``param_dtype``; norms zero;
    the MoE router and shared gate, Mamba's ``A_log`` and ``D`` and the
    RG-LRU's ``b_a``, ``b_i`` and ``Lambda`` stay float32, as the
    reference keeps them),
    drawn from ``generator`` (default: a CPU generator seeded 0) on its
    own device and placed on ``device``.  On ``device="meta"`` nothing is
    drawn or allocated (the leaves' shapes and dtypes, as the reference's
    ``eval_shape`` of its init gives them: ``launch.specs``)."""
    check_supported(cfg)
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dtype = dtype_of(cfg.param_dtype)
    d, v, cb = cfg.d_model, cfg.vocab_size, cfg.num_codebooks
    params = {"embed": dense_init(generator, (cb, v, d) if cb else (v, d),
                                  dtype, fan_in=d, device=dev),
              "final_norm": torch.zeros((d,), dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        # under codebooks the reference's fan-in is shape[0], the codebook
        # count (its init's own choice, kept)
        params["head"] = dense_init(generator, (cb, d, v) if cb else (d, v),
                                    dtype, device=dev)
    params["blocks"] = [init_block(generator, kind, cfg, device=dev)
                        for kind in cfg.layer_kinds]
    return params


def _to_tensors(tree, device):
    """NumPy leaves as tensors of the same dtype (ml_dtypes' bfloat16 goes
    through float32, exactly)."""
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v, device) for v in tree]
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device=device)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, cfg):
    """The reference's (prefix, body periods stacked on a leading axis,
    suffix) layout as one entry per layer, in that order."""
    prefix, (pattern, periods), suffix = cfg.scan_segments
    blocks = list(tree.get("prefix", []))
    for i in range(periods):
        period = _index(tree["body"], i)
        blocks.extend(period[f"b{j}"] for j in range(len(pattern)))
    blocks.extend(tree.get("suffix", []))
    return blocks


def params_from_jax(tree, cfg, device="cuda"):
    """The reference's parameter pytree (``repro.models.init_params``),
    given as NumPy arrays, as the port's parameters on ``device``: the
    body's leading period axis is unstacked into one dict per layer, in
    the order prefix, body periods, suffix.  Each leaf keeps its own
    dtype (the reference keeps the MoE router and shared gate, Mamba's
    ``A_log`` and ``D`` and the RG-LRU's ``b_a``, ``b_i`` and ``Lambda``
    in float32 under a bfloat16 ``param_dtype``)."""
    check_supported(cfg)
    dev = resolve(device)
    params = {k: tree[k] for k in ("embed", "final_norm", "head")
              if k in tree}
    params["blocks"] = _unstack(tree, cfg)
    return _to_tensors(params, dev)


def opt_state_from_jax(state, cfg, device="cuda"):
    """The reference's optimizer state (``AdamWState`` or
    ``AdafactorState`` of ``repro.optim.optimizers``, given with NumPy
    leaves) as the port's on ``device``: AdamW's moments unstacked like
    ``params_from_jax`` into the flat order of the port's parameters
    (``tree_leaves(params)``); Adafactor's statistics kept per reference
    leaf, in the order of ``stack_groups``."""
    dev = resolve(device)
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=dev)
    if hasattr(state, "m"):
        return AdamWState(
            step=step,
            m=tree_leaves(params_from_jax(state.m, cfg, device=dev)),
            v=tree_leaves(params_from_jax(state.v, cfg, device=dev)))
    return AdafactorState(step=step,
                          vr=_to_tensors(tree_leaves(state.vr), dev),
                          vc=_to_tensors(tree_leaves(state.vc), dev))


class _Stacked:
    """The port's flat indices of one stacked reference leaf."""

    def __init__(self):
        self.indices = []


def _parent(tree, path):
    """The dict of ``tree`` that holds ``path``'s last key (made as
    needed)."""
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    return tree


def stack_groups(params, cfg):
    """Adafactor's groups (``optim.optimizers``): for each leaf of the
    reference's parameter tree, in JAX's flattening order, the index of
    the port's flat parameter (``tree_leaves(params)``) that is that leaf,
    or the list of the per-layer indices that its body periods stack."""
    prefix, (pattern, periods), suffix = cfg.scan_segments
    npre, width = len(prefix), len(pattern)
    ref = {"prefix": [{} for _ in prefix], "suffix": [{} for _ in suffix]}
    for idx, (path, _) in enumerate(tree_flatten(params)):
        parts = path.split("/")
        if parts[0] != "blocks":
            ref[parts[0]] = idx
            continue
        li, rest = int(parts[1]), parts[2:]
        if li < npre:
            _parent(ref["prefix"][li], rest)[rest[-1]] = idx
        elif li < npre + periods * width:
            body = ref.setdefault("body", {}).setdefault(
                f"b{(li - npre) % width}", {})
            _parent(body, rest).setdefault(rest[-1], _Stacked()) \
                .indices.append(idx)
        else:
            _parent(ref["suffix"][li - npre - periods * width],
                    rest)[rest[-1]] = idx
    return [leaf.indices if isinstance(leaf, _Stacked) else leaf
            for leaf in tree_leaves(ref)]


def cache_from_jax(tree, cfg, device="cuda"):
    """The reference's decode cache (``repro.models.prefill`` /
    ``init_cache`` / ``decode_step``), given as NumPy arrays, as the
    port's per-layer list on ``device``, each leaf in its own dtype."""
    check_supported(cfg)
    return _to_tensors(_unstack(tree, cfg), resolve(device))


# --------------------------------------------------------------- forward

def positions_of(tokens):
    """The implicit positions ``0..s-1`` of every row, (b, s) int32."""
    b, s = tokens.shape[:2]
    return torch.arange(s, dtype=torch.int32,
                        device=tokens.device).expand(b, s)


def batch_positions(batch):
    """(positions (b, s) int32, explicit): the batch's own ``positions``,
    or the implicit ``0..s-1``."""
    tokens = batch["tokens"]
    pos = batch.get("positions")
    if pos is None:
        return positions_of(tokens), False
    if tuple(pos.shape) != tuple(tokens.shape[:2]):
        raise ValueError(f"positions {tuple(pos.shape)} do not match "
                         f"tokens {tuple(tokens.shape)}")
    return pos.to(device=tokens.device, dtype=torch.int32), True


def embed_tokens(params, batch, cfg, positions):
    """The token embeddings of ``batch["tokens"]`` (under codebooks the
    sum of each codebook's, in codebook order), replaced by
    ``visual_embeds`` where ``visual_mask`` is set (visual front end),
    plus the sinusoidal embedding of ``positions`` (``pos_emb=
    "sinusoidal"``), in the compute dtype."""
    tokens = batch["tokens"].long()
    emb = params["embed"]
    take = _mesh_embedding if hasattr(emb, "placements") \
        else (lambda t, e: e[t])
    if cfg.num_codebooks:
        x = sum(take(tokens[..., i], emb[i])
                for i in range(cfg.num_codebooks))
    else:
        x = take(tokens, emb)
    if cfg.visual_frontend and "visual_embeds" in batch:
        mask = batch["visual_mask"].to(device=x.device, dtype=torch.bool)
        x = torch.where(mask[..., None],
                        batch["visual_embeds"].to(device=x.device,
                                                  dtype=x.dtype), x)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
    return x.to(dtype_of(cfg.compute_dtype))


def _mesh_embedding(tokens, table):
    """Rows of a DTensor ``table`` by ``embedding``, the table's vocabulary
    split gathered first (indexing's gradient, an index_put, and the
    masked lookup of a vocabulary-split table both lack a working DTensor
    rule on some torch releases)."""
    from torch.distributed.tensor import Replicate, Shard
    whole = [Replicate() if p == Shard(0) else p for p in table.placements]
    return torch.nn.functional.embedding(
        tokens, table.redistribute(table.device_mesh, whole))


def make_ctx(batch, cfg):
    """What every block of one call reads beside its input, the
    reference's ``_make_ctx``: ``positions`` (b, s) int32 and whether they
    are ``explicit`` (``batch_positions``); under M-RoPE the batch's
    ``positions3`` (b, 3, s) int32, if it has them (else the attention
    rotates by ``positions`` on all three streams); with cross attention
    ``cond`` (b, cond_len, d) in the compute dtype, the batch's or else
    zeros."""
    positions, explicit = batch_positions(batch)
    ctx = {"positions": positions, "explicit": explicit}
    b, s = positions.shape
    dev = positions.device
    p3 = batch.get("positions3")
    if cfg.pos_emb == "mrope" and p3 is not None:
        if tuple(p3.shape) != (b, 3, s):
            raise ValueError(f"positions3 {tuple(p3.shape)} is not "
                             f"{(b, 3, s)}")
        ctx["positions3"] = p3.to(device=dev, dtype=torch.int32)
    if cfg.cross_attention:
        dt = dtype_of(cfg.compute_dtype)
        cond = batch.get("cond")
        if cond is None:
            cond = torch.zeros((b, cfg.cond_len, cfg.d_model), dtype=dt,
                               device=dev)
        ctx["cond"] = cond.to(device=dev, dtype=dt)
    return ctx


def block_window(kind, cfg):
    """The attention window of a block kind: the hybrid's ``local_attn``
    blocks take the RG-LRU config's local window, the others
    ``cfg.sliding_window`` (0: none)."""
    if kind == "local_attn":
        return cfg.rglru.local_window
    return cfg.sliding_window


def _ring(t, w):
    """The last w entries of t (b, s, ...) along axis 1, rolled so that
    slot j holds the entry of index ≡ j (mod w); zero-padded to w when
    s < w (the reference's ``apply_block`` cache layout)."""
    s = t.shape[1]
    if s >= w:
        return torch.roll(t[:, s - w:], (s - w) % w, dims=1)
    return torch.cat([t, t.new_zeros((t.shape[0], w - s) + t.shape[2:])],
                     dim=1)


def _block(kind, p, x, ctx, cfg, cache_len=None, aux=None, constrain=None):
    """One block; with ``cache_len`` also its decode cache; with ``aux``
    (a list) an ``attn_moe`` block appends its load-balance loss to it;
    ``constrain`` places the residual stream after each sub-layer and the
    sub-layers' inner activations, as the reference.  Returns (x, cache
    or None)."""
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    collect = cache_len is not None
    cache = None

    def add(x, y):
        return _residual_add(constrain, x, y)

    if kind == "mamba":
        xn = rmsnorm(x, p["norm1"], cfg.norm_eps)
        if collect:
            y, cache = ssm_mod.mamba_prefill(p["mamba"], xn, cfg, constrain)
        else:
            y = ssm_mod.mamba_apply(p["mamba"], xn, cfg, constrain)
        return add(x, y), cache
    if kind == "rglru":
        xn = rmsnorm(x, p["norm1"], cfg.norm_eps)
        if collect:
            y, cache = rglru_mod.rglru_prefill(p["rglru"], xn, cfg,
                                               constrain)
        else:
            y = rglru_mod.rglru_apply(p["rglru"], xn, cfg, constrain)
        x = add(x, y)
        return add(x, mlp_apply(p["mlp"], rmsnorm(x, p["norm2"], cfg.norm_eps),
                                cfg, constrain)), cache
    window = block_window(kind, cfg)
    h, (k, v) = attn.self_attention(p["attn"],
                                    rmsnorm(x, p["norm1"], cfg.norm_eps),
                                    ctx["positions"], cfg, window=window,
                                    explicit=ctx["explicit"],
                                    positions3=ctx.get("positions3"))
    if collect:
        w = min(window or cache_len, cache_len)
        dt = dtype_of(cfg.compute_dtype)
        cache = {"k": _ring(k, w).to(dt), "v": _ring(v, w).to(dt)}
    return _after_self_attention(kind, p, add(x, h), ctx, cfg, aux,
                                 constrain, residual=True), cache


def _after_self_attention(kind, p, x, ctx, cfg, aux=None, constrain=None,
                          residual=False):
    """An attention block's sub-layers after its self attention: an
    ``xattn`` block's cross attention, then the MoE FFN or the MLP; with
    ``residual`` the stream is constrained after each (the reference's
    forward; its decode constrains only the FFN's inner activations)."""
    con = constrain if residual else None
    if kind == "xattn":
        x = _residual_add(con, x, attn.cross_attention(
            p["xattn"], rmsnorm(x, p["norm_x"], cfg.norm_eps), ctx["cond"],
            cfg))
    xn = rmsnorm(x, p["norm2"], cfg.norm_eps)
    if kind == "attn_moe":
        if aux is not None:
            aux.append(moe_mod.aux_load_balance_loss(p["moe"], xn, cfg))
        y = moe_mod.moe_apply(p["moe"], xn, cfg, constrain)
    else:
        y = mlp_apply(p["mlp"], xn, cfg, constrain)
    return _residual_add(con, x, y)


def _residual_add(constrain, x, y):
    """x + y, both placed as the residual stream first (on a mesh the
    sub-layer's output is reduce-scattered onto the sequence split by its
    own autograd node, so that its gradient returns in the sub-layer's
    placement)."""
    return constrained(constrain, x + constrained(constrain, y, "residual"),
                       "residual")


def _remat_period(kinds, ps, x, ctx, cfg, constrain=None):
    """One period of the body's block pattern under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward, as the reference checkpoints each scanned
    period.  Returns (x, the load-balance losses of its ``attn_moe``
    blocks, in order)."""
    def run(x):
        aux = []
        for kind, p in zip(kinds, ps):
            x, _ = _block(kind, p, x, ctx, cfg, aux=aux, constrain=constrain)
        return (x, *aux)
    out = checkpoint(run, x, use_reentrant=False)
    return out[0], list(out[1:])


def apply_block(kind, p, x, ctx, cfg):
    """One block, each sub-layer pre-norm with a residual: ``"attn"`` and
    ``"local_attn"`` are self attention then the MLP, ``"xattn"`` self
    attention, cross attention to ``ctx["cond"]``, then the MLP,
    ``"attn_moe"`` self attention then the MoE FFN, ``"mamba"`` the Mamba
    mixer alone, ``"rglru"`` the RG-LRU mixer then the MLP.  ``ctx`` is
    ``make_ctx``'s.  Returns the new residual stream."""
    return _block(kind, p, x, ctx, cfg)[0]


def lm_head(params, x, cfg):
    """Float32 logits (b, s, vocab), or (b, s, cb, vocab) under codebooks
    (one head per codebook)."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].transpose(-1, -2) if cfg.tie_embeddings \
        else params["head"]
    if cfg.num_codebooks:
        if hasattr(x, "placements"):
            # on a mesh one product per codebook: the einsum's (cb, V)
            # flatten has no layout when V is split and cb is not
            return torch.stack([x @ w[c] for c in range(w.shape[0])],
                               dim=2).float()
        return torch.einsum("bsd,cdv->bscv", x, w).float()
    return (x @ w).float()


def _needs_grad(p):
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tree_leaves(p))


def forward(params, batch, cfg, collect_cache=False, max_ctx=None,
            with_aux=False, constrain=None):
    """Full-sequence forward of ``batch["tokens"]`` (b, s) or (b, s, cb),
    with the batch's other entries (``make_ctx``); returns float32 logits
    (b, s, vocab) or (b, s, cb, vocab),
    and with ``collect_cache`` also the decode cache of ``max_ctx``
    (default s) slots per attention layer, each attention layer keeping
    ``min(its window or max_ctx, max_ctx)`` of them.  With ``with_aux`` it
    returns (logits, aux): aux the () float32 sum of every ``attn_moe``
    block's load-balance loss (the reference's ``forward`` returns it
    beside the logits).  ``constrain`` (``launch.sharding.make_constrain``
    on a mesh) places the activations at the reference's points; without
    it nothing changes."""
    check_supported(cfg, batch)
    if collect_cache and with_aux:
        raise ValueError("forward: with_aux and collect_cache together")
    tokens = batch["tokens"]
    ctx = make_ctx(batch, cfg)
    cache_len = (max_ctx or tokens.shape[1]) if collect_cache else None
    x = constrained(constrain,
                    embed_tokens(params, batch, cfg, ctx["positions"]),
                    "residual")
    cache, aux = [], []
    kinds, blocks = cfg.layer_kinds, params["blocks"]
    prefix, (pattern, periods), _ = cfg.scan_segments
    body_end = len(prefix) + len(pattern) * periods
    i = 0
    while i < len(kinds):
        period = slice(i, i + len(pattern))
        if (cfg.remat and not collect_cache and len(prefix) <= i < body_end
                and _needs_grad(blocks[period])):
            x, a = _remat_period(kinds[period], blocks[period], x, ctx, cfg,
                                 constrain)
            if with_aux:
                aux.extend(a)
            i += len(pattern)
            continue
        x, c = _block(kinds[i], blocks[i], x, ctx, cfg, cache_len,
                      aux=aux if with_aux else None, constrain=constrain)
        cache.append(c)
        i += 1
    logits = lm_head(params, x, cfg)
    if with_aux:
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        for a in aux:
            total = total + a
        return logits, total
    return (logits, cache) if collect_cache else logits


def loss_fn(params, batch, cfg, aux_weight=0.01, constrain=None):
    """Next-token cross entropy of ``batch["labels"]`` (b, s), or (b, s,
    cb) under codebooks (one cross entropy per codebook): the float32
    logsumexp of the logits minus the label's logit, averaged over every
    label, plus ``aux_weight`` times the MoE load-balance loss.  Returns
    (total, {"ce": the mean cross entropy, "aux": the aux loss}).
    ``constrain`` as in ``forward``; the logits are constrained as the
    reference's ``"logits"``."""
    labels = batch["labels"]
    want = tuple(batch["tokens"].shape)
    if tuple(labels.shape) != want:
        raise ValueError(f"labels {tuple(labels.shape)} do not match tokens "
                         f"{want}")
    logits, aux = forward(params, batch, cfg, with_aux=True,
                          constrain=constrain)
    logits = constrained(constrain, logits, "logits")
    labels = labels.to(logits.device).long()
    if not hasattr(logits, "placements"):
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        # on a mesh the reference's sharding-safe forms, over the logits'
        # vocabulary split with no whole-vocabulary copy: the logsumexp
        # from a max and a sum (each reduced across the split), the label
        # logit as a contraction with the one-hot labels made in that split
        top = logits.detach().amax(-1, keepdim=True)
        lse = (top + torch.log(torch.exp(logits - top).sum(-1,
                                                           keepdim=True)))
        lse = lse[..., 0]
        onehot = labels[..., None] == _vocab_ids(logits)
        label_logit = (logits * onehot.to(logits.dtype)).sum(-1)
    loss = (lse - label_logit).mean()
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def _vocab_ids(logits):
    """``arange(V)`` as a DTensor split over the mesh dimensions that split
    the vocabulary (the last dim) of the DTensor ``logits``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    last = Shard(logits.dim() - 1)
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return distribute_tensor(
        ids, logits.device_mesh,
        [Shard(0) if p == last else Replicate() for p in logits.placements],
        src_data_rank=None)


def prefill(params, batch, cfg, max_ctx=None, constrain=None):
    """Full-sequence forward returning (logits, decode cache); ``max_ctx``
    sets the attention caches' length, by default s + 32, so that decoding
    continues past the prompt without wrapping the ring."""
    if max_ctx is None:
        max_ctx = batch["tokens"].shape[1] + 32
    return forward(params, batch, cfg, collect_cache=True, max_ctx=max_ctx,
                   constrain=constrain)


# ---------------------------------------------------------------- decode

def init_block_cache(kind, cfg, batch, ctx_len, sliding=None, device=None):
    """A zero decode cache of one block for ``batch`` rows: attention
    blocks keep a ring of ``min(ctx_len, W)`` slots, W the block's window
    (``attn`` / ``attn_moe`` / ``xattn``: ``cfg.sliding_window``, else
    ``sliding``, else ctx_len; ``local_attn``: the RG-LRU config's local
    window)."""
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    dtype = dtype_of(cfg.compute_dtype)
    if kind in ("attn", "attn_moe", "xattn"):
        w = cfg.sliding_window or (sliding or ctx_len)
        return attn.init_attn_cache(cfg, batch, ctx_len, window=w,
                                    dtype=dtype, device=device)
    if kind == "local_attn":
        return attn.init_attn_cache(cfg, batch, ctx_len,
                                    window=cfg.rglru.local_window,
                                    dtype=dtype, device=device)
    if kind == "mamba":
        return ssm_mod.init_mamba_cache(cfg, batch, dtype, device=device)
    return rglru_mod.init_rglru_cache(cfg, batch, dtype, device=device)


def init_cache(cfg, batch, ctx_len, sliding=None, device="cuda"):
    """A zero decode cache of every layer (``init_block_cache``)."""
    check_supported(cfg)
    dev = resolve(device)
    return [init_block_cache(kind, cfg, batch, ctx_len, sliding, device=dev)
            for kind in cfg.layer_kinds]


def decode_block(kind, p, x, cache, pos, ctx, cfg, constrain=None):
    """One block of one-token decode.  x (b, 1, d); ``ctx`` is
    ``make_ctx``'s (an ``xattn`` block reads its ``cond``); returns (x,
    cache)."""
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    if kind == "mamba":
        y, cache = ssm_mod.mamba_decode(
            p["mamba"], rmsnorm(x, p["norm1"], cfg.norm_eps), cache, cfg)
        return x + y, cache
    if kind == "rglru":
        y, cache = rglru_mod.rglru_decode(
            p["rglru"], rmsnorm(x, p["norm1"], cfg.norm_eps), cache, cfg)
        x = x + y
        return x + mlp_apply(p["mlp"], rmsnorm(x, p["norm2"], cfg.norm_eps),
                             cfg, constrain), cache
    h, cache = attn.decode_attention(
        p["attn"], rmsnorm(x, p["norm1"], cfg.norm_eps), cache, pos, cfg)
    return _after_self_attention(kind, p, x + h, ctx, cfg,
                                 constrain=constrain), cache


def decode_step(params, tokens, cache, pos, cfg, batch_extras=None,
                constrain=None):
    """One-token decode.  tokens (b, 1), or (b, 1, cb) under codebooks;
    pos the position of those tokens (an int); ``batch_extras`` the
    batch's other entries for this step (``cond``; ``visual_embeds`` and
    ``visual_mask`` of this token; ``positions3`` is read but, as in the
    reference, M-RoPE rotates by ``pos`` on all three streams); cache
    from ``init_cache`` / ``prefill``, whose attention ring buffers are
    written in place.  Returns (logits (b, 1, vocab) or (b, 1, cb,
    vocab) float32, the new cache)."""
    extras = dict(batch_extras or {})
    check_supported(cfg, extras)
    pos = int(pos)
    batch = {k: v for k, v in extras.items()
             if k not in ("positions", "positions3")}
    batch["tokens"] = tokens
    batch["positions"] = torch.full((tokens.shape[0], 1), pos,
                                    dtype=torch.int32, device=tokens.device)
    ctx = make_ctx(batch, cfg)
    x = embed_tokens(params, batch, cfg, ctx["positions"])
    new_cache = []
    for kind, p, c in zip(cfg.layer_kinds, params["blocks"], cache):
        x, c = decode_block(kind, p, x, c, pos, ctx, cfg, constrain)
        new_cache.append(c)
    return lm_head(params, x, cfg), new_cache
