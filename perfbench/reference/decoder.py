"""The plain reference of the served decoders, in float32 PyTorch.

It computes, from a configuration file's numbers, the same weights and the
same batch that the harness hands the program, what the program's serving
plans should give:

* ``forward``: the monolithic decoder; the layer-split pipeline runs the same
  layers in the same order, so it is also that plan's reference;
* ``branch_forward``: the semantic split, B branches over disjoint slices of
  the attention heads and of the MLP channels (an MoE layer, embedding and
  head run whole in every branch), their logits averaged.

The layers: token embeddings, replaced by patch embeddings under the visual
mask; per layer an RMS norm (``x * rsqrt(mean(x^2) + eps) * (1 + w)``), GQA
self attention with q/k/v biases, causal, scores scaled by ``hd ** -0.5``,
rotary embedding on interleaved pairs (RoPE, or M-RoPE with its three
position streams over the pair sections), a residual, a second norm and a
gated SiLU MLP, or the MoE: float32 router, softmax, the top-k distinct
experts (the lower index first on ties), gates renormalised, first-come slots
per group of tokens in flattened (token, choice) order, a (token, choice)
kept while its slot is below the capacity, plus the shared expert under a
sigmoid gate; a final norm and the head.

Every product runs through ``matmul`` in one of two precisions: ``"f32"``
(TF32 off: the caller sets ``torch.backends.cuda.matmul.allow_tf32 =
False``), or ``"fp8"``, the control: both operands rounded to float8 e4m3
with one scale per tensor (amax / 448), the product accumulated in float32.
The reference runs layer by layer, each layer's weights widened to float32
as it runs, so that it fits beside the bfloat16 weights.  It imports nothing
of the program.
"""
from __future__ import annotations

import torch

F32 = torch.float32
E4M3_MAX = 448.0


def _fp8(t):
    """t rounded to float8 e4m3 under one per-tensor scale, back in
    float32."""
    amax = t.abs().amax().clamp(min=1e-30)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale


def matmul(a, b, precision="f32"):
    """a @ b in float32, or with both operands rounded to fp8 first."""
    a, b = a.to(F32), b.to(F32)
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return a @ b


class Shape:
    """The sizes the reference reads from a configuration file."""

    def __init__(self, c: dict):
        self.d = c["hidden_size"]
        self.layers = c["num_hidden_layers"]
        self.heads = c["num_attention_heads"]
        self.kv_heads = c["num_key_value_heads"]
        self.hd = c.get("head_dim") or self.d // self.heads
        self.ff = c["intermediate_size"]
        self.vocab = c["vocab_size"]
        self.eps = c["rms_norm_eps"]
        self.theta = c["rope_theta"]
        rs = c.get("rope_scaling") or {}
        self.mrope = tuple(rs["mrope_section"]) if "mrope_section" in rs \
            else None
        self.experts = c.get("num_experts", 0)
        if self.experts:
            self.top_k = c["num_experts_per_tok"]
            self.ff_expert = c["moe_intermediate_size"]
            self.ff_shared = c.get("shared_expert_intermediate_size", 0)
            self.capacity_factor = c["moe_capacity_factor"]
            self.group_size = c["moe_group_size"]


def rmsnorm(x, w, eps):
    x = x.to(F32)
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + w.to(F32))


def _rotate(x, ang):
    """Rotate interleaved pairs of x (b, s, h, hd) by ang (b, s, hd/2)."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).flatten(-2)


def rope_angles(shape, positions, positions3, hd, device):
    """(b, s, hd/2) float32 angles: RoPE by ``positions`` (b, s), or M-RoPE
    with each of the three streams of ``positions3`` (b, 3, s) over its
    section of the pairs."""
    freqs = shape.theta ** (-torch.arange(0, hd, 2, dtype=F32,
                                          device=device) / hd)
    if shape.mrope is None:
        return positions[..., None].to(F32) * freqs
    if positions3 is None:
        positions3 = positions[:, None, :].expand(-1, 3, -1)
    if sum(shape.mrope) != hd // 2:
        raise ValueError("M-RoPE sections do not cover hd / 2 pairs")
    parts, off = [], 0
    for i, sec in enumerate(shape.mrope):
        parts.append(positions3[:, i, :, None].to(F32)
                     * freqs[off:off + sec])
        off += sec
    return torch.cat(parts, dim=-1)


def attention(p, x, ang, heads, kv_heads, hd, precision, rows=(None, None)):
    """Causal GQA self attention of x (b, s, d) with the heads of
    ``rows`` = (head slice, kv head slice) of the weights (the whole
    layer when both are None)."""
    hs, ks = rows
    hs = hs or slice(0, heads)
    ks = ks or slice(0, kv_heads)
    h, kvh = hs.stop - hs.start, ks.stop - ks.start
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)

    def proj(w, bias, sl, n):
        y = matmul(x2, w[:, sl].reshape(d, n * hd), precision)
        return (y.reshape(b, s, n, hd) + bias[sl].to(F32))

    q = _rotate(proj(p["wq"], p["bq"], hs, h), ang)
    k = _rotate(proj(p["wk"], p["bk"], ks, kvh), ang)
    v = proj(p["wv"], p["bv"], ks, kvh)
    group = h // kvh
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    out = torch.empty(b, s, h, hd, dtype=F32, device=x.device)
    scale = hd ** -0.5
    for j in range(kvh):
        kj, vj = k[:, :, j], v[:, :, j]                     # (b, s, hd)
        for g in range(group):
            i = j * group + g
            sc = matmul(q[:, :, i], kj.transpose(1, 2), precision) * scale
            sc = sc.masked_fill(~mask, float("-inf"))
            out[:, :, i] = matmul(torch.softmax(sc, dim=-1), vj, precision)
    wo = p["wo"][hs].reshape(h * hd, d)
    return matmul(out.reshape(b * s, h * hd), wo, precision).reshape(b, s, d)


def gated_mlp(p, x2, precision, cols=None):
    """SiLU(x W_gate) * (x W_up) W_down on x2 (n, d), with the channel
    slice ``cols`` of the weights (all when None)."""
    cols = cols or slice(0, p["w_up"].shape[1])
    g = matmul(x2, p["w_gate"][:, cols], precision)
    u = matmul(x2, p["w_up"][:, cols], precision)
    return matmul(torch.nn.functional.silu(g) * u, p["w_down"][cols],
                  precision)


def route(probs, k):
    """The top-k distinct experts of each row of probs (the lower index
    first on ties) and their probabilities."""
    left = probs.clone()
    eids, gates = [], []
    for _ in range(k):
        i = torch.argmax(left, dim=-1)                     # first maximum
        eids.append(i)
        gates.append(probs.gather(-1, i[:, None])[:, 0])
        left.scatter_(-1, i[:, None], float("-inf"))
    return torch.stack(eids, -1), torch.stack(gates, -1)


def first_come_slots(eid, gs, num_experts):
    """Each (token, choice)'s slot in its expert: the earlier entries of
    the same expert in flattened (token, choice) order, per group of gs
    tokens.  eid (n, k) with n a multiple of gs."""
    k = eid.shape[-1]
    grouped = eid.reshape(-1, gs * k).long()
    onehot = torch.nn.functional.one_hot(grouped, num_experts)
    slot = (onehot.cumsum(1) - 1).gather(2, grouped[..., None])[..., 0]
    return slot.reshape(-1, k)


def capacity(shape, gs):
    return max(int(gs * shape.top_k / shape.experts * shape.capacity_factor),
               shape.top_k)


def moe(p, x, shape, precision, forced=None, record=None, router=None):
    """Routed experts plus the shared expert on x (b, s, d).  The routing
    is the reference's own, or with ``forced`` = (eid, keep) the judged
    side's choice of experts and of the (token, choice) pairs kept, the
    gates always the reference's probabilities at those experts;
    ``record`` (a list) receives the (eid, keep) used, ``router`` (a list)
    the router's logits (tokens padded to whole groups, E)."""
    b, s, d = x.shape
    n = b * s
    E, k = shape.experts, shape.top_k
    gs = min(shape.group_size, n)
    pad = (-n) % gs
    x2 = x.reshape(n, d)
    xg = torch.cat([x2, x2.new_zeros(pad, d)]) if pad else x2
    logits = matmul(xg, p["router"], precision)
    if router is not None:
        router.append(logits)
    probs = torch.softmax(logits, dim=-1)
    if forced is None:
        eid, _ = route(probs, k)
        keep = first_come_slots(eid, gs, E) < capacity(shape, gs)
    else:
        eid, keep = (t.reshape(-1, k).to(probs.device) for t in forced)
        eid = eid.long()
    if record is not None:
        record.append((eid, keep))
    gate = probs.gather(-1, eid)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    y = torch.zeros(xg.shape, dtype=F32, device=x.device)
    for e in range(E):
        tok, choice = torch.nonzero((eid == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = gated_mlp({"w_gate": p["w_gate"][e], "w_up": p["w_up"][e],
                       "w_down": p["w_down"][e]}, xg[tok], precision)
        y.index_add_(0, tok, h * gate[tok, choice][:, None])
    y = y[:n]
    if "shared" in p:
        sg = torch.sigmoid(matmul(x2, p["shared_gate"], precision))
        y = y + gated_mlp(p["shared"], x2, precision) * sg
    return y.reshape(b, s, d)


def _embed(weights, batch, shape):
    x = weights["embed"][batch["tokens"].long()].to(F32)
    if "visual_embeds" in batch:
        m = batch["visual_mask"].to(torch.bool)[..., None]
        x = torch.where(m, batch["visual_embeds"].to(F32), x)
    return x


def _head(weights, x, shape, precision):
    b, s, d = x.shape
    xn = rmsnorm(x, weights["final_norm"], shape.eps).reshape(b * s, d)
    return matmul(xn, weights["head"], precision).reshape(b, s, -1)


def _branch_slices(shape, branch, num_branches):
    """(head slice, kv head slice, MLP channel slice) of one branch: 1/B
    of the heads and kv heads when both divide by B (else all of them),
    1/B of the MLP channels."""
    hs = ks = None
    if branch is not None:
        if shape.heads % num_branches == 0 \
                and shape.kv_heads % num_branches == 0:
            nh, nk = shape.heads // num_branches, shape.kv_heads // num_branches
            hs = slice(branch * nh, (branch + 1) * nh)
            ks = slice(branch * nk, (branch + 1) * nk)
        nf = shape.ff // num_branches
        return hs, ks, slice(branch * nf, (branch + 1) * nf)
    return hs, ks, None


def _run(config, weights, batch, precision, branch=None, num_branches=1,
         routes=None, record=None, router=None):
    shape = Shape(config)
    tokens = batch["tokens"]
    b, s = tokens.shape[:2]
    dev = tokens.device
    positions = torch.arange(s, device=dev).expand(b, s)
    ang = rope_angles(shape, positions, batch.get("positions3"), shape.hd,
                      dev)
    hs, ks, cols = _branch_slices(shape, branch, num_branches)
    x = _embed(weights, batch, shape)
    forced = iter(routes) if routes is not None else None
    for p in weights["blocks"]:
        xn = rmsnorm(x, p["norm1"], shape.eps)
        x = x + attention(p["attn"], xn, ang, shape.heads, shape.kv_heads,
                          shape.hd, precision, (hs, ks))
        xn = rmsnorm(x, p["norm2"], shape.eps)
        if "moe" in p:
            x = x + moe(p["moe"], xn, shape, precision,
                        next(forced) if forced is not None else None, record,
                        router)
        else:
            x = x + gated_mlp(p["mlp"], xn.reshape(b * s, -1), precision,
                              cols).reshape(b, s, -1)
    return _head(weights, x, shape, precision)


@torch.no_grad()
def forward(config, weights, batch, precision="f32", routes=None,
            record=None, router=None):
    """Float32 logits (b, s, vocab) of the monolithic decoder.  ``routes``
    (one (eid, keep) per MoE layer, in order) forces the MoE layers' routing; ``record``
    (a list) receives the routing used, one entry per MoE layer, and
    ``router`` (a list) each MoE layer's router logits."""
    return _run(config, weights, batch, precision, routes=routes,
                record=record, router=router)


@torch.no_grad()
def branch_forward(config, weights, batch, num_branches, precision="f32",
                   routes=None, record=None, router=None):
    """Float32 logits of the semantic split: the mean of the B branches'
    logits.  ``routes``, ``record`` and ``router`` as ``forward``'s, the branches'
    MoE layers in order (branch 0's layers, then branch 1's, ...)."""
    out = None
    per = sum("moe" in p for p in weights["blocks"])
    for br in range(num_branches):
        sub = routes[br * per:(br + 1) * per] if routes is not None else None
        y = _run(config, weights, batch, precision, br, num_branches, sub,
                 record, router)
        out = y if out is None else out + y
    return out / num_branches
