"""Flash attention: the hand-written CUDA kernel and its dispatcher.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (``pl.pallas_call`` at line 87), and in the model the
jnp twins ``full_attention`` / ``blockwise_attention`` of
``src/repro/models/attention.py``, which compute the same function.

``flash_attention(q, k, v, causal, window, pos_q, pos_k)`` takes q (b,
sq, h, hd) and k, v (b, sk, kvh, hd) of one dtype (float32 or bfloat16)
and returns (b, sq, h, hd) in q's dtype; query head ``kv*g + gi`` reads
kv head ``kv``; positions are ``0..s-1`` (top-left causal alignment when
sq != sk), or the int32 ``pos_q`` (b, sq) and ``pos_k`` (b, sk) given
together (the reference's ``full_attention`` mask: decode over a ring
buffer, offset or packed prompts); scores are scaled by ``hd**-0.5``.  A CUDA tensor launches a
kernel of ``csrc/flash_attention.cu``, one per dtype: bfloat16 runs on the
tensor cores (bf16 operands, float32 accumulators, 16 rows of (position,
head) pairs per warp, P rounded to bf16 before the P V product; ``wgmma``
at head dims 64, 128, 192 and 256, ``mma.sync`` at 16, 32 and 112, as
``kernel_step`` reports); float32 runs on the CUDA cores (one query row
per thread, four threads per row at hd 192 and 256), for the float32
cross-checks.  Head dims: ``HEAD_DIMS``; any other raises on a CUDA
tensor.  A CPU tensor runs the eager twin ``ref.attention_ref``.
There is no fallback from one to another.  ``flash_attention.launches``
counts kernel launches.

The dispatcher reaches the kernel only through the operator
``repro_torch::flash_attn_fwd`` (``kernels.ops``): its CUDA
implementation is the launch above, its CPU implementation the twin, its
fake implementation the shapes (the meta device, ``FakeTensorMode``),
its cost rule ``attention_cost`` and its DTensor rule a split over the
batch or the heads.

Training: when grad is enabled and q, k or v requires it, the operator
also returns each row's logsumexp (b, h, sq) float32, and its autograd
formula calls ``repro_torch::flash_attn_bwd``: on a CUDA tensor the two
backward kernels of ``csrc/flash_attention.cu`` (dQ over query tiles; dK
and dV over key tiles, summed over each kv head's g query heads in one
fixed order; no atomics, the same bits on every run; bfloat16 on the
tensor cores with P and dS rounded to bf16 before their products,
float32 on the CUDA cores), on a CPU tensor the twin
``ref.attention_bwd_ref``.  Without grad the forward launches as it
always did, with no logsumexp.  ``flash_attention_bwd.launches`` counts
backward calls (two kernels each).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.build import LIBRARIES
from repro_torch.kernels.ref import attention_bwd_ref, attention_ref

#: head dims the kernels are compiled for (csrc/flash_attention.cu): every
#: registered model's (kimi-k2-1t-a32b's 112, nemotron-4-340b's 192)
HEAD_DIMS = (16, 32, 64, 112, 128, 192, 256)
#: query rows of the float32 kernel's CTA, per head dim, bound its query
#: heads per kv head; the bfloat16 kernel takes any group
MAX_GROUP = {16: 128, 32: 128, 64: 128, 112: 128, 128: 128, 192: 64,
             256: 64}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_positions(q, k, pos_q, pos_k):
    if (pos_q is None) != (pos_k is None):
        raise ValueError("flash_attention: give pos_q and pos_k together")
    if pos_q is None:
        return
    for name, t, want in (("pos_q", pos_q, q.shape[:2]),
                          ("pos_k", pos_k, k.shape[:2])):
        if tuple(t.shape) != tuple(want) or t.dtype != torch.int32:
            raise ValueError(f"flash_attention: {name} must be int32 "
                             f"{tuple(want)}, not {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-d "
                         "(b, s, heads, hd)")
    b, sq, h, hd = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b \
            or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    kvh = k.shape[2]
    if kvh < 1 or h % kvh:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {kvh} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: dtypes differ: {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v are on different devices")


def max_group(dtype, hd):
    """Most query heads per kv head the kernel of ``dtype`` takes at head
    dim ``hd``; None where any number goes."""
    return MAX_GROUP[hd] if dtype == torch.float32 else None


def _entry(symbol, pointers, ints):
    """The library's C entry point ``symbol``, typed once per process."""
    return LIBRARIES.entry("flash_attention", symbol, pointers, ints)


def _launcher():
    """The forward's C entry point, typed once per process."""
    return _entry("flash_attention_pos_launch", 6, 9)


def kernel_step(hd):
    """Which tensor-core kernel serves bfloat16 at head dim ``hd``: 1 for
    ``mma.sync``, 2 for ``wgmma`` (read from the built library)."""
    fn = LIBRARIES.get("flash_attention").flash_attention_bf16_step
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return fn(hd)


def flash_attention_cuda(q, k, v, causal=True, window=0, pos_q=None,
                         pos_k=None, with_lse=False):
    """Launch the CUDA kernel on contiguous CUDA tensors; returns a freshly
    allocated output, or with ``with_lse`` (output, lse (b, h, sq)
    float32)."""
    _check(q, k, v)
    _check_positions(q, k, pos_q, pos_k)
    if pos_q is not None:
        pos_q, pos_k = pos_q.contiguous(), pos_k.contiguous()
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not "
                         f"float32 or bfloat16")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    limit = max_group(q.dtype, hd)
    if limit is not None and h // kvh > limit:
        raise ValueError(f"flash_attention: {h // kvh} query heads per kv "
                         f"head > {limit} at head dim {hd} in {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        # the bfloat16 kernel copies 16-byte rows with cp.async
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if b == 0 or sq == 0:
        return (out, lse) if with_lse else out
    pos = (None if pos_q is None else pos_q.data_ptr(),
           None if pos_k is None else pos_k.data_ptr())
    shape = (b, sq, sk, h, kvh, hd, int(bool(causal)), int(window),
             _DTYPE_CODE[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if with_lse:
            rc = _entry("flash_attention_lse_launch", 7, 9)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *pos, *shape, stream)
        else:
            rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), *pos, *shape, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=0,
                             pos_q=None, pos_k=None):
    """Launch the two backward kernels on contiguous CUDA tensors: q, k, v,
    the forward's output o and the output's gradient do of one dtype, lse
    (b, h, sq) float32 from the forward; returns freshly allocated (dq, dk,
    dv)."""
    _check(q, k, v)
    _check_positions(q, k, pos_q, pos_k)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: {q.dtype} at head dim {hd} "
                         f"is not built")
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} is not q's")
    if tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32 "
                         f"{(b, h, sq)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do),
                    ("lse", lse)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"contiguous")
        # the bfloat16 kernels copy and store 16-byte rows
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} is not 16-byte "
                             f"aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if b == 0 or sq == 0:
        return dq, dk.zero_(), dv.zero_()
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _entry("flash_attention_bwd_launch", 12, 9)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                None if pos_q is None else pos_q.data_ptr(),
                None if pos_k is None else pos_k.data_ptr(),
                b, sq, sk, h, kvh, hd, int(bool(causal)), int(window),
                _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def _no_lse(q):
    """The logsumexp output of a call that did not ask for it: (b, h, 0)
    float32, which shards like the real one."""
    return q.new_empty((q.shape[0], q.shape[2], 0), dtype=torch.float32)


def _fwd_cpu(q, k, v, causal, window, pos_q, pos_k, with_lse):
    if with_lse:
        out, lse = attention_ref(q, k, v, causal=causal, window=window,
                                 pos_q=pos_q, pos_k=pos_k, return_lse=True)
        return out.contiguous(), lse.contiguous()
    out = attention_ref(q, k, v, causal=causal, window=window, pos_q=pos_q,
                        pos_k=pos_k)
    return out.contiguous(), _no_lse(q)


def _fwd_cuda(q, k, v, causal, window, pos_q, pos_k, with_lse):
    if with_lse:
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    pos_q=pos_q, pos_k=pos_k, with_lse=True)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                pos_q=pos_q, pos_k=pos_k), _no_lse(q)


def _fwd_fake(q, k, v, causal, window, pos_q, pos_k, with_lse):
    b, sq, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, sq if with_lse else 0), dtype=torch.float32))


#: the reference runs ``blockwise_attention`` above this many query rows
#: (``repro.models.attention.self_attention``), ``full_attention`` up to it
BLOCKWISE_ABOVE = 2048
#: ``blockwise_attention``'s query and key blocks
Q_BLOCK, KV_BLOCK = 512, 1024


def attention_cost(b, sq, sk, h, kvh, hd, causal, window, causal_skip=False):
    """(dot, other) FLOPs of the forward: what the reference's counter
    (``repro.launch.flopcount``) counts for the reference's jnp twin of
    the kernel at this shape, so that a port's step counts as the
    reference's.  Up to ``BLOCKWISE_ABOVE`` causal query rows, and for
    every non-causal call, that twin is ``full_attention``: the two
    products over every (query, key) pair, 5 operations per score, 3 per
    row, one per (batch, query, key) mask compare (causal) and 3 more
    with a window.  Above, it is ``blockwise_attention``: queries and keys
    padded to whole blocks of ``Q_BLOCK`` × ``KV_BLOCK``, every block pair
    visited (with ``causal_skip``, query block i visits only the key
    blocks up to its diagonal), the online softmax's 4 operations per
    score, 7 per row and 2 per output entry in each visited block, 1 per
    row and output entry per query block, and one per padded input entry
    (the pads are copies)."""
    g_rows = b * h
    if not (causal and sq > BLOCKWISE_ABOVE):
        n = g_rows * sq * sk
        dot = 4.0 * n * hd
        other = 5.0 * n + 3.0 * g_rows * sq
        if causal:
            other += b * sq * sk
        if window:
            other += 3.0 * b * sq * sk
        return dot, other
    nq, nk = -(-sq // Q_BLOCK), -(-sk // KV_BLOCK)
    if causal_skip:
        visits = sum(min(-(-((i + 1) * Q_BLOCK) // KV_BLOCK), nk)
                     for i in range(nq))
    else:
        visits = nq * nk
    pair = Q_BLOCK * KV_BLOCK
    rows, outs = g_rows * Q_BLOCK, g_rows * Q_BLOCK * hd
    per_visit = (4.0 * g_rows * pair + b * pair * (1 + 3 * bool(window))
                 + 7.0 * rows + 2.0 * outs)
    pads = (b * nq * Q_BLOCK * (h * hd + 1)
            + b * nk * KV_BLOCK * (2 * kvh * hd + 1))
    return (4.0 * g_rows * pair * hd * visits,
            visits * per_visit + nq * (rows + outs) + pads)


def _fwd_cost(args, opts):
    q, k = args[0], args[1]
    b, sq, h, hd = q.shape
    return attention_cost(b, sq, k.shape[1], h, k.shape[2], hd, args[3],
                          args[4], opts.get("attn_causal_skip", False))


def _bwd_cost(args, opts):
    """(dot, other) FLOPs of the backward kernels: the seven products they
    compute per (query, key) pair, masked pairs included as the forward's
    rule counts them (the dQ kernel recomputes S = QKᵀ and dP = dO Vᵀ and
    forms dQ = dS K; the dK/dV kernel recomputes S and dP and forms dV =
    Pᵀ dO and dK = dSᵀ Q), 6 operations per score in each of the two
    kernels (P from S, the scale and the logsumexp; dS from P, dP and D)
    and 2 per output entry for D = rowsum(dO∘O).  The gradient needs only
    five products (``chip_smoke.py``'s bound counts five)."""
    q, k = args[0], args[1]
    b, sq, h, hd = q.shape
    n = b * h * sq * k.shape[1]
    return 14.0 * n * hd, 12.0 * n + 2.0 * b * sq * h * hd


def _sharding(args, out_ndims):
    """DTensor placements of one mesh dimension: everything replicated,
    or split over the batch, or over the heads (dim 2 of the 4-d
    operands, dim 1 of the logsumexp; positions replicated) with query
    and kv heads split together, offered when the kv heads divide every
    mesh dimension so that each shard keeps whole groups."""
    from torch.distributed.tensor import Replicate, Shard

    def place(ndim, rule):                 # rule: {ndim: the dim split}
        return Shard(rule[ndim]) if ndim in rule else Replicate()

    rules = [{}, {4: 0, 3: 0, 2: 0}]
    q, k = args[0], args[1]
    if all(k.shape[2] % n == 0 for n in q.mesh.shape):
        rules.append({4: 2, 3: 1})
    return [([place(nd, r) for nd in out_ndims],
             [place(len(a.shape), r) if hasattr(a, "shape") else None
              for a in args]) for r in rules]


def _fwd_sharding(q, k, v, causal, window, pos_q, pos_k, with_lse):
    return _sharding((q, k, v, causal, window, pos_q, pos_k, with_lse),
                     (4, 3))


def _bwd_cpu(q, k, v, o, lse, do, causal, window, pos_q, pos_k):
    dq, dk, dv = attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                   window=window, pos_q=pos_q, pos_k=pos_k)
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


def _bwd_cuda(q, k, v, o, lse, do, causal, window, pos_q, pos_k):
    return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                    window=window, pos_q=pos_q, pos_k=pos_k)


def _bwd_fake(q, k, v, o, lse, do, causal, window, pos_q, pos_k):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _bwd_sharding(q, k, v, o, lse, do, causal, window, pos_q, pos_k):
    return _sharding((q, k, v, o, lse, do, causal, window, pos_q, pos_k),
                     (4, 4, 4))


flash_attn_bwd_op = ops.define(
    "flash_attn_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, "
    "bool causal, int window, Tensor? pos_q, Tensor? pos_k) "
    "-> (Tensor, Tensor, Tensor)",
    cpu=_bwd_cpu, cuda=_bwd_cuda, fake=_bwd_fake, cost=_bwd_cost,
    sharding=_bwd_sharding)


def _setup(ctx, inputs, output):
    q, k, v, causal, window, pos_q, pos_k, with_lse = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, pos_q, pos_k)
    ctx.causal, ctx.window, ctx.with_lse = causal, window, with_lse


def _backward(ctx, do, dlse):
    if not ctx.with_lse:
        raise RuntimeError("flash_attn_fwd: the gradient needs the "
                           "forward's logsumexp (with_lse=True)")
    q, k, v, out, lse, pos_q, pos_k = ctx.saved_tensors
    dq, dk, dv = flash_attn_bwd_op(q, k, v, out, lse,
                                   do.to(q.dtype).contiguous(), ctx.causal,
                                   ctx.window, pos_q, pos_k)
    return dq, dk, dv, None, None, None, None, None


flash_attn_fwd_op = ops.define(
    "flash_attn_fwd",
    "(Tensor q, Tensor k, Tensor v, bool causal, int window, Tensor? pos_q, "
    "Tensor? pos_k, bool with_lse) -> (Tensor, Tensor)",
    cpu=_fwd_cpu, cuda=_fwd_cuda, fake=_fwd_fake, cost=_fwd_cost,
    backward=_backward, setup_context=_setup, sharding=_fwd_sharding)


def flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=0,
                        pos_q=None, pos_k=None):
    """The backward (``repro_torch::flash_attn_bwd``): the CUDA kernels on
    CUDA tensors, the eager twin on CPU tensors."""
    ops.check_device(q, "flash_attention_bwd")
    return flash_attn_bwd_op(q, k, v, o, lse, do, bool(causal), int(window),
                             pos_q, pos_k)


flash_attention_bwd.launches = 0


def flash_attention(q, k, v, causal=True, window=0, pos_q=None, pos_k=None):
    """Attention (``repro_torch::flash_attn_fwd``): the CUDA kernel on CUDA
    tensors, the eager twin on CPU tensors, shapes only on the meta
    device; with its gradient (the forward then keeps the logsumexp) when
    q, k or v requires one."""
    _check(q, k, v)
    _check_positions(q, k, pos_q, pos_k)
    ops.check_device(q, "flash_attention")
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    return ops.call(flash_attn_fwd_op, grad, q, k, v, bool(causal),
                    int(window), pos_q, pos_k, grad)[0]


flash_attention.launches = 0
