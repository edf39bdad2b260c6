"""The layer split as a real GPipe pipeline over a sequence of devices.

The port of ``repro.serving.pipeline_smap``.  The reference ``shard_map``s
a stage mesh axis: each device holds its contiguous slice of the layer
stack, microbatches flow through a GPipe schedule of M + S − 1 ticks and
activations move stage to stage by ``ppermute``.  Here the "mesh" is a
sequence of S ``torch.device``s, one per stage: stage s holds layers
``[s·L/S, (s+1)·L/S)``, moved to ``devices[s]`` once, and at tick t it
runs microbatch t − s (stage 0 takes microbatch t while t < M; the
reference's stages also run their idle ticks on zeros, whose outputs it
discards), taking stage s − 1's output of the tick before (copied
``.to(devices[s], non_blocking=True)`` on the producer's stream).  The last stage collects the
finished microbatches and ``lm_head`` runs there.

On a card each stage enqueues on a CUDA stream of its own, so the stages'
launches overlap where the card has room; every hand-off is ordered by an
event and the handed tensor is marked with ``record_stream`` for the
stream that reads it (its memory belongs to the stream that made it: the
caching allocator must not give it out again while another stream still
reads it).  Stage s keeps its stream across calls (``device.part_stream``):
the allocator pools memory per stream, so a fresh stream per call would
allocate every stage's activations anew.  On the CPU the ticks run in order.  Several stages may name
one device (the tests run S = 4 CPU "devices"; one card runs S streams).

As in the reference: the whole-batch embedding runs on stage 0, ``ctx``
is built from the first microbatch's tokens (so every microbatch gets the
plain positions, and M-RoPE's three streams are those positions), and
only ``tokens`` (b, s) is taken.  The pipeline equals ``forward`` up to
float reassociation, except with MoE: an ``attn_moe`` block's capacity
applies to each microbatch's tokens (the reference runs ``apply_block``
per microbatch too), so where ``forward`` drops tokens over its whole
group the pipeline equals ``forward`` of each microbatch alone instead.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.device import part_stream, resolve
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_unflatten


def _uniform_kind(cfg):
    kinds = set(cfg.layer_kinds)
    if len(kinds) != 1:
        raise ValueError(f"the GPipe pipeline needs a uniform layer "
                         f"pattern, got {sorted(kinds)}")
    return next(iter(kinds))


def _check(cfg, batch, S, Mb):
    """The reference's asserts as ``ValueError``s naming the cause."""
    kind = _uniform_kind(cfg)
    prefix, (pattern, periods), suffix = cfg.scan_segments
    if prefix or suffix or len(pattern) != 1:
        raise ValueError(f"the GPipe pipeline needs one block kind with no "
                         f"prefix or suffix, got {cfg.scan_segments}")
    extra = sorted(set(batch) - {"tokens"})
    if extra:
        raise ValueError(f"the GPipe pipeline takes only tokens; the batch "
                         f"also holds {extra}")
    tokens = batch["tokens"]
    if tokens.dim() != 2:
        raise ValueError(f"the GPipe pipeline takes (b, s) tokens, got "
                         f"{tuple(tokens.shape)} (codebook tokens (b, s, cb) "
                         f"are not taken, as in the reference)")
    if S < 1 or periods % S:
        raise ValueError(f"{S} stages do not divide the {periods} layers")
    if Mb < 1 or tokens.shape[0] % Mb:
        raise ValueError(f"{Mb} microbatches do not divide the batch of "
                         f"{tokens.shape[0]}")
    return kind


def _to(tree, dev):
    return tree_unflatten(tree, [t.to(dev) for t in tree_leaves(tree)])


def _ctx_to(ctx, dev):
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in ctx.items()}


def pipeline_shard_map(params, batch, cfg, devices, num_microbatches: int):
    """Full-sequence forward of ``batch["tokens"]`` (b, s) through an
    S-stage, M-microbatch GPipe pipeline, S = ``len(devices)`` (a sequence
    of devices or device strings; ``params`` may lie anywhere).  The layer
    count must be S times a whole number and b M times one.  Returns
    float32 logits (b, s, vocab) on the last stage's device, equal to
    ``forward`` up to float reassociation (see the module docstring for
    MoE).  Raises a ``ValueError`` for what the reference cannot run: a
    pattern that is not one block kind, codebook tokens, batch entries
    other than ``tokens``, an S or M that does not divide."""
    devs = [resolve(d) for d in devices]
    S, Mb = len(devs), int(num_microbatches)
    kind = _check(cfg, batch, S, Mb)
    M.check_supported(cfg, batch)
    tokens = batch["tokens"].to(devs[0])
    b, seq = tokens.shape
    per = cfg.num_layers // S
    blocks = [[_to(p, devs[s]) for p in params["blocks"][s * per:
                                                        (s + 1) * per]]
              for s in range(S)]
    ctxs = [_ctx_to(M.make_ctx({"tokens": tokens[: b // Mb]}, cfg), d)
            for d in devs]
    x = M.embed_tokens({"embed": params["embed"].to(devs[0])},
                       {"tokens": tokens}, cfg, M.positions_of(tokens))
    x_mb = x.reshape(Mb, b // Mb, seq, cfg.d_model)
    head = {k: params[k].to(devs[-1]) for k in ("final_norm", "embed",
                                               "head") if k in params}

    cuda = devs[0].type == "cuda"
    if cuda:
        streams = [part_stream(d, s) for s, d in enumerate(devs)]
        for d, st in zip(devs, streams):
            st.wait_stream(torch.cuda.current_stream(d))
        x.record_stream(streams[0])

    def on(s):
        if not cuda:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(devs[s]))
        stack.enter_context(torch.cuda.stream(streams[s]))
        return stack

    inbox = [None] * S             # (activation, its producer's event)
    outputs = [None] * Mb
    for t in range(Mb + S - 1):
        sent = [None] * S
        for s in range(S):
            m = t - s
            if not 0 <= m < Mb:
                continue
            with on(s):
                if s == 0:
                    act = x_mb[m]
                else:
                    act, ev = inbox[s]
                    if cuda:
                        streams[s].wait_event(ev)
                        act.record_stream(streams[s])
                for p in blocks[s]:
                    act = M.apply_block(kind, p, act, ctxs[s], cfg)
                if s == S - 1:
                    outputs[m] = act
                    continue
                # the hand-off: copied on this stage's stream (a no-op on
                # one device), then an event the next stage waits for
                act = act.to(devs[s + 1], non_blocking=True)
                ev = None
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record(streams[s])
                sent[s + 1] = (act, ev)
        inbox = sent
    if cuda:
        last = torch.cuda.current_stream(devs[-1])
        for d, st in zip(devs, streams):
            torch.cuda.current_stream(d).wait_stream(st)
        for out in outputs:
            out.record_stream(last)
    x_out = torch.cat(outputs).reshape(b, seq, cfg.d_model)
    return M.lm_head(head, x_out, cfg)
