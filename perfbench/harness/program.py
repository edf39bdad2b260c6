"""The system under test, ``repro_torch``'s serving engine, as the harness
drives it: the port's model config made from a configuration file's
numbers, the engine built on the harness's weights, and taps on the
harness's own engine instance that keep what the timed path produced and,
in a traced run, time the plan and the monolithic forward with the device
synchronized.  Nothing of the program is edited: the taps are instance
attributes that shadow the engine's methods of the same name."""
from __future__ import annotations

import time

import torch
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import moe
from repro_torch.serving.engine import Request, SplitPlaceEngine


def port_config(c: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    kw = dict(name=c["name"], num_layers=c["num_hidden_layers"],
              d_model=c["hidden_size"], num_heads=c["num_attention_heads"],
              num_kv_heads=c["num_key_value_heads"],
              d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
              head_dim=c.get("head_dim") or 0, qkv_bias=c["qkv_bias"],
              rope_theta=c["rope_theta"], norm_eps=c["rms_norm_eps"],
              activation=c["hidden_act"], mlp_gated=True,
              tie_embeddings=c["tie_word_embeddings"],
              param_dtype=c["torch_dtype"], compute_dtype=c["torch_dtype"],
              source=c["source"])
    rs = c.get("rope_scaling") or {}
    if "mrope_section" in rs:
        kw.update(pos_emb="mrope", mrope_sections=tuple(rs["mrope_section"]))
    if c.get("visual_frontend"):
        kw.update(arch_type="vlm", visual_frontend=True)
    elif c.get("num_experts"):
        kw.update(arch_type="moe", block_pattern=("attn_moe",),
                  moe=MoEConfig(
                      num_experts=c["num_experts"],
                      top_k=c["num_experts_per_tok"],
                      d_ff_expert=c["moe_intermediate_size"],
                      num_shared_experts=int(
                          bool(c.get("shared_expert_intermediate_size"))),
                      shared_d_ff=c.get("shared_expert_intermediate_size", 0),
                      capacity_factor=c["moe_capacity_factor"],
                      group_size=c["moe_group_size"]))
    else:
        kw.update(arch_type="dense")
    return ModelConfig(**kw)


def make_engine(weights, config: dict, mix: dict, seed: int, device):
    return SplitPlaceEngine(weights, port_config(config),
                            num_stages=mix["stages"],
                            num_branches=mix["branches"],
                            num_slices=mix["slices"], seed=seed,
                            device=device)


class RouteTap:
    """Shadows ``moe_route`` in ``repro_torch.models.moe`` (the name
    ``moe_apply`` calls) while open: keeps each call's router logits and
    its (eid, gate, slot), in call order, so that the check can follow the
    program's routing and hold the routing itself against the reference.
    It holds references only and copies nothing."""

    def __init__(self):
        self.calls = []
        self.original = moe.moe_route

        def tapped(logits, k):
            out = self.original(logits, k)
            self.calls.append((logits, *out))
            return out
        moe.moe_route = tapped

    def close(self):
        moe.moe_route = self.original
        self.calls = []


class Tap:
    """Shadows ``_pipe``, ``_branch`` and ``_mono`` on one engine: keeps the
    last plan's and monolithic forward's logits (``plan_out``,
    ``mono_out``) and routing calls (``plan_routes``, ``mono_routes``,
    with ``routes``, a ``RouteTap``) and, when ``timed``, their
    synchronized walls (``plan_s``, ``mono_s``); while ``marks`` is a
    list, it receives each of them, the placement and the DASO training
    as (name, start, end) on the host clock.
    ``fault`` (tests only) replaces the plan's output by
    ``fault(logits)``."""

    def __init__(self, engine, timed=False, fault=None, routes=None):
        self.engine, self.timed, self.fault = engine, timed, fault
        self.routes = routes
        self.cuda = engine.device.type == "cuda"
        self.plan_out = self.mono_out = None
        self.plan_routes = self.mono_routes = None
        self.plan_s = self.mono_s = 0.0
        self.marks = None
        self.shadowed = []
        for name, slot in (("_pipe", "plan"), ("_branch", "plan"),
                           ("_mono", "mono")):
            self._shadow(name, self._wrap(getattr(engine, name), slot))
        if timed:
            for name in ("place_fragments", "_daso_feedback"):
                self._shadow(name, self._label(getattr(engine, name), name))

    def _shadow(self, name, fn):
        setattr(self.engine, name, fn)
        self.shadowed.append(name)

    def close(self):
        """Removes the shadows (the engine and the tap refer to each other
        through them) and the route tap."""
        for name in self.shadowed:
            delattr(self.engine, name)
        self.shadowed = []
        if self.routes is not None:
            self.routes.close()
        self.engine = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.engine.device)

    def _wrap(self, fn, slot):
        def run(batch):
            first = len(self.routes.calls) if self.routes is not None else 0
            if self.timed:
                self._sync()
                t0 = time.perf_counter()
                out = fn(batch)
                self._sync()
                t1 = time.perf_counter()
                setattr(self, f"{slot}_s", t1 - t0)
                if self.marks is not None:
                    self.marks.append((slot, t0, t1))
            else:
                out = fn(batch)
            if slot == "plan" and self.fault is not None:
                out = self.fault(out)
            setattr(self, f"{slot}_out", out)
            if self.routes is not None:
                setattr(self, f"{slot}_routes", self.routes.calls[first:])
            return out
        return run

    def _label(self, fn, name):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if self.marks is not None:
                self.marks.append((name, t0, time.perf_counter()))
            return out
        return run

    def take(self):
        """(plan logits, monolithic logits, plan routing calls, monolithic
        routing calls) of the last request; drops the tap's
        references."""
        out = (self.plan_out, self.mono_out, self.plan_routes,
               self.mono_routes)
        self.plan_out = self.mono_out = None
        self.plan_routes = self.mono_routes = None
        if self.routes is not None:
            self.routes.calls = []
        return out
