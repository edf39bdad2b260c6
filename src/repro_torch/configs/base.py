"""Unified model configuration covering all assigned architecture families.

One frozen dataclass parameterizes dense / MoE / SSM / hybrid / VLM / audio
decoder stacks.  Every per-architecture file in ``repro_torch.configs`` builds one
of these with the exact public-literature numbers and registers it under its
``--arch`` id.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int              # routed experts
    top_k: int
    d_ff_expert: int              # per-expert hidden size
    num_shared_experts: int = 0
    shared_d_ff: int = 0          # total hidden of the shared expert MLP
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    first_k_dense: int = 0        # leading dense (non-MoE) layers
    dispatch: str = "onehot"      # "onehot" (GShard baseline) | "gather" (optimized)
    group_size: int = 4096        # dispatch group (capacity is per group)


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_kernel: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0            # 0 -> d_model
    conv_kernel: int = 4
    local_window: int = 2048      # sliding window of the hybrid's attn layers
    gate_blocks: int = 16         # block-diagonal input/recurrence gates
                                  # (Griffin's parameterization; 1 = dense)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # layer pattern, tiled to cover num_layers (after first_k_dense prefix)
    block_pattern: Tuple[str, ...] = ("attn",)
    # attention details
    qkv_bias: bool = False
    sliding_window: int = 0       # 0 -> full causal attention
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0    # nemotron uses partial rotary (0.5)
    pos_emb: str = "rope"         # rope | mrope | sinusoidal | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # MLP
    activation: str = "silu"      # silu (gated) | gelu (gated) | gelu_plain | relu2
    mlp_gated: bool = True
    # sub-family configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # multimodal
    num_codebooks: int = 0        # musicgen: decoder over EnCodec token stacks
    cross_attention: bool = False # musicgen conditioning
    cond_len: int = 64            # stub conditioning sequence length
    visual_frontend: bool = False # qwen2-vl: merge precomputed patch embeds
    attn_causal_skip: bool = False  # §Perf: triangular block skipping
    ssm_scan_bf16: bool = False     # §Perf: stream scan inputs in bf16
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # training
    optimizer: str = "adamw"      # adamw | adafactor
    grad_accum: int = 1           # microbatch count inside train_step
    remat: bool = True
    # serving: window used for the long-context sliding-window decode variant
    long_context_window: int = 8192
    source: str = ""              # citation for the config numbers

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def dt_rank(self) -> int:
        assert self.ssm is not None
        return self.ssm.dt_rank or math.ceil(self.d_model / 16)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Fully unrolled per-layer block kinds, length == num_layers."""
        prefix = ()
        n = self.num_layers
        if self.moe is not None and self.moe.first_k_dense:
            prefix = ("attn",) * self.moe.first_k_dense
            n -= self.moe.first_k_dense
        reps = -(-n // len(self.block_pattern))
        body = (self.block_pattern * reps)[:n]
        return prefix + body

    @property
    def scan_segments(self):
        """(prefix_kinds, (period_pattern, num_periods), suffix_kinds).

        The body is scanned over whole pattern periods; any leading dense
        prefix (MoE first_k_dense) and trailing partial period are unrolled.
        """
        kinds = self.layer_kinds
        pre = 0
        if self.moe is not None and self.moe.first_k_dense:
            pre = self.moe.first_k_dense
        body = kinds[pre:]
        p = len(self.block_pattern)
        periods = len(body) // p
        rem = len(body) - periods * p
        suffix = body[len(body) - rem:] if rem else ()
        return kinds[:pre], (self.block_pattern, periods), suffix

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        counts = {
            "embed": self.vocab_size * d * max(1, self.num_codebooks or 1),
            "head": self.vocab_size * d * max(1, self.num_codebooks or 1),
        }
        total = counts["embed"] + (0 if self.tie_embeddings else counts["head"])
        for kind in self.layer_kinds:
            total += self._block_params(kind, d, hd)
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k routed only)."""
        if self.moe is None:
            return self.param_count()
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds:
            if kind == "attn_moe":
                total += self._attn_params(d, hd)
                m = self.moe
                total += d * m.num_experts  # router
                total += 3 * d * m.d_ff_expert * m.top_k
                if m.num_shared_experts:
                    total += 3 * d * m.shared_d_ff
                total += 2 * d
            else:
                total += self._block_params(kind, d, hd)
        total += d
        return total

    def _attn_params(self, d, hd):
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        b = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + b

    def _mlp_params(self, d, d_ff):
        return (3 if self.mlp_gated else 2) * d * d_ff

    def _block_params(self, kind, d, hd):
        norms = 2 * d
        if kind == "attn":
            return self._attn_params(d, hd) + self._mlp_params(d, self.d_ff) + norms
        if kind == "local_attn":
            return self._attn_params(d, hd) + self._mlp_params(d, self.d_ff) + norms
        if kind == "xattn":
            return 2 * self._attn_params(d, hd) + self._mlp_params(d, self.d_ff) + 3 * d
        if kind == "attn_moe":
            m = self.moe
            p = self._attn_params(d, hd) + norms + d * m.num_experts
            p += m.num_experts * 3 * d * m.d_ff_expert
            if m.num_shared_experts:
                p += 3 * d * m.shared_d_ff
            return p
        if kind == "mamba":
            s = self.ssm
            d_in = s.expand * d
            p = d * 2 * d_in                       # in_proj
            p += d_in * s.conv_kernel + d_in       # conv + bias
            p += d_in * (self.dt_rank + 2 * s.state_dim)  # x_proj
            p += self.dt_rank * d_in + d_in        # dt_proj
            p += d_in * s.state_dim + d_in         # A_log, D
            p += d_in * d                          # out_proj
            return p + d                           # norm
        if kind == "rglru":
            r = self.rglru
            w = r.lru_width or d
            p = d * w * 2                          # x & gate projections
            p += w * r.conv_kernel + w             # conv
            gb = max(1, r.gate_blocks)
            p += 2 * (w * w // gb + w)             # block-diag gates
            p += w                                 # Lambda
            p += w * d                             # out proj
            return p + self._mlp_params(d, self.d_ff) + 2 * d
        raise ValueError(kind)

    def reduced(self, max_d_model: int = 256, max_layers: int = 2,
                max_experts: int = 4, vocab: int = 128) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        d = min(self.d_model, max_d_model)
        hd = 32
        heads = max(2, d // 64)
        kv = max(1, min(self.num_kv_heads, heads // 2)) if self.num_kv_heads < self.num_heads else heads
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, max_experts),
                top_k=min(self.moe.top_k, 2), d_ff_expert=d,
                shared_d_ff=d if self.moe.num_shared_experts else 0,
                first_k_dense=min(self.moe.first_k_dense, 1),
                capacity_factor=4.0)  # lossless routing for smoke tests
        layers = max_layers
        if self.moe is not None and self.moe.first_k_dense:
            layers = max_layers + 1
        if len(self.block_pattern) > 1:
            layers = len(self.block_pattern) + 1  # one full period + remainder
        half = hd // 2
        t = max(1, half // 4)
        sections = (t, (half - t) // 2, half - t - (half - t) // 2)
        return dataclasses.replace(
            self, num_layers=layers, d_model=d, num_heads=heads,
            num_kv_heads=kv, head_dim=hd, d_ff=2 * d, vocab_size=vocab,
            moe=moe, mrope_sections=sections,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            rglru=dataclasses.replace(self.rglru, lru_width=d, local_window=8) if self.rglru else None,
            param_dtype="float32", compute_dtype="float32",
            grad_accum=1, cond_len=4,
        )


_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import side-effect registration
    from repro_torch import configs as _c  # noqa: F401
    _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs():
    from repro_torch import configs as _c
    _c.load_all()
    return dict(_REGISTRY)
