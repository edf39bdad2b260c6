"""Architecture registry (a copy of the reference's ``configs`` package,
which is data).  Each module registers exactly one ModelConfig;
``ASSIGNED_ARCHS`` and ``INPUT_SHAPES`` are the dry-run's architectures
and named input shapes."""
import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, RGLRUConfig,
    get_config, all_configs, register,
)

_ARCH_MODULES = [
    "qwen1_5_110b",
    "recurrentgemma_9b",
    "musicgen_medium",
    "qwen2_moe_a2_7b",
    "tinyllama_1_1b",
    "nemotron_4_340b",
    "falcon_mamba_7b",
    "qwen2_vl_7b",
    "kimi_k2_1t_a32b",
    "llama3_405b",
    "splitplace_edge",
]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    _loaded = True
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")



ASSIGNED_ARCHS = [
    "qwen1.5-110b", "recurrentgemma-9b", "musicgen-medium", "qwen2-moe-a2.7b",
    "tinyllama-1.1b", "nemotron-4-340b", "falcon-mamba-7b", "qwen2-vl-7b",
    "kimi-k2-1t-a32b", "llama3-405b",
]

INPUT_SHAPES = {
    "train_4k":    dict(seq_len=4096,   global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768,  global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32768,  global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524288, global_batch=1,   kind="decode"),
}
