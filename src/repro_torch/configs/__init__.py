"""Architecture registry (a copy of the reference's ``configs`` package,
which is data).  Each module registers exactly one ModelConfig."""
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

