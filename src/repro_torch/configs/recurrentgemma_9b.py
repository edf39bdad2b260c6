from repro_torch.configs.base import ModelConfig, RGLRUConfig, register

register(ModelConfig(
    name="recurrentgemma-9b", arch_type="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "local_attn"),   # 1 attn : 2 recurrent
    activation="gelu", mlp_gated=True,
    rglru=RGLRUConfig(lru_width=4096, conv_kernel=4, local_window=2048),
    grad_accum=4,
    source="[arXiv:2402.19427] RG-LRU + local attn, 1:2, GQA kv=1",
))
