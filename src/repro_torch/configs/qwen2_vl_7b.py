from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="qwen2-vl-7b", arch_type="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    qkv_bias=True, activation="silu", mlp_gated=True,
    pos_emb="mrope", mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0, visual_frontend=True,
    source="[arXiv:2409.12191] M-RoPE, dynamic resolution (ViT stub)",
))
