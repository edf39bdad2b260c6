from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="musicgen-medium", arch_type="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    block_pattern=("xattn",),                 # self-attn + cross-attn + mlp
    activation="gelu_plain", mlp_gated=False,
    pos_emb="sinusoidal",
    num_codebooks=4, cross_attention=True, cond_len=64,
    source="[arXiv:2306.05284] decoder-only over EnCodec tokens (frontend stub)",
))
