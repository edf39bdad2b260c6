from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="tinyllama-1.1b", arch_type="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32000, head_dim=64,
    activation="silu", mlp_gated=True, rope_theta=10000.0,
    source="[arXiv:2401.02385] llama2-arch small",
))
