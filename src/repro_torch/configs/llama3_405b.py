from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="llama3-405b", arch_type="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256, head_dim=128,
    activation="silu", mlp_gated=True, rope_theta=500000.0,
    optimizer="adafactor", grad_accum=8,
    source="[arXiv:2407.21783] GQA, 128k vocab",
))
