from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="nemotron-4-340b", arch_type="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000, head_dim=192,
    activation="relu2", mlp_gated=False,      # squared-ReLU, ungated MLP
    rope_fraction=0.5,                        # partial rotary
    optimizer="adafactor", grad_accum=8,
    source="[arXiv:2402.16819] GQA kv=8, squared-ReLU",
))
