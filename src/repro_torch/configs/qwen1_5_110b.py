from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="qwen1.5-110b", arch_type="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=49152, vocab_size=152064, head_dim=128,
    qkv_bias=True, activation="silu", mlp_gated=True,
    rope_theta=1_000_000.0,
    optimizer="adafactor", grad_accum=8,
    source="[hf:Qwen/Qwen1.5-0.5B] scaled per assignment: QKV bias, GQA kv=8",
))
