from repro_torch.configs.base import ModelConfig, SSMConfig, register

register(ModelConfig(
    name="falcon-mamba-7b", arch_type="ssm",
    num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=65024,
    block_pattern=("mamba",), pos_emb="none",
    ssm=SSMConfig(state_dim=16, conv_kernel=4, expand=2),
    grad_accum=4,
    source="[arXiv:2410.05355] mamba1 arch, attn-free, ssm_state=16",
))
