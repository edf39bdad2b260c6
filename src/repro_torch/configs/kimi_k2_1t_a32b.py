from repro_torch.configs.base import ModelConfig, MoEConfig, register

register(ModelConfig(
    name="kimi-k2-1t-a32b", arch_type="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=18432, vocab_size=163840, head_dim=112,
    block_pattern=("attn_moe",),
    activation="silu", mlp_gated=True,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, shared_d_ff=2048,
                  first_k_dense=1),
    optimizer="adafactor", grad_accum=8,
    source="[arXiv:2501.kimi2] trillion-param MoE 384e top-8",
))
