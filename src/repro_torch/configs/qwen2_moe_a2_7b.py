from repro_torch.configs.base import ModelConfig, MoEConfig, register

register(ModelConfig(
    name="qwen2-moe-a2.7b", arch_type="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128,
    block_pattern=("attn_moe",),
    qkv_bias=True, activation="silu", mlp_gated=True,
    moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                  num_shared_experts=4, shared_d_ff=5632),
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B] 4 shared + 60 routed top-4",
))
