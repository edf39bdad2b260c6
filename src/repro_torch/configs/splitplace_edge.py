"""The paper's own workload family: small image classifiers (MNIST /
FashionMNIST / CIFAR100 over ResNet/MobileNet/Inception class models),
represented here as the split-able MLP family used by repro.core.splitnets.
Registered so the edge simulator and the TPU serving engine share one
config namespace."""
from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="splitplace-edge", arch_type="dense",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=1024, vocab_size=100,                 # 100-way CIFAR100-style output
    activation="gelu_plain", mlp_gated=False, pos_emb="none",
    param_dtype="float32", compute_dtype="float32",
    source="[paper §6.2] AIoTBench-style edge image-recognition apps",
))
