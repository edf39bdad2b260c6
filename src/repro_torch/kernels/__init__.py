"""Hand-written CUDA kernels of the port and their eager PyTorch twins."""
