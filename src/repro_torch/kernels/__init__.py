"""Hand-written CUDA kernels for the compute hot spots, their plain PyTorch
versions (``*_plain``), and fp32 oracles (``ref``). The model code reaches
them through ``ops``."""
