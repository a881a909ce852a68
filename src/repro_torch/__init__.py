"""PyTorch/CUDA port of the accuracy-aware workload-distribution system."""
