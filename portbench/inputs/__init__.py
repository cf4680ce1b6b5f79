"""portbench: the benchmark of the PyTorch and CUDA port."""
