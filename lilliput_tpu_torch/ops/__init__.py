"""Dense device stages of the port (torch), and its CUDA kernels."""
