"""f32 matrix products of the port, ordered like the JAX package's dots."""

import torch

#: products with fewer rows of `a` than this run padded with zero rows
_MIN_ROWS = 8


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.matmul, except that a product with fewer than 8 rows of `a`
    runs padded to 8: torch computes one or two rows by paths whose sum
    order differs from XLA's dot on the CPU (the JAX package's reference:
    each output a k-order chain of fused multiply-adds), while the matrix
    path matches it bit for bit (tests/test_torch_ops.py)."""
    rows = a.shape[-2]
    if rows >= _MIN_ROWS:
        return torch.matmul(a, b)
    pad = a.new_zeros(a.shape[:-2] + (_MIN_ROWS - rows, a.shape[-1]))
    return torch.matmul(torch.cat([a, pad], dim=-2), b)[..., :rows, :]
