"""f32 matrix products of the port, ordered like the JAX package's dots."""

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.matmul, except that a product with ONE row of `a` runs as a
    two-row product: torch computes a single row as a matrix-vector product
    whose sum order differs from XLA's dot on the CPU (the JAX package's
    reference), while the matrix path matches it bit for bit."""
    if a.shape[-2] != 1:
        return torch.matmul(a, b)
    a2 = torch.cat([a, torch.zeros_like(a)], dim=-2)
    return torch.matmul(a2, b)[..., :1, :]
