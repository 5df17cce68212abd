"""Small-matrix linear algebra on batched tensors, unrolled over columns.

Counterpart of `loco_mujoco_tpu/ops/linalg.py`, with the same arithmetic:
an unrolled column Cholesky whose pivots are floored at 1e-30 (it never
raises on a semi-definite matrix, unlike `torch.linalg.cholesky`) and
unrolled triangular substitutions. All functions take dense matrices with
arbitrary leading batch axes.
"""

from __future__ import annotations

import torch


def cholesky(a: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower-triangular Cholesky factor of an SPD matrix."""
    n = a.shape[-1]
    l = torch.zeros_like(a)
    for j in range(n):
        d = a[..., j, j] - torch.sum(l[..., j, :j] ** 2, dim=-1)
        dj = torch.sqrt(torch.clamp(d, min=1e-30) + jitter)
        l[..., j, j] = dj
        if j + 1 < n:
            col = a[..., j + 1:, j] - torch.einsum(
                "...ik,...k->...i", l[..., j + 1:, :j], l[..., j, :j]
            )
            l[..., j + 1:, j] = col / dj[..., None]
    return l


def solve_lower(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b (L lower triangular) by forward substitution."""
    x = b.clone()
    for i in range(l.shape[-1]):
        xi = x[..., i] - torch.sum(l[..., i, :i] * x[..., :i], dim=-1)
        x[..., i] = xi / l[..., i, i]
    return x


def solve_upper_t(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b by backward substitution."""
    x = b.clone()
    for i in range(l.shape[-1] - 1, -1, -1):
        xi = x[..., i] - torch.sum(l[..., i + 1:, i] * x[..., i + 1:], dim=-1)
        x[..., i] = xi / l[..., i, i]
    return x


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b given the Cholesky factor."""
    return solve_upper_t(l, solve_lower(l, b))


def spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD system a x = b by the unrolled Cholesky."""
    return cho_solve(cholesky(a), b)
