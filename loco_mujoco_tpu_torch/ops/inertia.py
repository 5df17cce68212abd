"""Inertia stage: composite-rigid-body mass matrix and its factorization.

Counterpart of `loco_mujoco_tpu/ops/inertia.py` (mj_crb, mj_factorM),
dense over a leading env axis: the tree sparsity of the mass matrix is a
static ancestor mask, and the subtree accumulation one masked product.
"""

from __future__ import annotations

import torch

from ..core.types import Data, Model
from . import linalg
from . import math as m3
from .support import body_subtree_mask, static_tensor


def crb(model: Model, data: Data) -> Data:
    """Dense joint-space mass matrix qM (+ armature, each env's where it
    varies per env)."""
    sub = static_tensor(model, "body_subtree_mask",
                        lambda: body_subtree_mask(model))
    crb_arr = torch.einsum("ab,ebt->eat", sub, data.cinert)  # (E, nbody, 10)
    buf = m3.inert_mul(crb_arr[:, model.dof_bodyid], data.cdof)  # (E, nv, 6)
    m_full = buf @ data.cdof.transpose(-1, -2)  # (E, nv, nv)
    mask = static_tensor(model, "dof_ancestor_mask",
                         lambda: model.dof_ancestor_mask, dtype=torch.bool)
    lower = torch.where(mask, m_full, torch.zeros_like(m_full))
    qm = (lower + lower.transpose(-1, -2)
          - torch.diag_embed(torch.diagonal(lower, dim1=-2, dim2=-1)))
    if "dof_armature" in model.varied:  # each env's (E, nv)
        return data.replace(qM=qm + torch.diag_embed(model.dof_armature))
    qm = qm + torch.diag(model.dof_armature)
    return data.replace(qM=qm)


def factor_m(model: Model, data: Data) -> Data:
    """Cholesky factor of qM (dense; MuJoCo's qLD plays this role)."""
    return data.replace(qLD=linalg.cholesky(data.qM))


def solve_m(model: Model, data: Data, x: torch.Tensor) -> torch.Tensor:
    """Solve qM y = x with the cached factor. x: (E, nv)."""
    return linalg.cho_solve(data.qLD, x)


def mul_m(model: Model, data: Data, x: torch.Tensor) -> torch.Tensor:
    """qM @ x. x: (E, nv)."""
    return (data.qM @ x[..., None])[..., 0]
