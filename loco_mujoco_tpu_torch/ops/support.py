"""Static tree tables and body-point Jacobians.

Counterpart of `loco_mujoco_tpu/ops/support.py` (mj_jac for the
hinge/slide-only robot suite): dof-chain sparsity is a static mask derived
from the ancestor table, so a Jacobian is one batched cross product times a
mask. The static masks are built once per model with numpy and kept, as
tensors on the model's device, in `Model.cache`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import Data, Model


def cached(model: Model, key, build):
    """Memoize `build()` in the model's static cache under `key`."""
    hit = model.cache.get(key)
    if hit is None:
        hit = model.cache[key] = build()
    return hit


def static_tensor(model: Model, name: str, build, dtype=None) -> torch.Tensor:
    """A numpy table from `build()` as a tensor on the model's device, in
    `dtype` (the model's float dtype by default), built once per model."""
    dev = model.qpos0.device
    dtype = dtype or model.qpos0.dtype
    return cached(model, (name, str(dev), dtype),
                  lambda: torch.as_tensor(np.asarray(build()), dtype=dtype,
                                          device=dev))


def leaf(model: Model, name: str) -> torch.Tensor:
    """A Model leaf with a leading env axis: (E, ...) where it varies per
    env (`Model.varied`), else (1, ...), which broadcasts over every env.
    `mesh_vert` keeps its variant axis (see core/types.py)."""
    x = getattr(model, name)
    return x if name in model.varied else x[None]


def pick(model: Model, name: str, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` (E, k) of a Model leaf's first axis, each env's from its
    own row where the leaf varies per env: (E, k, ...)."""
    x = getattr(model, name)
    if name not in model.varied:
        return x[idx]
    env = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return x[env, idx]


def body_chain_mask(model: Model, bodyid: int) -> np.ndarray:
    """(nv,) bool: dofs on the kinematic chain from `bodyid` to the root."""
    mask = np.zeros(model.nv, dtype=bool)
    b = int(bodyid)
    while b > 0 and model.body_dofnum[b] == 0:
        b = int(model.body_parentid[b])
    if b > 0:
        d = int(model.body_dofadr[b]) + int(model.body_dofnum[b]) - 1
        mask = model.dof_ancestor_mask[d].copy()
    return mask


def body_subtree_mask(model: Model) -> np.ndarray:
    """(nbody, nbody) bool: [a, b] = body b is in the subtree rooted at a."""
    nb = model.nbody
    mask = np.zeros((nb, nb), dtype=bool)
    parent = np.asarray(model.body_parentid)
    for b in range(nb):
        a = b
        while True:
            mask[a, b] = True
            if a == 0:
                break
            a = int(parent[a])
    return mask


def dof_body_mask(model: Model) -> np.ndarray:
    """(nbody, nv) bool: dof d moves body b."""
    mask = np.zeros((model.nbody, model.nv), dtype=bool)
    for b in range(1, model.nbody):
        mask[b] = body_chain_mask(model, b)
    return mask


def jac_dyn(model: Model, data: Data, point: torch.Tensor,
            bodyid: torch.Tensor):
    """Translational and rotational Jacobians of world points attached to
    runtime-selected bodies. point (E, c, 3), bodyid (E, c) int. Returns
    jacp, jacr of shape (E, c, 3, nv)."""
    mask = static_tensor(model, "dof_body_mask",
                         lambda: dof_body_mask(model))[bodyid]  # (E, c, nv)
    roots = np.asarray(model.body_rootid)
    if roots[1:].size and np.all(roots[1:] == roots[1]):
        # single kinematic tree: one static subtree-com reference
        com = data.subtree_com[:, int(roots[1])][:, None, :]
    else:
        root_t = static_tensor(model, "body_rootid", lambda: roots,
                               dtype=torch.int64)
        idx = root_t[bodyid]  # (E, c)
        com = torch.gather(data.subtree_com, 1,
                           idx[..., None].expand(*idx.shape, 3))
    offset = point - com  # (E, c, 3)
    ang = data.cdof[:, None, :, :3]  # (E, 1, nv, 3)
    lin = data.cdof[:, None, :, 3:]
    ox, oy, oz = offset[..., 0:1], offset[..., 1:2], offset[..., 2:3]
    ax, ay, az = ang[..., 0], ang[..., 1], ang[..., 2]  # (E, 1, nv)
    cx = ay * oz - az * oy  # (E, c, nv)
    cy = az * ox - ax * oz
    cz = ax * oy - ay * ox
    m = mask[..., None, :]
    jacp = torch.stack(
        [cx + lin[..., 0], cy + lin[..., 1], cz + lin[..., 2]], dim=-2
    ) * m
    jacr = torch.stack([ax, ay, az], dim=-2).expand_as(jacp) * m
    return jacp, jacr
