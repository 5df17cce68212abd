"""Spatial tendons: length, moment-arm Jacobian and velocity.

Counterpart of `loco_mujoco_tpu/ops/tendon.py` (`:31-128`) over a leading
env axis E: site-path spatial tendons (core/io refuses anything else). A
tendon's length is the sum of its segments' lengths; its Jacobian row is
u . (J_B - J_A) over each segment A -> B with unit direction u, from the
endpoint sites' dof chains without a point-Jacobian tensor:

    u . (J_B - J_A)[v] = mask_B[v] (cdof_ang[v] . (off_B x u)
                                    + cdof_lin[v] . u)  -  (same for A)

where off is the site's offset from the root subtree com.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import Data, Model
from . import math as m3
from .support import cached, dof_body_mask, static_tensor


def site_path_tables(tendon_site, tendon_sitemask, site_bodyid, chain):
    """(site_ids, GA, GB, S, maskA, maskB) of site-path tendons: the sites
    on tendon paths, the (nseg, nsite) selections of each segment's first
    and second site, the (ntendon, nseg) segment -> tendon sum and the
    (nseg, nv) dof chains of each segment's endpoints (`chain`: (nbody, nv)
    the dofs that move each body; reference tendon.py:31-84)."""
    tendon_site = np.asarray(tendon_site)
    tendon_sitemask = np.asarray(tendon_sitemask, dtype=bool)
    site_ids = np.unique(tendon_site[tendon_sitemask])
    slot = {int(s): i for i, s in enumerate(site_ids)}
    mask = np.asarray(chain)[np.asarray(site_bodyid)[site_ids]]
    segs_t, segs_a, segs_b = [], [], []
    for t in range(len(tendon_site)):
        path = tendon_site[t][tendon_sitemask[t]]
        for k in range(len(path) - 1):
            segs_t.append(t)
            segs_a.append(slot[int(path[k])])
            segs_b.append(slot[int(path[k + 1])])
    nseg, ns = len(segs_t), len(site_ids)
    GA, GB = np.zeros((nseg, ns)), np.zeros((nseg, ns))
    GA[np.arange(nseg), segs_a] = 1.0
    GB[np.arange(nseg), segs_b] = 1.0
    S = np.zeros((len(tendon_site), nseg))
    S[segs_t, np.arange(nseg)] = 1.0
    return (site_ids, GA, GB, S, mask[segs_a].astype(np.float64),
            mask[segs_b].astype(np.float64))


def _tendon_statics(model: Model):
    return cached(model, "tendon_statics", lambda: site_path_tables(
        model.tendon_site, model.tendon_sitemask, model.site_bodyid,
        dof_body_mask(model)))


def tendon(model: Model, data: Data) -> Data:
    """Tendon lengths and Jacobians (ten_length, ten_J)."""
    if model.ntendon == 0:
        return data
    site_ids, *tabs = _tendon_statics(model)
    GA, GB, S, mA, mB = (static_tensor(model, f"tendon_{n}", lambda t=t: t)
                         for n, t in zip(("GA", "GB", "S", "mA", "mB"), tabs))
    pos = data.site_xpos[:, site_ids]  # (E, ns, 3)
    root = model.body_rootid[model.site_bodyid[site_ids]]
    off = pos - data.subtree_com[:, root]
    d = GB @ pos - GA @ pos  # (E, nseg, 3)
    norm = torch.linalg.norm(d, dim=-1, keepdim=True)
    vec = d / torch.clamp(norm, min=1e-12)
    ang, lin = data.cdof[..., :3], data.cdof[..., 3:]  # (E, nv, 3)
    cA = m3.cross(GA @ off, vec)
    cB = m3.cross(GB @ off, vec)
    lin_term = vec @ lin.transpose(1, 2)  # (E, nseg, nv)
    seg_jac = (mB * (cB @ ang.transpose(1, 2) + lin_term)
               - mA * (cA @ ang.transpose(1, 2) + lin_term))
    return data.replace(ten_length=(S @ norm)[..., 0], ten_J=S @ seg_jac)


def tendon_vel(model: Model, data: Data) -> Data:
    """Tendon velocities ten_J qvel."""
    if model.ntendon == 0:
        return data
    return data.replace(
        ten_velocity=torch.einsum("etv,ev->et", data.ten_J, data.qvel))
