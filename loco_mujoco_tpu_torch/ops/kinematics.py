"""Position stage: forward kinematics and com-centered quantities.

Counterpart of `loco_mujoco_tpu/ops/kinematics.py` (mj_kinematics,
mj_comPos) for hinge/slide joints (nq == nv, no quaternion state). The body
recursion advances level by level of the kinematic tree, all bodies of one
depth together, over a leading env axis E.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import Data, JointType, Model
from . import math as m3
from .support import body_subtree_mask, cached, leaf, static_tensor


def _levels(model: Model):
    """Bodies grouped by tree depth (static, parent-before-child)."""

    def build():
        parent = np.asarray(model.body_parentid)
        depth = np.zeros(model.nbody, dtype=int)
        for b in range(1, model.nbody):
            depth[b] = depth[parent[b]] + 1
        if model.nbody <= 1:
            return []
        return [np.where(depth == L)[0] for L in range(1, int(depth.max()) + 1)]

    return cached(model, "body_levels", build)


def _rotate(model: Model, name: str, R: torch.Tensor) -> torch.Tensor:
    """R (E, n, 3, 3) times the local offsets of leaf `name` (n, 3), each
    env's own where the leaf varies per env."""
    if name in model.varied:
        return torch.einsum("ebij,ebj->ebi", R, getattr(model, name))
    return torch.einsum("ebij,bj->ebi", R, getattr(model, name))


def kinematics(model: Model, data: Data) -> Data:
    """Body, geom and site frames; joint anchors and axes."""
    qpos = data.qpos
    E, dt, dev = qpos.shape[0], qpos.dtype, qpos.device
    nb, nj = model.nbody, model.njnt
    parent = np.asarray(model.body_parentid)
    jadr = np.asarray(model.body_jntadr)
    jnum = np.asarray(model.body_jntnum)
    jtype = np.asarray(model.jnt_type)
    qadr = np.asarray(model.jnt_qposadr)

    xpos = torch.zeros((E, nb, 3), dtype=dt, device=dev)
    xquat = torch.zeros((E, nb, 4), dtype=dt, device=dev)
    xquat[..., 0] = 1.0
    xanchor = torch.zeros((E, nj, 3), dtype=dt, device=dev)
    xaxis = torch.zeros((E, nj, 3), dtype=dt, device=dev)

    body_pos, body_quat = leaf(model, "body_pos"), leaf(model, "body_quat")
    jnt_pos = leaf(model, "jnt_pos")
    for bs in _levels(model):
        pids = parent[bs]
        pos = xpos[:, pids] + m3.quat_rotate(xquat[:, pids], body_pos[:, bs])
        quat = m3.quat_mul(xquat[:, pids], body_quat[:, bs])
        maxj = int(jnum[bs].max()) if nj else 0
        for i in range(maxj):
            sel = np.where(jnum[bs] > i)[0]  # level rows with a joint i
            js = jadr[bs[sel]] + i
            jp, ja = jnt_pos[:, js], model.jnt_axis[js]
            pos_s, quat_s = pos[:, sel], quat[:, sel]
            anchor = pos_s + m3.quat_rotate(quat_s, jp)
            axis = m3.quat_rotate(quat_s, ja)
            xanchor[:, js] = anchor
            xaxis[:, js] = axis
            qd = (qpos[:, qadr[js]] - model.qpos0[qadr[js]])[..., None]
            is_slide = torch.as_tensor(
                jtype[js] == int(JointType.SLIDE), device=dev
            )[:, None]
            pos_slide = pos_s + axis * qd
            quat_h = m3.quat_mul(quat_s, m3.axis_angle_to_quat(ja, qd[..., 0]))
            pos_h = anchor - m3.quat_rotate(quat_h, jp)
            pos[:, sel] = torch.where(is_slide, pos_slide, pos_h)
            quat[:, sel] = torch.where(is_slide, quat_s, quat_h)
        xpos[:, bs] = pos
        xquat[:, bs] = quat

    xmat = m3.quat_to_mat(xquat)
    xipos = xpos + m3.quat_rotate(xquat, model.body_ipos)
    ximat = xmat @ m3.quat_to_mat(model.body_iquat)

    gb = np.asarray(model.geom_bodyid)
    geom_xpos = xpos[:, gb] + _rotate(model, "geom_pos", xmat[:, gb])
    geom_xmat = xmat[:, gb] @ m3.quat_to_mat(model.geom_quat)

    if model.nsite:
        sb = np.asarray(model.site_bodyid)
        site_xpos = xpos[:, sb] + _rotate(model, "site_pos", xmat[:, sb])
        site_xmat = xmat[:, sb] @ m3.quat_to_mat(model.site_quat)
    else:
        site_xpos = torch.zeros((E, 0, 3), dtype=dt, device=dev)
        site_xmat = torch.zeros((E, 0, 3, 3), dtype=dt, device=dev)

    return data.replace(
        xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
        xanchor=xanchor, xaxis=xaxis, geom_xpos=geom_xpos,
        geom_xmat=geom_xmat, site_xpos=site_xpos, site_xmat=site_xmat,
    )


def com_pos(model: Model, data: Data) -> Data:
    """Subtree com, com-centered packed inertias (cinert) and dof motion
    vectors (cdof), in MuJoCo's mj_comPos conventions."""
    sub = static_tensor(model, "body_subtree_mask",
                        lambda: body_subtree_mask(model))
    if "body_mass" in model.varied:  # (E, nbody)
        mass = model.body_mass
        submass = mass @ sub.T
    else:
        mass = model.body_mass[None]
        submass = (sub @ model.body_mass)[None]
    weighted = torch.einsum("ab,ebc->eac", sub, mass[..., None] * data.xipos)
    subtree_com = weighted / torch.clamp(submass, min=1e-12)[..., None]

    root = np.asarray(model.body_rootid)
    center = subtree_com[:, root]  # (E, nbody, 3)

    R = data.ximat
    Idiag = leaf(model, "body_inertia")
    c = data.xipos - center
    c2 = torch.sum(c * c, dim=-1)

    def iw(i, k):
        v = (
            R[..., i, 0] * Idiag[..., 0] * R[..., k, 0]
            + R[..., i, 1] * Idiag[..., 1] * R[..., k, 1]
            + R[..., i, 2] * Idiag[..., 2] * R[..., k, 2]
        )
        shift = mass * ((c2 if i == k else 0.0) - c[..., i] * c[..., k])
        return (v + shift)[..., None]

    mm = mass[..., None].expand_as(c[..., :1])
    cinert = torch.cat(
        [iw(0, 0), iw(1, 1), iw(2, 2), iw(0, 1), iw(0, 2), iw(1, 2),
         mass[..., None] * c, mm],
        dim=-1,
    )

    jb = np.asarray(model.jnt_bodyid)
    axis = data.xaxis
    offset = center[:, jb] - data.xanchor
    hinge = torch.as_tensor(
        np.asarray(model.jnt_type) == int(JointType.HINGE), device=axis.device
    )[:, None]
    ang = torch.where(hinge, axis, torch.zeros_like(axis))
    lin = torch.where(hinge, m3.cross(axis, offset), axis)
    cdof = torch.cat([ang, lin], dim=-1)
    return data.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)
