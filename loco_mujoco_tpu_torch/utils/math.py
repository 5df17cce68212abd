"""Math utilities: the JAX package's `utils/math.py` (reference
`loco_mujoco/utils/math.py` plus the mushroom-rl euler helpers it imports),
in numpy for the host and in torch for batched tensors. Euler convention:
intrinsic XYZ (R = Rx @ Ry @ Rz), as mushroom_rl.utils.angles.
"""

from __future__ import annotations

import numpy as np
import torch


def euler_to_mat(euler):
    """Intrinsic XYZ euler -> rotation matrix (host, numpy)."""
    a, b, c = euler
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cc, sc = np.cos(c), np.sin(c)
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    return rx @ ry @ rz


def mat_to_euler(mat):
    """Rotation matrix -> intrinsic XYZ euler (host, numpy)."""
    m = np.asarray(mat).reshape(3, 3)
    beta = np.arcsin(np.clip(m[0, 2], -1.0, 1.0))
    alpha = np.arctan2(-m[1, 2], m[2, 2])
    gamma = np.arctan2(-m[0, 1], m[0, 0])
    return np.array([alpha, beta, gamma])


def mat2angle_xy(mat):
    """Rotation matrix (flat 9 or 3x3) -> angle in the x-y plane
    (reference math.py:33-47: the z euler angle)."""
    m = np.asarray(mat).reshape(3, 3)
    return float(np.arctan2(-m[0, 1], m[0, 0]))


def angle2mat_xy(angle):
    """Angle in x-y plane -> rotation matrix (reference math.py:50-64)."""
    return euler_to_mat(np.array([0.0, 0.0, angle]))


def transform_angle_2pi(angle):
    """Wrap angle into [-pi, pi] (reference math.py:67-78); numpy arrays
    and torch tensors alike."""
    return (angle + np.pi) % (2 * np.pi) - np.pi


def mat2angle_xy_torch(mat: torch.Tensor) -> torch.Tensor:
    """Batched mat2angle_xy; mat is (..., 9) or (..., 3, 3)."""
    m = mat.reshape(*mat.shape[:-1], 3, 3) if mat.shape[-1] == 9 else mat
    return torch.atan2(-m[..., 0, 1], m[..., 0, 0])


def rotate_obs(state, angle, idx_rot, idx_xvel, idx_yvel):
    """Rotate a state around the vertical axis (reference math.py:5-30): a
    numpy state (its last axis) or a batched tensor (E, D) with angles
    (E,)."""
    if isinstance(state, torch.Tensor):
        out = state.clone()
        out[..., idx_rot] = transform_angle_2pi(state[..., idx_rot] + angle)
        xv, yv = state[..., idx_xvel], state[..., idx_yvel]
        c, s = torch.cos(angle), torch.sin(angle)
        out[..., idx_xvel] = c * xv - s * yv
        out[..., idx_yvel] = s * xv + c * yv
        return out
    out = np.array(state, copy=True)
    xv, yv = state[..., idx_xvel], state[..., idx_yvel]
    out[..., idx_rot] = transform_angle_2pi(state[..., idx_rot] + angle)
    out[..., idx_xvel] = np.cos(angle) * xv - np.sin(angle) * yv
    out[..., idx_yvel] = np.sin(angle) * xv + np.cos(angle) * yv
    return out
