"""Reward library: the JAX package's `rewards/rewards.py` (reference
`loco_mujoco/utils/reward.py:5-117`) over batches.

Each reward is a function `(state, action, next_state, env_info) -> (E,)`
of the batch's observations (E, obs_dim), actions (E, nu) and a dict of
per-env extra inputs the env provides (goal angle and speed (E,), the
model variant id (E,)). A custom callback takes the same batched tensors.
"""

from __future__ import annotations

from typing import Callable

import torch

RewardFn = Callable[..., torch.Tensor]


def NoReward():
    """reward.py:34: always zero."""

    def fn(state, action, next_state, info):
        return torch.zeros(next_state.shape[0], dtype=next_state.dtype,
                           device=next_state.device)

    return fn


def PosReward(pos_idx: int):
    """reward.py:44: the value of one observation entry (e.g. x velocity)."""

    def fn(state, action, next_state, info):
        return next_state[:, pos_idx]

    return fn


def CustomReward(reward_callback):
    """reward.py:54-63: a user callback on the batch."""

    def fn(state, action, next_state, info):
        return reward_callback(state, action, next_state)

    return fn


def TargetVelocityReward(x_vel_idx: int, target_velocity: float):
    """reward.py:66-74: exp(-(vx - v*)^2)."""

    def fn(state, action, next_state, info):
        d = next_state[:, x_vel_idx] - target_velocity
        return torch.exp(-torch.square(d))

    return fn


def MultiTargetVelocityReward(x_vel_idx: int, target_velocities,
                              env_id_len: int):
    """reward.py:77-97: per-model target velocity selected by the env's
    model variant id (`info["env_id"]`, an integer per env)."""

    def fn(state, action, next_state, info):
        tv = torch.as_tensor(target_velocities, dtype=next_state.dtype,
                             device=next_state.device)
        d = next_state[:, x_vel_idx] - tv[info["env_id"].long()]
        return torch.exp(-torch.square(d))

    return fn


def VelocityVectorReward(x_vel_idx: int, y_vel_idx: int):
    """reward.py:100-117: exp(-5 ||v_xy - v* (cos a, sin a)||), the goal
    angle and speed from `info["goal_angle"]` / `info["goal_vel"]`."""

    def fn(state, action, next_state, info):
        angle, speed = info["goal_angle"], info["goal_vel"]
        target = speed[:, None] * torch.stack(
            [torch.cos(angle), torch.sin(angle)], dim=1)
        cur = next_state[:, [x_vel_idx, y_vel_idx]]
        return torch.exp(-5.0 * torch.linalg.vector_norm(cur - target, dim=1))

    return fn


def make_reward(reward_type: str, reward_params: dict | None, defaults: dict):
    """Reward factory (reference base.py:681-711); `defaults` supplies the
    env's indices."""
    reward_params = dict(reward_params or {})
    if reward_type == "no_reward" or reward_type is None:
        return NoReward()
    if reward_type in ("x_pos", "x_vel"):
        return PosReward(reward_params.get(
            "pos_idx", defaults.get(f"{reward_type}_idx")))
    if reward_type == "custom":
        return CustomReward(reward_params["reward_callback"])
    if reward_type == "target_velocity":
        return TargetVelocityReward(defaults["x_vel_idx"],
                                    reward_params["target_velocity"])
    if reward_type == "multi_target_velocity":
        return MultiTargetVelocityReward(
            defaults["x_vel_idx"], reward_params["target_velocities"],
            reward_params.get("env_id_len", 0))
    if reward_type == "velocity_vector":
        return VelocityVectorReward(defaults["x_vel_idx"],
                                    defaults["y_vel_idx"])
    raise NotImplementedError(f"reward type {reward_type!r}")
