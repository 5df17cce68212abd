"""Trajectory engine: dataset loading, resampling, and sampling on the
device.

Counterpart of `loco_mujoco_tpu/datasets/trajectory.py` (reference
`loco_mujoco/utils/trajectory.py`). On the host (numpy and scipy, once at
env build): the per-key arrays (`traj_files`, keyed by observation names,
with optional `split_points` and `goal*` keys) are checked against the
joint ranges, split into trajectories of equal length, cubically resampled
from traj_dt to control_dt with scipy's `interp1d(kind="cubic")`
(trajectory.py:228-254), and packed into one flat (n_traj, T, sample_dim)
tensor on the device whose columns follow the observation spec (plus
trailing goal keys). Not ported: the JAX package's native C++ resampler
(its first choice, with scipy as its fallback and oracle; ROADMAP Queue 1
#7), the robots' interpolation map / remap hooks, loading from a path,
clipping to the joint ranges, ignored keys, per-trajectory labels and
trajectories of unequal length (the preference datasets' padding).

On the device: a reset sample is a gather `flat[traj_no, step]` with the
global x/y columns zeroed, for a whole batch at once; `sample_reset` draws
(traj_no, step) from an explicit `torch.Generator`.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch
from scipy import interpolate

from ..core.io import resolve_device


class TrajectoryData:
    def __init__(
        self,
        keys: Sequence[str],
        key_dims: Sequence[int],
        traj_files: dict,
        traj_dt: float = 0.002,
        control_dt: float = 0.01,
        low: np.ndarray | None = None,
        high: np.ndarray | None = None,
        joint_pos_idx: Sequence[int] | None = None,
        warn: bool = True,
        dtype=torch.float32,
        device=None,
    ):
        files = dict(traj_files)
        device = resolve_device(device)
        keys = list(keys)
        key_dims = list(key_dims)

        # joint-range check (trajectory.py:120-146)
        if warn and low is not None:
            j_idx = list(joint_pos_idx)[2:]
            highs = dict(zip(keys[2:], high))
            lows = dict(zip(keys[2:], low))
            for i, (k, d) in enumerate(files.items()):
                if i in j_idx and k in keys:
                    if np.max(d) > highs[k]:
                        warnings.warn(
                            f"Trajectory violates joint range in {k}. "
                            f"Max {np.max(d)} > {highs[k]}.", RuntimeWarning)
                    elif np.min(d) < lows[k]:
                        warnings.warn(
                            f"Trajectory violates joint range in {k}. "
                            f"Min {np.min(d)} < {lows[k]}.", RuntimeWarning)

        # goal keys are appended automatically (trajectory.py:148-153)
        for k in files:
            if k.startswith("goal") and k not in keys:
                keys.append(k)
                v = np.asarray(files[k])
                key_dims.append(1 if v.ndim == 1
                                else int(np.prod(v.shape[1:])))
        self.keys = keys
        self.key_dims = key_dims

        n_samples = len(np.asarray(files[keys[0]]))
        if "split_points" in files:
            split_points = np.asarray(files["split_points"]).astype(int)
        else:
            split_points = np.array([0, n_samples])

        lens = np.diff(split_points)
        if len(set(lens)) > 1:
            raise NotImplementedError(
                "trajectories of unequal length are not ported")
        per_key = [np.stack(np.split(
            np.asarray(files[k], dtype=np.float64).reshape(n_samples, -1),
            split_points[1:-1])) for k in keys]  # (n_traj, len, dim) each

        self.traj_dt = traj_dt
        self.control_dt = control_dt
        if traj_dt != control_dt:
            per_key = self._interpolate(per_key)
        self.n_traj, self.traj_len = per_key[0].shape[:2]
        flat = np.concatenate(per_key, axis=-1)  # (n_traj, T, sample_dim)
        self.sample_dim = flat.shape[-1]
        self.flat = torch.as_tensor(flat, dtype=dtype, device=device)

    # ---- host-side interpolation (trajectory.py:228-254) ------------------
    def _interpolate(self, per_key):
        n_traj, tlen = per_key[0].shape[:2]
        factor = self.traj_dt / self.control_dt
        x = np.arange(tlen)
        x_new = np.linspace(0, tlen - 1, round(tlen * factor), endpoint=True)
        out = [[] for _ in per_key]
        for t in range(n_traj):
            traj = np.asarray([p[t, :, 0] if p.shape[-1] == 1 else p[t]
                               for p in per_key])
            new = interpolate.interp1d(x, traj, kind="cubic", axis=1)(x_new)
            for i in range(len(per_key)):
                arr = np.asarray(new[i])
                out[i].append(arr.reshape(arr.shape[0], -1))
        return [np.stack(o) for o in out]

    # ---- sampling on the device (trajectory.py:257-284) -------------------
    def sample_reset(self, generator: torch.Generator, n: int):
        """n random (traj, step) reset samples with x/y recentred to zero,
        drawn from `generator` (on the data's device). Returns (sample (n,
        sample_dim), traj_no (n,), step (n,))."""
        dev = self.flat.device
        traj_no = torch.randint(0, self.n_traj, (n,), generator=generator,
                                device=dev)
        step = torch.randint(0, self.traj_len, (n,), generator=generator,
                             device=dev)
        return self.sample_at(traj_no, step)

    def sample_at(self, traj_no: torch.Tensor, step: torch.Tensor):
        """The samples at (traj_no, step), each (n,), the global x/y
        columns (0, 1) zeroed."""
        sample = self.flat[traj_no, step].clone()
        sample[:, :2] = 0.0
        return sample, traj_no.to(torch.int32), step.to(torch.int32)
