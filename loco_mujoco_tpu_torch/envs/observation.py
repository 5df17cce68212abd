"""Observation-spec compiler.

Counterpart of `loco_mujoco_tpu/envs/observation.py`: the reference's list
of (key, mujoco-name, type) entries is compiled once into static gather
indices, and building the observations of a batch is one gather per kind
and one column permutation. Types: JOINT_POS, JOINT_VEL, SITE_ROT.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.types import Data, Model


class ObservationType(enum.IntEnum):
    JOINT_POS = 0
    JOINT_VEL = 1
    SITE_ROT = 2


class ObsEntry(NamedTuple):
    key: str
    name: str
    otype: ObservationType


class ObsIndex:
    """Compiled observation spec: static gather tables + entry layout
    (observation.py:38-87)."""

    def __init__(self, model: Model, spec: Sequence[ObsEntry]):
        self.spec = [ObsEntry(k, n, ObservationType(t)) for k, n, t in spec]
        jmap = model.names["joint"]
        smap = model.names["site"]

        qpos_idx, qvel_idx, site_idx = [], [], []
        layout = []  # (key, otype, offset, size)
        offset = 0
        for key, name, ot in self.spec:
            if ot == ObservationType.JOINT_POS:
                qpos_idx.append(int(model.jnt_qposadr[jmap[name]]))
                layout.append((key, ot, offset, 1))
                offset += 1
            elif ot == ObservationType.JOINT_VEL:
                qvel_idx.append(int(model.jnt_dofadr[jmap[name]]))
                layout.append((key, ot, offset, 1))
                offset += 1
            elif ot == ObservationType.SITE_ROT:
                site_idx.append(smap[name])
                layout.append((key, ot, offset, 9))
                offset += 9
            else:
                raise NotImplementedError(ot)
        self.qpos_idx = np.asarray(qpos_idx, dtype=np.int64)
        self.qvel_idx = np.asarray(qvel_idx, dtype=np.int64)
        self.site_idx = np.asarray(site_idx, dtype=np.int64)
        self.layout = layout
        self.size = offset
        self.obs_idx_map = {
            key: list(range(off, off + size)) for key, ot, off, size in layout
        }
        # the column of each observation entry in [qpos parts, qvel parts,
        # site parts] order, and the sample columns sample_to_state reads
        cols = {ObservationType.JOINT_POS: [], ObservationType.JOINT_VEL: [],
                ObservationType.SITE_ROT: []}
        for key, ot, off, size in layout:
            cols[ot].extend(range(off, off + size))
        order = (cols[ObservationType.JOINT_POS]
                 + cols[ObservationType.JOINT_VEL]
                 + cols[ObservationType.SITE_ROT])
        self._perm = np.argsort(np.asarray(order, dtype=np.int64))
        self._qpos_cols = np.asarray(cols[ObservationType.JOINT_POS],
                                     dtype=np.int64)
        self._qvel_cols = np.asarray(cols[ObservationType.JOINT_VEL],
                                     dtype=np.int64)
        self._dev = {}

    def _idx(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        hit = self._dev.get(key)
        if hit is None:
            hit = self._dev[key] = torch.as_tensor(getattr(self, name),
                                                   device=device)
        return hit

    def build_obs(self, data: Data) -> torch.Tensor:
        """The (E, size) observations of the batch (observation.py:89-106)."""
        dev = data.qpos.device
        E = data.qpos.shape[0]
        parts = [data.qpos[:, self._idx("qpos_idx", dev)],
                 data.qvel[:, self._idx("qvel_idx", dev)]]
        if len(self.site_idx):
            parts.append(data.site_xmat[:, self._idx("site_idx", dev)]
                         .reshape(E, 9 * len(self.site_idx)))
        return torch.cat(parts, dim=1)[:, self._idx("_perm", dev)]

    def sample_to_state(self, model: Model, data: Data,
                        sample: torch.Tensor) -> Data:
        """set_sim_state (observation.py:108-124): the JOINT_POS and
        JOINT_VEL entries of each env's trajectory sample (E, sample_dim)
        written into its qpos and qvel. SITE_ROT entries are skipped."""
        qpos, qvel = self.sample_to_qpos_qvel(data.qpos, data.qvel, sample)
        return data.replace(qpos=qpos, qvel=qvel)

    def sample_to_qpos_qvel(self, qpos: torch.Tensor, qvel: torch.Tensor,
                            sample: torch.Tensor) -> tuple:
        """`sample_to_state` on the (E, nq) qpos and (E, nv) qvel alone:
        new tensors, the given ones left as they are."""
        dev = qpos.device
        qpos, qvel = qpos.clone(), qvel.clone()
        if len(self.qpos_idx):
            qpos[:, self._idx("qpos_idx", dev)] = sample[
                :, self._idx("_qpos_cols", dev)].to(qpos.dtype)
        if len(self.qvel_idx):
            qvel[:, self._idx("qvel_idx", dev)] = sample[
                :, self._idx("_qvel_cols", dev)].to(qvel.dtype)
        return qpos, qvel
