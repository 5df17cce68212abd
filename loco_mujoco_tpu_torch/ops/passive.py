"""Passive forces: joint springs and dof dampers.

Counterpart of `loco_mujoco_tpu/ops/passive.py` (mj_passive) without the
tendon springs and dampers: tendon stiffness and damping are refused at
load (core/io), as the reference's muscle plan refuses them. The dampers
take each env's damping from `Data.dof_damping` where it is set (domain
randomization), else the model's; the springs' stiffness and reference,
and the model's damping, are each env's where they vary per env
(`Model.varied`).
"""

from __future__ import annotations

import torch

from ..core.types import Data, DisableBit, Model
from .support import leaf


def passive(model: Model, data: Data) -> Data:
    qfrc = torch.zeros_like(data.qvel)
    if model.opt.disableflags & DisableBit.PASSIVE:
        return data.replace(qfrc_passive=qfrc)
    qadr, dadr = model.jnt_qposadr, model.jnt_dofadr
    spring = -model.jnt_stiffness * (data.qpos[:, qadr]
                                     - leaf(model, "qpos_spring")[:, qadr])
    qfrc = qfrc.index_add(1, torch.as_tensor(dadr, device=qfrc.device), spring)
    damping = (model.dof_damping if data.dof_damping is None
               else data.dof_damping)
    qfrc = qfrc - damping * data.qvel
    return data.replace(qfrc_passive=qfrc)
