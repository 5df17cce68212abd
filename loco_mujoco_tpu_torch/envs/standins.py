"""LocoEnv of the committed stand-in models (`assets/*.npz`).

The reference builds its envs from the robot classes' XML and its
datasets, which the port does not carry. A stand-in's env is built here
from the model alone: the obs spec of its joints (positions, then
velocities, in the reference robot's order), a seeded synthetic
trajectory inside its joint ranges, the target-velocity reward and the fall
predicate of the robot it stands in for (`standin_kind`):
`base.humanoid_has_fallen` with the root and abdomen joints in the pelvis
and lumbar roles, `base.quadruped_has_fallen` (A1), or the bipeds' own
`base.h1_has_fallen`, `atlas_has_fallen`, `g1_has_fallen` and
`talos_has_fallen` on their pelvis (and Atlas's and Talos's back) joints.
A model of no known kind raises.
`env_parts` gives the same parts as plain values, so that another
package's env can be built from them; `damping_dr` is a Joints-section
randomization config of the model's own damping; `load_standin` loads a
committed stand-in by name (`STANDINS`; A1's position mode, "a1pos", is
A1's kind with the position servos, whose actions the env unnormalizes into
the ctrlrange, the joints' ranges; "g1kp" is the small G1 whose
plane-mesh group is at k = P, of G1's kind). `VARIANTS` names the
committed sets of stacked model variants, `load_variants` loads one: the
torque humanoid at the four 4-ages scalings ("humanoid4ages", the
scalings 0.4, 0.6, 0.8 and 1.0 of HumanoidTorque4Ages) and H1 carrying a
weight of 1 or 5 kg ("h1carry"), each set of one structure;
`make_env(variants[0], model_variants=variants)` builds its env.

    from loco_mujoco_tpu_torch.envs import standins
    model = standins.load_standin("a1pos")
    env = standins.make_env(model, dr=standins.damping_dr(model))
"""

from __future__ import annotations

import numpy as np

TRAJ_DT = 0.004  # the synthetic trajectory's own dt (resampled to control)
TARGET_VELOCITY = 1.25  # the target-velocity reward's v*
# the reference humanoid's fall roles (models/humanoids/humanoid.py:192-196,
# pelvis_ty .. lumbar_rotation) as the stand-in's root and abdomen joints;
# without an abdomen (the small fixture) the root hinges take the lumbar
# roles too
HUMANOID_ROLES = ("root_z", "root_ry", "root_rx", "root_rz", "abdomen_y",
                  "abdomen_x", "abdomen_z")
LUMBAR_FALLBACK = {"abdomen_y": "root_ry", "abdomen_x": "root_rx",
                   "abdomen_z": "root_rz"}
# the bipeds' root (models/humanoids/unitree_h1.py PELVIS, atlas.py and
# unitree_g1.py and talos.py alike), the joints their predicates read, and
# the joints that tell them apart: H1's back_bkz, Atlas's back_bky and
# back_bkx (atlas.py BACK), Talos's back_bkz and back_bky without back_bkx
# (talos.py BACK), G1's torso_joint (unitree_g1.py)
PELVIS = ("pelvis_tx", "pelvis_tz", "pelvis_ty", "pelvis_tilt",
          "pelvis_list", "pelvis_rotation")
ATLAS_BACK = ("back_bky", "back_bkx", "back_bkz")
TALOS_BACK = ("back_bky", "back_bkz")  # talos.py:51, in its predicate's order
HEIGHT = ("root_z", "trunk_tz", "pelvis_tz")  # the root's vertical slide
# the committed stand-ins, `assets/<file>.npz`, by name: A1's torque and
# position modes are two files of one robot (its kind "a1")
STANDINS = {"humanoid": "humanoid_torque_shape",
            "muscle": "humanoid_muscle_shape", "a1": "unitree_a1_shape",
            "a1pos": "unitree_a1_position_shape", "h1": "unitree_h1_shape",
            "atlas": "atlas_shape", "g1": "unitree_g1_shape",
            "g1arms": "unitree_g1_arms_shape",
            "h1arms": "unitree_h1_arms_shape", "atlasarms": "atlas_arms_shape",
            "talos": "talos_shape", "g1kp": "unitree_g1_kp_shape",
            "humanoid_s04": "humanoid_torque_s04_shape",
            "humanoid_s06": "humanoid_torque_s06_shape",
            "humanoid_s08": "humanoid_torque_s08_shape",
            "h1carry1": "unitree_h1_carry_m1_shape",
            "h1carry5": "unitree_h1_carry_m5_shape"}
# committed sets of stacked model variants, by name (see the module note)
VARIANTS = {"humanoid4ages": ("humanoid_s04", "humanoid_s06", "humanoid_s08",
                              "humanoid"),
            "h1carry": ("h1carry1", "h1carry5")}


def load_standin(name: str, device=None, dtype=None):
    """The committed stand-in `name` (`STANDINS`) on `device` (the card
    unless the caller passes another one), float32 unless `dtype`."""
    from pathlib import Path

    import torch

    from ..core import io

    path = (Path(__file__).resolve().parent.parent / "assets"
            / f"{STANDINS[name]}.npz")
    return io.load_model_npz(path, device=device,
                             dtype=dtype or torch.float32)


def load_variants(name: str, device=None, dtype=None) -> list:
    """The models of the committed variant set `name` (`VARIANTS`), in
    order, as `load_standin` loads each."""
    return [load_standin(n, device, dtype) for n in VARIANTS[name]]


def standin_kind(model) -> str:
    """The robot a stand-in is shaped after ("humanoid", "a1", "h1",
    "atlas", "g1" or "talos"), from its joint names: the torque humanoid's
    root_z, A1's trunk_tz, and on a pelvis root G1's torso_joint, Talos's
    back_bkz and back_bky without back_bkx, Atlas's back_bky / back_bkx or
    H1's back_bkz. Raises for a model it cannot tell (a pelvis root with
    none of those joints fits H1 and Atlas alike)."""
    jid = model.names["joint"]
    if "root_z" in jid:
        return "humanoid"
    if "trunk_tz" in jid:
        return "a1"
    if all(j in jid for j in PELVIS):
        if "torso_joint" in jid:
            return "g1"
        if all(j in jid for j in TALOS_BACK) and "back_bkx" not in jid:
            return "talos"
        if "back_bky" in jid or "back_bkx" in jid:
            return "atlas"
        if "back_bkz" in jid:
            return "h1"
    raise ValueError("cannot tell which robot the model stands in for "
                     "(its fall predicate): joints "
                     + ", ".join(sorted(jid, key=jid.get)))


def env_joints(model):
    """The joints in the obs order of the reference robot: the two
    horizontal root slides (dropped from the obs) first, then the height
    (the humanoid stand-ins' root_z; A1's trunk_tz already third)."""
    names = sorted(model.names["joint"], key=model.names["joint"].get)
    lead = [j for j in ("root_x", "root_y", "root_z") if j in names]
    return lead + [j for j in names if j not in lead]


def synthetic_trajectory(model, joints, traj_dt=TRAJ_DT, n=120, seed=3):
    """Seeded trajectory files (numpy): sinusoids of the hinges about their
    qpos0 (the stand-ins' standing pose, clipped into range) over a tenth
    of their half range, the forward slide a ramp at 0.8 m/s, the height
    10 mm below qpos0 (the feet pressed into the floor, in contact from
    the start), the other root coordinates small; the velocities their
    derivatives; cut into two trajectories of n / 2 samples. The height
    is the root's vertical slide (HEIGHT): third in the humanoid's and
    A1's obs order, second on the bipeds' pelvis."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * traj_dt
    jid = model.names["joint"]
    jr = model.jnt_range.cpu().numpy().astype(np.float64)
    q0 = model.qpos0.cpu().numpy().astype(np.float64)
    files = {}
    for k, j in enumerate(joints):
        w, ph = 2 * np.pi * rng.uniform(0.5, 1.5), rng.uniform(0, 2 * np.pi)
        q = float(q0[int(model.jnt_qposadr[jid[j]])])
        if k == 0:
            mid, amp, ramp = q, 0.01, 0.8
        elif j in HEIGHT:
            mid, amp, ramp = q - 0.01, 0.002, 0.0
        elif k < 6:
            mid, amp, ramp = q, 0.02, 0.0
        else:
            lo, hi = jr[jid[j]]
            mid, amp, ramp = min(max(q, lo), hi), 0.1 * (hi - lo) / 2, 0.0
        files[f"q_{j}"] = mid + amp * np.sin(w * t + ph) + ramp * t
        files[f"dq_{j}"] = amp * w * np.cos(w * t + ph) + ramp
    files["split_points"] = np.array([0, n // 2, n])  # two trajectories
    return files


def env_parts(model, n_substeps=10):
    """What a LocoEnv of the stand-in is built from, in either package:
    the obs spec entries (key, joint, 0 position / 1 velocity), the
    trajectory's keyword arguments (synthetic, resampled from TRAJ_DT to
    the control dt), the target-velocity reward's x-velocity index, the
    stand-in's kind (`standin_kind`) and its fall predicate's obs indices
    (None for A1, whose predicate reads obs 0-2; on the bipeds pelvis_ty,
    tilt, list and rotation, then Atlas's back_bky, bkx and bkz where it
    has them, or Talos's back_bky and bkz)."""
    joints = env_joints(model)
    spec = ([(f"q_{j}", j, 0) for j in joints]
            + [(f"dq_{j}", j, 1) for j in joints])
    keys = [k for k, _, _ in spec]
    ki = {k: i - 2 for i, k in enumerate(keys)}
    jr = model.jnt_range.cpu().numpy().astype(np.float64)
    jid = model.names["joint"]
    traj = dict(keys=keys, key_dims=[1] * len(keys),
                traj_files=synthetic_trajectory(model, joints),
                traj_dt=TRAJ_DT,
                control_dt=n_substeps * float(model.opt.timestep),
                low=np.array([jr[jid[j], 0] for j in joints[2:]]),
                high=np.array([jr[jid[j], 1] for j in joints[2:]]),
                joint_pos_idx=list(range(len(joints))), warn=False)
    kind = standin_kind(model)
    if kind == "humanoid":
        fall = [ki["q_" + (r if r in jid else LUMBAR_FALLBACK[r])]
                for r in HUMANOID_ROLES]
    elif kind == "a1":
        fall = None
    else:
        fall = [ki[f"q_{j}"] for j in PELVIS[2:]]
        if kind == "atlas" and all(j in jid for j in ATLAS_BACK):
            fall += [ki[f"q_{j}"] for j in ATLAS_BACK]
        if kind == "talos":
            fall += [ki[f"q_{j}"] for j in TALOS_BACK]
    return dict(spec=spec, traj=traj, x_vel=ki[f"dq_{joints[0]}"],
                kind=kind, fall=fall)


def damping_dr(model, lo=0.5, hi=1.5):
    """A Joints-section randomization config: each joint's damping d > 0
    drawn from uniform_range [lo d, hi d]."""
    d = model.dof_damping.cpu().numpy()
    jid = model.names["joint"]
    return {"Joints": {j: {"damping": {"uniform_range": [
        lo * float(d[int(model.jnt_dofadr[i])]),
        hi * float(d[int(model.jnt_dofadr[i])])]}}
        for j, i in jid.items() if d[int(model.jnt_dofadr[i])] > 0}}


def make_env(model, dr=None, n_substeps=10, **kw):
    """The LocoEnv of a stand-in (see `env_parts`) on the model's device;
    `dr` a randomization config dict, `kw` LocoEnv's other options."""
    from ..datasets.trajectory import TrajectoryData
    from ..rewards.rewards import make_reward
    from . import base
    from .observation import ObsIndex

    parts = env_parts(model, n_substeps)
    kind, idx = parts["kind"], parts["fall"]
    fall = (base.quadruped_has_fallen if kind == "a1" else
            {"humanoid": base.humanoid_has_fallen, "h1": base.h1_has_fallen,
             "atlas": base.atlas_has_fallen, "g1": base.g1_has_fallen,
             "talos": base.talos_has_fallen}[kind](idx))
    return base.LocoEnv(
        model, ObsIndex(model, parts["spec"]), n_substeps=n_substeps,
        reward_fn=make_reward("target_velocity",
                              {"target_velocity": TARGET_VELOCITY},
                              {"x_vel_idx": parts["x_vel"]}),
        traj_data=TrajectoryData(dtype=model.qpos0.dtype,
                                 device=model.qpos0.device, **parts["traj"]),
        has_fallen=fall, domain_randomization_config=dr, **kw)
