"""The UnitreeG1-shaped fixture of the PyTorch port: generator, census, the
committed model and its seeded states.

The fixture is an inline MJCF built from a seed with numpy, G1's default
shape (`models/humanoids/unitree_g1.py`, `disable_arms=True` with the torso
joint kept; its XML, meshes and datasets are not in the repository): a
pelvis on the H1 fixture's root of 3 slides and 3 hinges (`pelvis_tx,
pelvis_tz, pelvis_ty, pelvis_tilt, pelvis_list, pelvis_rotation`, which
G1's fall predicate reads), two legs of hip pitch, roll and yaw, knee,
ankle pitch and roll hinges, and `torso_joint` (13 limited hinges with
damping, 13 motors of gear 80), Euler at 2 ms (BENCH_NOTES.md runs G1 on
Euler), pyramidal cones, condim 3 and the env layer's solver budget
(iterations 8 / ls_iterations 8). The JAX package's model class names no
link masses, so the masses and inertias are chosen for the stand-in (a
heavy torso that carries the fixed arms). contype / conaffinity give
these groups, in `contact_groups` order:

* plane-sphere, k == P: the 8 foot points `{right,left}_foot_{1..4}_col`
  (`unitree_g1.py:40`);
* plane-capsule, k == P: a toe roller across each foot;
* plane-mesh, k < P: hulls from the torque fixture's generator on the
  pelvis, the torso, the thighs, the shins and the feet;
* the self pairs between the legs (the left leg's geoms against the
  right's): sphere-sphere (the foot points), sphere-capsule (the foot
  points against the other leg's thigh, shin and ankle capsules) and
  capsule-capsule (those capsules), k < P each.

Each group has uniform statics, and they differ between groups as on a
real robot: the foot points and toe rollers carry their own friction and
solref, so the floor's pairs with them, the feet's pairs with each other
and with the legs, and the hulls' and capsules' pairs each mix them in
their own way. No plane-only plan takes the model (its groups are neither
uniform nor all against the floor): it runs the reference's extended mega
collision (`mega_ell`) with pyramidal rows, as the real G1 does.

Two sizes come from the same generator:

* full width: nv = 19, plane budget 8, self budget 8: 8 foot points,
  2 toe rollers, 18 hulls (k 8), 16 foot-point pairs (k 8), 24
  point-capsule pairs (k 8) and 9 capsule pairs (k 8): 68 slots, 288 rows
  (the reference G1's figure, `pallas_newton.py:68`). Committed as
  `loco_mujoco_tpu_torch/assets/unitree_g1_shape.npz` (the `g1`
  configuration of `chip_smoke.py`); regenerate it with
  `JAX_PLATFORMS=cpu python tests/test_torch_g1_fixture.py`.
* small: no hip yaw or ankle roll (nv = 15), 2 points per foot, one
  capsule per leg, plane budget 4 and self budget 2: 4 points, 2 rollers,
  10 hulls (k 4), 4 point pairs (k 2), 4 point-capsule pairs (k 2) and 1
  capsule pair: 26 slots, 120 rows, for the interpret-mode comparisons.

With `arms=True` the generator keeps G1's arms
(`UnitreeG1(disable_arms=False)`): the 10 limited hinges of the model
class's `ARMS` (shoulder pitch, roll and yaw, elbow pitch and roll, the
real G1's ranges) on five links per arm under the torso, their motors
(gear 25), a forearm capsule each (the plane-capsule group, with the feet's
statics) and a hand hull each (the plane-mesh group), drawn after every
other part so that the model without them is unchanged: at full width nv
29, 25 bodies, 23 limited hinges and motors, 72 slots, 312 rows
(committed as `loco_mujoco_tpu_torch/assets/unitree_g1_arms_shape.npz`,
the `g1arms` configuration; the script below writes both files); small,
nv 25, 30 slots, 144 rows, past the kernels' first compiled width, for
the float32 mega comparison (tests/test_torch_g1arms_mega.py).

With `k_plane` the plane budget is another: the small size at `K_PLANE_KP`
= 10, its hull count, puts the plane-mesh group at k = P (10 hulls, k 10;
the foot points and rollers k = P as before): 44 slots, 192 rows, the
extended plan with pyramidal rows (`mega_ell`), whose kernels rank every
hull, deepest first, as the reference's mega kernels do. It is committed
as `loco_mujoco_tpu_torch/assets/unitree_g1_kp_shape.npz`
(`load_standin("g1kp")`, the `g1kp` configuration of `chip_smoke.py`;
the script below writes it too), the stand-in of the extended instance at
k = P (tests/test_torch_kp_mega.py). The full G1 at k = P would take 98
slots, past the mega kernels' 80.

It is compiled by the JAX package's own `put_model`; the model arrays are
the "weights" carried across to the port.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # run directly as a script
    sys.path.insert(0, str(REPO))

from loco_mujoco_tpu_torch.core import io as tio  # noqa: E402
from loco_mujoco_tpu_torch.core.types import GeomType  # noqa: E402
from test_torch_fixture import _same, export_model  # noqa: E402
from test_torch_h1_fixture import (PELVIS, Hulls, census, hinge,  # noqa: E402
                                   inertial, root_joints)

ASSET = REPO / "loco_mujoco_tpu_torch" / "assets" / "unitree_g1_shape.npz"
ASSET_ARMS = (REPO / "loco_mujoco_tpu_torch" / "assets"
              / "unitree_g1_arms_shape.npz")
ASSET_KP = REPO / "loco_mujoco_tpu_torch" / "assets" / "unitree_g1_kp_shape.npz"
K_PLANE_KP = 10  # the small size's hull count: its plane-mesh group at k = P
SEED = 0
SOLE = -0.04  # the sole (the foot points' bottom) in the ankle roll link
# chosen link masses (kg) and principal inertias (kg m^2)
LINKS = {"pelvis": (3.8, (0.022, 0.011, 0.023)),
         "torso": (15.0, (0.30, 0.26, 0.09)),
         "hip": (1.4, (0.0021, 0.0016, 0.0019)),
         "thigh": (2.0, (0.011, 0.011, 0.0025)),
         "shin": (1.8, (0.012, 0.012, 0.0017)),
         "ankle": (0.08, (0.00002, 0.00002, 0.00002)),
         "foot": (0.6, (0.0004, 0.0019, 0.0021)),
         # the arms (`arms=True`)
         "shoulder": (0.5, (0.0006, 0.0005, 0.0005)),
         "upper_arm": (0.6, (0.0030, 0.0030, 0.0006)),
         "elbow": (0.4, (0.0004, 0.0004, 0.0003)),
         "forearm": (0.5, (0.0025, 0.0025, 0.0004))}
# contype / conaffinity bits: 1 the floor, 2 the left leg, 4 the right leg
_FLOOR = 'contype="1" conaffinity="0"'
_ONLY_FLOOR = 'contype="0" conaffinity="1"'
# the foot points and toe rollers: their own friction and solref
_FOOT = 'friction="1.2 0.005 0.0001" solref="0.015 1"'
# the arms' hinges (unitree_g1.py ARMS) with the real G1's ranges
ARM_JOINTS = (("shoulder_pitch", "0 1 0", (-2.97, 2.79)),
              ("shoulder_roll", "1 0 0", (-1.59, 2.25)),
              ("shoulder_yaw", "0 0 1", (-2.62, 2.62)),
              ("elbow_pitch", "0 1 0", (-0.23, 3.42)),
              ("elbow_roll", "1 0 0", (-2.09, 2.09)))
ARM_GEAR = 25


def g1_xml(full: bool, seed: int = SEED, arms: bool = False) -> str:
    """The fixture's MJCF (see the module note); `arms` keeps G1's arms
    (`UnitreeG1(disable_arms=False)`), drawn after every other part so
    that the model without them is unchanged."""
    rng = np.random.default_rng(seed)
    hulls = Hulls(rng)

    def u(lo, hi):
        return float(rng.uniform(lo, hi))

    def leg(side, y):
        me, other = (2, 4) if side == "left" else (4, 2)
        cap = f'contype="{me}" conaffinity="{other}"'
        point = f'contype="{me}" conaffinity="{other | 1}" {_FOOT}'
        sy = 1.0 if side == "left" else -1.0
        xs, ys = ((0.09, -0.05), (0.025, -0.025)) if full else \
            ((0.09, -0.05), (0.0,))
        points = "\n".join(
            f'<geom name="{side}_foot_{1 + i}_col" type="sphere" '
            f'size="0.005" pos="{x:.4f} {yy * sy:.4f} {SOLE + 0.005:.4f}" '
            f'{point}/>'
            for i, (x, yy) in enumerate((x, yy) for x in xs for yy in ys))

        def capsule(name, z0, z1):
            return (f'<geom name="{side}_{name}" type="capsule" '
                    f'size="{u(0.035, 0.045):.4f}" '
                    f'fromto="0 0 {z0:.4f} 0 0 {z1:.4f}" {cap}/>')

        yaw = (hinge(rng, f"{side}_hip_yaw_joint", "0 0 1", -2.75, 2.75)
               if full else "")
        roll = (hinge(rng, f"{side}_ankle_roll_joint", "1 0 0", -0.26, 0.26)
                if full else "")
        return f"""
      <body name="{side}_hip_pitch_link" pos="0 {0.064 * sy:.4f} -0.1">
        {inertial(rng, "hip", links=LINKS)}
        {hinge(rng, f"{side}_hip_pitch_joint", "0 1 0", -2.35, 3.05)}
        <body name="{side}_hip_roll_link" pos="0 {0.05 * sy:.4f} 0">
          {inertial(rng, "hip", links=LINKS)}
          {hinge(rng, f"{side}_hip_roll_joint", "1 0 0",
                 *((-0.26, 2.53) if side == "left" else (-2.53, 0.26)))}
          <body name="{side}_hip_yaw_link" pos="0 0 -0.03">
            {inertial(rng, "thigh", -0.15, links=LINKS)}
            {yaw}
            {capsule("thigh_col", -0.05, -0.22) if full else ""}
            {hulls.geoms(2 if full else 1, (0, 0, -0.14),
                         (0.02, 0.02, 0.06), 0.03, 0.05)}
            <body name="{side}_knee_link" pos="0 0 -0.3">
              {inertial(rng, "shin", -0.15, links=LINKS)}
              {hinge(rng, f"{side}_knee_joint", "0 1 0", -0.33, 2.88)}
              {capsule("shin_col", -0.04, -0.22)}
              {hulls.geoms(2 if full else 1, (0, 0, -0.14),
                           (0.02, 0.015, 0.06), 0.025, 0.045)}
              <body name="{side}_ankle_pitch_link" pos="0 0 -0.3">
                {inertial(rng, "ankle", links=LINKS)}
                {hinge(rng, f"{side}_ankle_pitch_joint", "0 1 0", -0.68,
                       0.73)}
                {capsule("ankle_col", 0.0, 0.02) if full else ""}
                <body name="{side}_ankle_roll_link" pos="0 0 -0.01">
                  {inertial(rng, "foot", -0.02, links=LINKS)}
                  {roll}
                  {points}
                  <geom name="{side}_toe_col" type="capsule"
                        size="0.01 0.03" pos="0.12 0 {SOLE + 0.01:.4f}"
                        quat="0.70710678 0.70710678 0 0"
                        {_ONLY_FLOOR} {_FOOT}/>
                  {hulls.geoms(2 if full else 1, (0.02, 0, SOLE + 0.018),
                               (0.03, 0.01, 0.003), 0.015, 0.025)}
                </body>
              </body>
            </body>
          </body>
        </body>
      </body>"""

    def arm(side):
        """Shoulder pitch, roll and yaw, elbow pitch and roll under the
        torso, hanging down; a forearm capsule (the plane-capsule group,
        with the feet's statics) and a hand hull (the plane-mesh group)."""
        sy = 1.0 if side == "left" else -1.0
        j = {n: (axis, lo_hi if side == "left" or n != "shoulder_roll"
                 else (-lo_hi[1], -lo_hi[0]))
             for n, axis, lo_hi in ARM_JOINTS}

        def h(n):
            return hinge(rng, f"{side}_{n}_joint", j[n][0], *j[n][1])

        return f"""
        <body name="{side}_shoulder_pitch_link" pos="0 {0.10 * sy:.4f} 0.24">
          {inertial(rng, "shoulder", links=LINKS)}
          {h("shoulder_pitch")}
          <body name="{side}_shoulder_roll_link" pos="0 {0.04 * sy:.4f} 0">
            {inertial(rng, "shoulder", links=LINKS)}
            {h("shoulder_roll")}
            <body name="{side}_shoulder_yaw_link" pos="0 0 -0.04">
              {inertial(rng, "upper_arm", -0.06, links=LINKS)}
              {h("shoulder_yaw")}
              <body name="{side}_elbow_pitch_link" pos="0 0 -0.12">
                {inertial(rng, "elbow", links=LINKS)}
                {h("elbow_pitch")}
                <body name="{side}_elbow_roll_link" pos="0 0 -0.03">
                  {inertial(rng, "forearm", -0.1, links=LINKS)}
                  {h("elbow_roll")}
                  <geom name="{side}_forearm_col" type="capsule"
                        size="{float(rng.uniform(0.025, 0.03)):.4f}"
                        fromto="0 0 -0.02 0 0 -0.18" {_ONLY_FLOOR} {_FOOT}/>
                  {hulls.geoms(1, (0, 0, -0.22), (0.01, 0.01, 0.01),
                               0.025, 0.04)}
                </body>
              </body>
            </body>
          </body>
        </body>"""

    legs = [("left", 1.0), ("right", -1.0)]
    leg_joints = (("hip_pitch", "hip_roll", "hip_yaw", "knee", "ankle_pitch",
                   "ankle_roll") if full else
                  ("hip_pitch", "hip_roll", "knee", "ankle_pitch"))
    joints = ([f"{s}_{j}_joint" for s, _ in legs for j in leg_joints]
              + ["torso_joint"])
    motors = [f'<motor name="{j}" joint="{j}" gear="80" '
              f'ctrllimited="true" ctrlrange="-1 1"/>' for j in joints]
    if arms:  # in unitree_g1.py's ARMS order
        motors += [f'<motor name="{s}_{n}_joint" joint="{s}_{n}_joint" '
                   f'gear="{ARM_GEAR}" ctrllimited="true" ctrlrange="-1 1"/>'
                   for s in ("right", "left") for n, _, _ in ARM_JOINTS]
    # pelvis height: the foot points sit 2 mm above the floor at qpos0
    height = 0.1 + 0.03 + 0.3 + 0.3 + 0.01 - SOLE + 0.002
    body = f"""
    <body name="pelvis" pos="0 0 {height:.4f}">
      {inertial(rng, "pelvis", links=LINKS)}
      {root_joints()}
      {hulls.geoms(3 if full else 2, (0, 0, 0.0), (0.03, 0.05, 0.03),
                   0.04, 0.07)}
      {"".join(leg(s, y) for s, y in legs)}
      <body name="torso_link" pos="0 0 0.05">
        {inertial(rng, "torso", 0.2, links=LINKS)}
        {hinge(rng, "torso_joint", "0 0 1", -2.62, 2.62)}
        {hulls.geoms(3 if full else 2, (0, 0, 0.22), (0.05, 0.08, 0.12),
                     0.05, 0.09)}{"".join(arm(s) for s in ("right", "left"))
                                  if arms else ""}
      </body>
    </body>"""
    return f"""
<mujoco model="unitree_g1{'_arms' if arms else ''}_shape_{'full' if full else 'small'}">
  <compiler angle="radian"/>
  <option timestep="0.002" integrator="Euler" iterations="8"
          ls_iterations="8"/>
  <default>
    <joint limited="true" armature="0.01"/>
    <geom {_ONLY_FLOOR} condim="3" friction="1 0.005 0.0001"/>
  </default>
  <asset>
    {chr(10).join(hulls.assets)}
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 0.05" {_FLOOR}/>
    {body}
  </worldbody>
  <actuator>
    {chr(10).join(motors)}
  </actuator>
</mujoco>"""


def jax_model(full: bool, dtype=None, arms: bool = False,
              k_plane: int | None = None):
    """The fixture compiled by the JAX package's own `put_model` (plane
    budget 8 and self budget 8 at full width, 4 and 2 small; `k_plane`
    another plane budget)."""
    import jax.numpy as jnp
    import mujoco

    from loco_mujoco_tpu.core.io import put_model

    mjm = mujoco.MjModel.from_xml_string(g1_xml(full, arms=arms))
    return put_model(mjm, dtype=dtype or jnp.float64,
                     contact_k_plane=k_plane or (8 if full else 4),
                     contact_k_other=8 if full else 2)


def torch_model(full: bool, dtype=torch.float64, device="cpu",
                arms: bool = False, k_plane: int | None = None):
    """(JAX model, port model) of the fixture, both from one compile."""
    jm = jax_model(full, arms=arms, k_plane=k_plane)
    leaves, aux = export_model(jm)
    return jm, tio.model_from_numpy(leaves, aux, device=device, dtype=dtype)


def _self_contact_poses(model, n=4096, seed=11):
    """(n_self, nq) poses, one per self group in group order: qpos0 with
    the legs' hinges drawn from a seeded stream (each hip rolled inward,
    pitched, yawed, the knees and ankles bent), the first draw where that
    group's deepest slot lies within 10 mm under its surface and no self
    group's deeper than 20 mm."""
    from loco_mujoco_tpu_torch.ops import collision, kinematics

    rng = np.random.default_rng(seed)
    jid = model.names["joint"]
    q = np.repeat(np.asarray(model.qpos0, np.float64)[None], n, axis=0)
    for side, sg in (("left", -1.0), ("right", 1.0)):
        for j, lo, hi in (("hip_roll", 0.0, 0.35 * sg),
                          ("hip_pitch", -0.5, 0.5),
                          ("knee", 0.0, 1.0), ("ankle_pitch", -0.4, 0.4),
                          ("hip_yaw", -0.6, 0.6)):
            name = f"{side}_{j}_joint"
            if name in jid:
                q[:, int(model.jnt_qposadr[jid[name]])] = rng.uniform(
                    min(lo, hi), max(lo, hi), n)
    m64 = model.to(dtype=torch.float64)
    d = tio.make_data(m64, n).replace(qpos=torch.as_tensor(q))
    dist = collision.collision(m64, kinematics.kinematics(m64, d)) \
        .contact.dist.numpy()
    own = [g for g in m64.groups if g.t1 != int(GeomType.PLANE)]
    mins = np.stack([dist[:, g.offset:g.offset + g.k * g.slots].min(1)
                     for g in own], axis=1)
    fine = (mins > -0.02).all(1)
    return np.stack([q[np.nonzero(fine & (mins[:, i] < 0)
                                  & (mins[:, i] > -0.01))[0][0]]
                     for i in range(len(own))])


def g1_states(model, E: int, seed: int = 7, drop=(0.003, 0.012)):
    """(qpos, qvel, ctrl) numpy arrays of E seeded states of a G1 fixture
    in light contact: qpos0 with joint noise, the pelvis dropped by `drop`
    (the soles pressed into the floor), small velocities and ctrls in
    [-0.3, 0.3]; except env 0, which stands with every hinge at 0, and
    envs 1-3, whose legs touch each other (`_self_contact_poses`: the foot
    points, a foot point and the other leg, the legs' capsules), each
    dropped so that its deepest floor slot lies 5 mm deep."""
    from loco_mujoco_tpu_torch.ops import collision, kinematics

    rng = np.random.default_rng(seed)
    jid = model.names["joint"]
    z = int(model.jnt_qposadr[jid["pelvis_tz"]])
    qpos0 = np.asarray(model.qpos0, np.float64)
    qpos = qpos0[None] + rng.normal(scale=0.02, size=(E, model.nq))
    qpos[:, z] = qpos0[z] - rng.uniform(*drop, size=E)
    special = np.concatenate([qpos0[None], _self_contact_poses(model)])
    m64 = model.to(dtype=torch.float64)
    d = tio.make_data(m64, len(special)).replace(
        qpos=torch.as_tensor(special))
    c = collision.collision(m64, kinematics.kinematics(m64, d)).contact
    plane = np.zeros(c.dist.shape[1], bool)
    for g in m64.groups:
        plane[g.offset:g.offset + g.k * g.slots] = g.t1 == int(GeomType.PLANE)
    dist = c.dist.numpy()
    special[:, z] -= np.where(plane, dist, np.inf).min(axis=1) + 0.005
    n = min(E, len(special))
    qpos[:n] = special[:n]
    qvel = rng.normal(scale=0.1, size=(E, model.nv))
    qvel[:n] = 0.0
    ctrl = rng.uniform(-0.3, 0.3, size=(E, model.nu))
    return qpos, qvel, ctrl


def g1_mega_states(monkeypatch, n_envs: int, seed: int = 7,
                   arms: bool = False, k_plane: int | None = None):
    """(JAX model, port model, JAX data, port data) in float32 for the
    mega path tests, small variant: `g1_states`, the JAX plan built afresh
    with `LMT_MESH_VCAP` at the vertex-table width (test_torch_fixture.
    mega_states) and the JAX data with its contacts and dims from one
    collision pass, as the env's reset does. Call inside
    `jax.enable_x64(False)`."""
    import jax
    import jax.numpy as jnp

    from loco_mujoco_tpu.core.io import make_data as jax_make_data
    from loco_mujoco_tpu.ops import collision as jcoll
    from loco_mujoco_tpu.ops import kinematics as jkin
    from loco_mujoco_tpu.ops import pallas_constraint as pc

    leaves, aux = export_model(jax_model(False, arms=arms, k_plane=k_plane))
    tm = tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float32)
    monkeypatch.setenv("LMT_MESH_VCAP", str(max(tm.mesh_vert.shape[1], 8)))
    monkeypatch.setattr(pc, "_PLAN_CACHE", {})
    jm = jax_model(False, dtype=jnp.float32, arms=arms, k_plane=k_plane)
    qpos, qvel, ctrl = (np.asarray(x, np.float32)
                        for x in g1_states(tm, n_envs, seed))
    d0 = jax_make_data(jm)
    jd = jax.jit(jax.vmap(lambda q, v, u: jcoll.collision(
        jm, jkin.kinematics(jm, d0.replace(qpos=q, qvel=v, ctrl=u)))))(
            qpos, qvel, ctrl)
    t = torch.as_tensor
    td = tio.make_data(tm, n_envs).replace(qpos=t(qpos), qvel=t(qvel),
                                           ctrl=t(ctrl))
    return jm, tm, jd, td


def write_full_width(path, arms: bool = False) -> None:
    leaves, aux = export_model(jax_model(full=True, arms=arms))
    tio.save_model_npz(path, leaves, aux)


def write_kp(path) -> None:
    """The small size with its plane-mesh group at k = P (`K_PLANE_KP`)."""
    leaves, aux = export_model(jax_model(full=False, k_plane=K_PLANE_KP))
    tio.save_model_npz(path, leaves, aux)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

# (t1, t2, condim, k, pairs) of each contact group
CENSUS_FULL = [(0, 2, 3, 8, 8), (0, 3, 3, 2, 2), (0, 7, 3, 8, 18),
               (2, 2, 3, 8, 16), (2, 3, 3, 8, 24), (3, 3, 3, 8, 9)]
CENSUS_SMALL = [(0, 2, 3, 4, 4), (0, 3, 3, 2, 2), (0, 7, 3, 4, 10),
                (2, 2, 3, 2, 4), (2, 3, 3, 2, 4), (3, 3, 3, 1, 1)]


def test_g1_fixture_census(monkeypatch):
    """G1's default census on the stand-in: nv 19 (the root, 12 leg
    hinges, torso_joint), 13 limited hinges and motors, pyramidal cones,
    Euler; six groups with per-group statics that differ between groups:
    68 slots, 288 rows. The JAX package's own row plan of this model takes
    the extended mega collision (`mega_ell`) with pyramidal cones and a
    plane-mesh group, the branch this stand-in exists to run; so does the
    port's (`mega` and `mega_ell` set, `elliptic` unset, `euler_dv`
    kept)."""
    import jax
    import jax.numpy as jnp

    from loco_mujoco_tpu.core.io import make_data as jax_make_data
    from loco_mujoco_tpu.ops import collision as jcoll
    from loco_mujoco_tpu.ops import kinematics as jkin
    from loco_mujoco_tpu.ops import pallas_constraint as pc

    full = tio.load_model_npz(ASSET, device="cpu")
    assert (full.nv, full.nu, full.njnt) == (19, 13, 19)
    assert full.opt.cone == 0 and full.opt.integrator == 0
    assert (full.opt.iterations, full.opt.ls_iterations) == (8, 8)
    assert int(full.jnt_limited.sum()) == 13
    assert [full.names["joint"][n] for n, _, _ in PELVIS] == list(range(6))
    assert {f"{s}_foot_{i}_col" for s in ("left", "right")
            for i in range(1, 5)} <= set(full.names["geom"])
    assert census(full) == CENSUS_FULL
    stat = [tuple(np.concatenate([full.pair_solref[g.pair_ids[0]].numpy(),
                                  full.pair_friction[g.pair_ids[0]].numpy()]))
            for g in full.groups]
    assert len(set(stat)) > 1, "every group has the same statics"
    plan = full.plan
    assert plan.mega and plan.mega_ell and not plan.elliptic
    assert not plan.uniform and plan.euler_dv and plan.pack_w == 26
    assert (plan.ncon, plan.nrows) == (68, 288)
    assert [d["kind"] for d in plan.ext] == [0, 1, 8, 4, 5, 7]
    # the JAX package's own plan of the committed model
    jm = jax_model(True)
    leaves, aux = export_model(jm)
    vcap = max(tio.model_from_numpy(leaves, aux, device="cpu")
               .mesh_vert.shape[1], 8)
    monkeypatch.setenv("LMT_MESH_VCAP", str(vcap))
    monkeypatch.setattr(pc, "_PLAN_CACHE", {})
    with jax.enable_x64(False):
        jm = jax_model(True, dtype=jnp.float32)
        jd = jax.jit(lambda d: jcoll.collision(jm, jkin.kinematics(
            jm, d)))(jax_make_data(jm))
        jplan = pc.get_plan(jm, jd.contact)
    assert jplan is not None and jplan.mega and jplan.mega_ell
    assert not jplan.elliptic
    assert ("plane", "mesh") in [g["kind"] for g in jplan.colp.groups]
    _, small = torch_model(full=False, dtype=torch.float32)
    assert small.nv == 15 and census(small) == CENSUS_SMALL
    sp = small.plan
    assert sp.mega_ell and not sp.elliptic and (sp.ncon, sp.nrows) == (26,
                                                                      120)
    assert os.path.getsize(ASSET) < 512 * 1024


def test_committed_g1_npz_matches_generator(tmp_path):
    """Drift test: the committed model is what the generator makes now,
    leaf for leaf."""
    fresh = tmp_path / "fresh.npz"
    write_full_width(fresh)
    got_l, got_a = tio.read_model_npz(fresh)
    ref_l, ref_a = tio.read_model_npz(ASSET)
    assert got_l.keys() == ref_l.keys() and got_a.keys() == ref_a.keys()
    for k in ref_l:
        np.testing.assert_array_equal(got_l[k], ref_l[k], err_msg=k)
    for k in ref_a:
        assert _same(got_a[k], ref_a[k]), k


@pytest.mark.parametrize("full", [True, False])
def test_g1_states_touch_every_group(full):
    """The seeded states put every group in contact, each self group in
    its own env of envs 1-3, at full width and small."""
    from loco_mujoco_tpu_torch.ops import collision, kinematics

    m = (tio.load_model_npz(ASSET, device="cpu", dtype=torch.float64) if full
         else torch_model(full=False)[1])
    qpos, qvel, _ = g1_states(m, 64)
    d = tio.make_data(m, 64).replace(qpos=torch.as_tensor(qpos),
                                     qvel=torch.as_tensor(qvel))
    d = collision.collision(m, kinematics.kinematics(m, d))
    act = (d.contact.dist < d.contact.includemargin).numpy()
    for g in m.groups:
        on = act[:, g.offset:g.offset + g.k * g.slots].any(1)
        assert on.any(), g[:3]
    for i, g in enumerate(g for g in m.groups if g.t1 != int(GeomType.PLANE)):
        assert act[1 + i, g.offset:g.offset + g.k * g.slots].any(), g[:3]


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py does
    for path, arms in ((ASSET, False), (ASSET_ARMS, True)):
        write_full_width(path, arms=arms)
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
    write_kp(ASSET_KP)
    print(f"wrote {ASSET_KP} ({os.path.getsize(ASSET_KP)} bytes)")
