"""The UnitreeH1-shaped fixture of the PyTorch port: generator, census and
the committed model, and the seeded states of both biped fixtures.

The fixture is an inline MJCF built from a seed with numpy, H1's shape with
its arms disabled (`models/humanoids/unitree_h1.py`, `disable_arms=True`;
its XML, meshes and datasets are not in the repository): a pelvis on H1's
root of 3 slides and 3 hinges (`pelvis_tx, pelvis_tz, pelvis_ty,
pelvis_tilt, pelvis_list, pelvis_rotation`), a torso on `back_bkz`, and two
legs of `hip_flexion`, `hip_adduction`, `hip_rotation`, `knee_angle` and
`ankle_angle` hinges (11 limited hinges with damping, 11 motors of gear
100), Euler at 2 ms and the env layer's solver budget (iterations 8 /
ls_iterations 8). The JAX package's model class names no link masses, so
the masses and inertias are chosen for the stand-in (a heavy torso that
carries the fixed arms, light feet). contype / conaffinity leave the floor
against the robot as the only pairs, in two groups, condim 3 and pyramidal
cones, with one margin, solref, solimp and friction:

* plane-cylinder, k == P: per foot a heel disc (its axis along the shin:
  upright on the floor when the foot is flat) and a toe roller (its axis
  across the foot);
* plane-mesh, k < P: hulls from the torque fixture's generator on the
  pelvis, the torso, the thighs, the shins and the soles.

Two sizes come from the same generator:

* full width: nv = 17, plane-cylinder 4 pairs (k 4: pairs in order),
  plane-mesh 17 pairs (k 8): 40 contact slots, 176 rows. Committed as
  `loco_mujoco_tpu_torch/assets/unitree_h1_shape.npz` (the `h1`
  configuration of `chip_smoke.py`); regenerate it with
  `JAX_PLATFORMS=cpu python tests/test_torch_h1_fixture.py`.
* small: no back joint, hip_flexion, knee and ankle per leg (nv = 12),
  plane budget 3: the heel discs (k 2 of 2) and 8 hulls (k 3): 17 slots,
  76 rows, for the interpret-mode comparisons.

With `arms=True` the generator keeps H1's arms
(`UnitreeH1(disable_arms=False)`): the 8 limited hinges of the model
class's `ARMS` (shoulder pitch, roll and yaw and the elbow, the real H1's
ranges) on four links per arm under the torso, their motors (gear 40) and
an upper-arm and a forearm hull each in the plane-mesh group (k 8 already:
no slot added), the torso lighter by the arms' masses, drawn after every
other part so that the model without them is unchanged: nv 25 (past the
kernels' first compiled width, 24), 17 bodies, 19 limited hinges and
motors, 40 slots, 184 rows, on the plane-only plan (committed as
`loco_mujoco_tpu_torch/assets/unitree_h1_arms_shape.npz`, the `h1arms`
configuration; the script below writes both files). H1's tree with its
arms has nv 25 at any size, so the small arms variant keeps the whole tree
and takes the small variant's geoms and budget (the hip adduction and
rotation hinges stay: nv 25, 17 slots, 92 rows), for the float32 mega
comparison (tests/test_torch_arms_mega.py).

With `weight=m` the generator adds H1's carried weight
(`UnitreeH1(hold_weight=True)`, models/humanoids/unitree_h1.py:110-118 and
robot_base.py:69-79): a body `weight` on the torso (on the pelvis of the
small fixture, which has no torso) holding a box of half sizes 0.1, 0.18,
0.1 at (0.35, 0, 0.1) of mass m, out of every contact pair, drawn last;
`weight="density"` gives the box no mass, so that its body's inertial
comes from the geom at the default density (the Geoms section's mass and
density randomization needs one). The carry pair, the full-width model at
masses 1 and 5 (two of the reference's `VALID_WEIGHTS`), is committed as
`assets/unitree_h1_carry_m1_shape.npz` and `..._m5_shape.npz`: stacked
variants that differ in masses and inertias only, so they share one hull
table. These carry the shape constants of every primitive geom (its
volume at unit density and its inertia at unit mass in its body's frame,
from the JAX package's `_micro_geom_constants`, NaN for planes and
meshes) as `geom_shape_volume` / `geom_shape_inertia` (`carry_model`).

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
if str(REPO) not in sys.path:  # direct `python tests/test_torch_h1_fixture.py`
    sys.path.insert(0, str(REPO))

from loco_mujoco_tpu_torch.core import io as tio  # noqa: E402
from loco_mujoco_tpu_torch.core.types import GeomType  # noqa: E402
from test_torch_fixture import _hull, _same, export_model  # noqa: E402

ASSET = REPO / "loco_mujoco_tpu_torch" / "assets" / "unitree_h1_shape.npz"
ASSET_ARMS = (REPO / "loco_mujoco_tpu_torch" / "assets"
              / "unitree_h1_arms_shape.npz")
SEED = 0
# H1's root joints (models/humanoids/unitree_h1.py PELVIS)
PELVIS = (("pelvis_tx", "slide", "1 0 0"), ("pelvis_tz", "slide", "0 0 1"),
          ("pelvis_ty", "slide", "0 1 0"), ("pelvis_tilt", "hinge", "0 1 0"),
          ("pelvis_list", "hinge", "1 0 0"),
          ("pelvis_rotation", "hinge", "0 0 1"))
SOLE = -0.08  # the sole (the heel disc's bottom) in the foot body's frame
_ARMS = "<!-- arms -->"  # where the torso takes the arms (drawn last)
# chosen link masses (kg) and principal inertias (kg m^2)
LINKS = {"pelvis": (5.4, (0.044, 0.009, 0.049)),
         "torso": (17.8, (0.49, 0.41, 0.14)),
         "thigh": (8.6, (0.12, 0.12, 0.018)),
         "shin": (1.7, (0.031, 0.031, 0.002)),
         "foot": (0.55, (0.0003, 0.0018, 0.0017)),
         # the arms (`arms=True`)
         "shoulder": (1.0, (0.0010, 0.0009, 0.0008)),
         "upper_arm": (0.8, (0.0040, 0.0040, 0.0008)),
         "forearm": (0.7, (0.0035, 0.0035, 0.0006))}
# the arms' hinges (unitree_h1.py ARMS) with the real H1's ranges (the
# left arm's; the right arm mirrors the roll and the yaw)
ARM_JOINTS = (("arm_shy", "0 1 0", (-2.87, 2.87)),
              ("arm_shx", "1 0 0", (-0.34, 3.11)),
              ("arm_shz", "0 0 1", (-1.3, 4.45)),
              ("elbow", "0 1 0", (-1.25, 2.61)))
ARM_GEAR = 40


def arm_joint_names(side: str) -> list:
    """H1's arm joints of one side ("l" or "r"), in `ARMS` order."""
    return [f"{side}_{n}" if n != "elbow" else
            f"{'left' if side == 'l' else 'right'}_elbow"
            for n, _, _ in ARM_JOINTS]


def root_joints() -> str:
    """The pelvis's 3 slides and 3 hinges, unlimited, undamped."""
    return "\n".join(
        f'<joint name="{n}" type="{t}" axis="{a}" limited="false" '
        f'damping="0" armature="0"/>' for n, t, a in PELVIS)


def inertial(rng, link, z=0.0, links=LINKS) -> str:
    """A link's mass and principal inertias, scaled by one factor within
    +-10%."""
    mass, diag = links[link]
    f = float(rng.uniform(0.9, 1.1))
    i = [v * f for v in diag]
    return (f'<inertial pos="0 0 {z:.4f}" mass="{mass * f:.4f}" '
            f'diaginertia="{i[0]:.6f} {i[1]:.6f} {i[2]:.6f}"/>')


def hinge(rng, name, axis, lo, hi) -> str:
    return (f'<joint name="{name}" axis="{axis}" range="{lo} {hi}" '
            f'damping="{float(rng.uniform(1.0, 3.0)):.3f}"/>')


class Hulls:
    """Mesh assets and geoms of hulls made by the torque fixture's
    generator (all points on an ellipsoid, 8k vertices)."""

    def __init__(self, rng, nvert=(5, 20)):
        self.rng, self.nvert, self.assets = rng, nvert, []

    def geoms(self, count, center, spread, semi_lo, semi_hi) -> str:
        out = []
        for _ in range(count):
            name = f"hull{len(self.assets)}"
            semi = self.rng.uniform(semi_lo, semi_hi, size=3)
            n = 8 * int(self.rng.integers(*self.nvert))
            self.assets.append(
                f'<mesh name="{name}" vertex="{_hull(self.rng, semi, n)}"/>')
            p = np.asarray(center) + self.rng.uniform(-1, 1, size=3) * spread
            out.append(f'<geom type="mesh" mesh="{name}" '
                       f'pos="{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"/>')
        return "\n".join(out)


def h1_xml(full: bool, seed: int = SEED, arms: bool = False,
           weight=None) -> str:
    """The fixture's MJCF (see the module note); `arms` keeps H1's arms
    (`UnitreeH1(disable_arms=False)`), drawn after every other part so
    that the model without them is unchanged; `weight` adds the carried
    weight of that mass (or "density": geom-derived at the default
    density)."""
    rng = np.random.default_rng(seed)
    hulls = Hulls(rng)
    tree = full or arms  # the whole joint tree (H1 with arms: nv 25)
    links = LINKS
    if arms:  # the torso no longer carries the arms' masses
        arm_mass = 2 * sum(LINKS[n][0] for n in ("shoulder", "shoulder",
                                                 "upper_arm", "forearm"))
        links = dict(LINKS, torso=(LINKS["torso"][0] - arm_mass,
                                   LINKS["torso"][1]))

    def leg(side, y):
        hip = (hinge(rng, f"hip_flexion_{side}", "0 1 0", -1.57, 1.0)
               + (hinge(rng, f"hip_adduction_{side}", "1 0 0", -0.43, 0.43)
                  + hinge(rng, f"hip_rotation_{side}", "0 0 1", -0.43, 0.43)
                  if tree else ""))
        toe = (f'<geom name="toe_{side}" type="cylinder" size="0.02 0.035" '
               f'pos="0.12 0 {SOLE + 0.02:.4f}" '
               f'quat="0.70710678 0.70710678 0 0"/>' if full else "")
        return f"""
      <body name="thigh_{side}" pos="0 {y:.4f} -0.05">
        {inertial(rng, "thigh", -0.15)}
        {hip}
        {hulls.geoms(2 if full else 1, (0, 0, -0.18), (0.03, 0.02, 0.1),
                     0.03, 0.06)}
        <body name="shin_{side}" pos="0 0 -0.4">
          {inertial(rng, "shin", -0.2)}
          {hinge(rng, f"knee_angle_{side}", "0 1 0", -0.26, 2.05)}
          {hulls.geoms(1, (0, 0, -0.2), (0.02, 0.01, 0.08), 0.025, 0.05)}
          <body name="foot_{side}" pos="0 0 -0.4">
            {inertial(rng, "foot", -0.04)}
            {hinge(rng, f"ankle_angle_{side}", "0 1 0", -0.87, 0.52)}
            <geom name="heel_{side}" type="cylinder"
                  size="{float(rng.uniform(0.035, 0.045)):.4f} 0.01"
                  pos="-0.03 0 {SOLE + 0.01:.4f}"/>
            {toe}
            {hulls.geoms(2 if full else 1, (0.06, 0, SOLE + 0.03),
                         (0.03, 0.015, 0.004), 0.02, 0.03)}
          </body>
        </body>
      </body>"""

    def arm(side):
        """Shoulder pitch, roll and yaw and the elbow under the torso,
        hanging down; an upper-arm and a forearm hull (the plane-mesh
        group)."""
        sy = 1.0 if side == "l" else -1.0
        names = arm_joint_names(side)
        lo_hi = [r if side == "l" or n not in ("arm_shx", "arm_shz")
                 else (-r[1], -r[0]) for n, _, r in ARM_JOINTS]
        h = [hinge(rng, j, a, *r)
             for j, (_, a, _), r in zip(names, ARM_JOINTS, lo_hi)]
        return f"""
        <body name="{side}_shoulder_pitch_link" pos="0 {0.16 * sy:.4f} 0.4">
          {inertial(rng, "shoulder", links=links)}
          {h[0]}
          <body name="{side}_shoulder_roll_link" pos="0 {0.05 * sy:.4f} 0">
            {inertial(rng, "shoulder", links=links)}
            {h[1]}
            <body name="{side}_shoulder_yaw_link" pos="0 0 -0.05">
              {inertial(rng, "upper_arm", -0.1, links=links)}
              {h[2]}
              {hulls.geoms(1, (0, 0, -0.12), (0.01, 0.01, 0.03), 0.03,
                           0.05)}
              <body name="{side}_elbow_link" pos="0 0 -0.22">
                {inertial(rng, "forearm", -0.12, links=links)}
                {h[3]}
                {hulls.geoms(1, (0, 0, -0.15), (0.01, 0.01, 0.03), 0.025,
                             0.045)}
              </body>
            </body>
          </body>
        </body>"""

    legs = [("r", -0.0875), ("l", 0.0875)]
    joints = ([f"{j}_{s}" for s, _ in legs for j in (
        "hip_flexion", "hip_adduction", "hip_rotation", "knee_angle",
        "ankle_angle")] if tree else
        [f"{j}_{s}" for s, _ in legs
         for j in ("hip_flexion", "knee_angle", "ankle_angle")])
    if tree:
        joints = ["back_bkz"] + joints
        torso = f"""
      <body name="torso" pos="0 0 0.15">
        {inertial(rng, "torso", 0.25, links)}
        {hinge(rng, "back_bkz", "0 0 1", -2.35, 2.35)}
        {hulls.geoms(4 if full else 2, (0, 0, 0.25), (0.06, 0.12, 0.15),
                     0.05, 0.1)}{_ARMS}
      </body>"""
    else:
        torso = ""
    motors = [f'<motor name="{j}_actuator" joint="{j}" gear="100" '
              f'ctrllimited="true" ctrlrange="-1 1"/>' for j in joints]
    if arms:  # in unitree_h1.py's ARMS order
        motors += [f'<motor name="{j}_actuator" joint="{j}" '
                   f'gear="{ARM_GEAR}" ctrllimited="true" ctrlrange="-1 1"/>'
                   for s in "lr" for j in arm_joint_names(s)]
    # pelvis height: the heel discs sit 2 mm above the floor at qpos0
    height = 0.05 + 0.4 + 0.4 - SOLE + 0.002
    body = f"""
    <body name="pelvis" pos="0 0 {height:.4f}">
      {inertial(rng, "pelvis")}
      {root_joints()}
      {hulls.geoms(3 if full else 2, (0, 0, 0.02), (0.04, 0.06, 0.04),
                   0.05, 0.09)}
      {torso}
      {"".join(leg(s, y) for s, y in legs)}
    </body>"""
    body = body.replace(_ARMS, "".join(arm(s) for s in "lr") if arms else "")
    if weight is not None:
        mass = "" if weight == "density" else f' mass="{float(weight)}"'
        box = ('<body name="weight"><geom name="weight_geom" type="box" '
               'size="0.1 0.18 0.1" pos="0.35 0 0.1" contype="0" '
               f'conaffinity="0"{mass}/></body>')
        if tree:  # after the torso's hulls (and arms)
            at = body.index("\n      </body>", body.index('name="torso"'))
        else:  # the pelvis's last child
            at = body.rindex("\n    </body>")
        body = body[:at] + box + body[at:]
    return f"""
<mujoco model="unitree_h1{'_arms' if arms else ''}_shape_{'full' if full else 'small'}">
  <compiler angle="radian"/>
  <option timestep="0.002" integrator="Euler" iterations="8"
          ls_iterations="8"/>
  <default>
    <joint limited="true" armature="0.01"/>
    <geom contype="2" conaffinity="1" condim="3" friction="1 0.005 0.0001"/>
  </default>
  <asset>
    {chr(10).join(hulls.assets)}
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 0.05" contype="1"
          conaffinity="2"/>
    {body}
  </worldbody>
  <actuator>
    {chr(10).join(motors)}
  </actuator>
</mujoco>"""


def jax_model(full: bool, dtype=None, arms: bool = False, weight=None):
    """The fixture compiled by the JAX package's own `put_model` (plane
    budget 8 at full width, 3 small)."""
    import jax.numpy as jnp
    import mujoco

    from loco_mujoco_tpu.core.io import put_model

    mjm = mujoco.MjModel.from_xml_string(h1_xml(full, arms=arms,
                                                weight=weight))
    return put_model(mjm, dtype=dtype or jnp.float64,
                     contact_k_plane=8 if full else 3)


CARRY_MASSES = (1.0, 5.0)  # two of RobotHumanoid.VALID_WEIGHTS


def carry_asset(mass: float) -> Path:
    return ASSET.with_name(f"unitree_h1_carry_m{int(mass)}_shape.npz")


def shape_constants(jm):
    """(volume (ngeom,), inertia (ngeom, 3, 3)): each primitive geom's
    volume at unit density and inertia at unit mass about its center in
    its body's frame, from the JAX package's `_micro_geom_constants`
    (MuJoCo's own shape formulas); NaN for planes and meshes."""
    from loco_mujoco_tpu.utils.domain_randomization import \
        _micro_geom_constants

    n = len(jm.geom_type)
    vol, inert = np.full(n, np.nan), np.full((n, 3, 3), np.nan)
    size, quat = np.asarray(jm.geom_size), np.asarray(jm.geom_quat)
    for g in range(n):
        if int(jm.geom_type[g]) in (2, 3, 4, 5, 6):  # primitive solids
            vol[g], inert[g] = _micro_geom_constants(
                int(jm.geom_type[g]), size[g], quat[g], 1000.0)
    return vol, inert


def carry_model(full: bool, weight):
    """(JAX model, leaves, aux) of the fixture with the carried weight,
    the aux with its geoms' shape constants (`shape_constants`)."""
    jm = jax_model(full, weight=weight)
    leaves, aux = export_model(jm)
    aux["geom_shape_volume"], aux["geom_shape_inertia"] = \
        shape_constants(jm)
    return jm, leaves, aux


def torch_model(full: bool, dtype=torch.float64, device="cpu",
                arms: bool = False):
    """(JAX model, port model) of the fixture, both from one compile."""
    jm = jax_model(full, arms=arms)
    leaves, aux = export_model(jm)
    return jm, tio.model_from_numpy(leaves, aux, device=device, dtype=dtype)


def biped_states(model, E: int, seed: int = 7, drop=(0.005, 0.015)):
    """(qpos, qvel, ctrl) numpy arrays of E seeded states of a biped
    fixture (H1- or Atlas-shaped) in light contact: qpos0 with joint noise,
    the pelvis dropped by `drop` (the soles pressed into the floor), except
    env 0, which stands with every hinge at 0 (the heel discs upright on
    the floor: their axis along the normal) and env 1, whose ankles are
    tipped 0.5 rad heel down (the heel discs on their rim), both dropped
    so that their deepest plane-cylinder slot lies 5 mm deep."""
    from loco_mujoco_tpu_torch.ops import collision, kinematics

    rng = np.random.default_rng(seed)
    jid = model.names["joint"]
    adr = lambda n: int(model.jnt_qposadr[jid[n]])  # noqa: E731
    qpos0 = np.asarray(model.qpos0, np.float64)
    z = adr("pelvis_tz")
    qpos = qpos0[None] + rng.normal(scale=0.02, size=(E, model.nq))
    qpos[:, z] = qpos0[z] - rng.uniform(*drop, size=E)
    special = qpos0[None].repeat(2, axis=0)
    for side in "rl":
        special[1, adr(f"ankle_angle_{side}")] = -0.5
    m64 = model.to(dtype=torch.float64)
    d = tio.make_data(m64, 2).replace(qpos=torch.as_tensor(special))
    dist = collision.collision(m64, kinematics.kinematics(m64, d)).contact.dist
    g = next(g for g in model.groups if g.t2 == int(GeomType.CYLINDER))
    cyl = dist.numpy()[:, g.offset:g.offset + g.k * g.slots]
    special[:, z] -= cyl.min(axis=1) + 0.005
    qpos[:min(E, 2)] = special[:min(E, 2)]
    qvel = rng.normal(scale=0.1, size=(E, model.nv))
    qvel[:min(E, 2)] = 0.0
    ctrl = rng.uniform(-0.3, 0.3, size=(E, model.nu))
    return qpos, qvel, ctrl


def cyl_states(monkeypatch, fixture, n_envs: int, seed: int = 7):
    """(JAX model, port model, JAX data, port data) in float32 for the mega
    path tests of a biped fixture module (`fixture`: this module or the
    Atlas one), small variant: `biped_states`, the JAX plan built afresh
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

    leaves, aux = export_model(fixture.jax_model(False))
    tm = tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float32)
    monkeypatch.setenv("LMT_MESH_VCAP", str(max(tm.mesh_vert.shape[1], 8)))
    monkeypatch.setattr(pc, "_PLAN_CACHE", {})
    jm = fixture.jax_model(False, dtype=jnp.float32)
    qpos, qvel, ctrl = (np.asarray(x, np.float32)
                        for x in biped_states(tm, n_envs, seed))
    d0 = jax_make_data(jm)
    jd = jax.jit(jax.vmap(lambda q, v, u: jcoll.collision(
        jm, jkin.kinematics(jm, d0.replace(qpos=q, qvel=v, ctrl=u)))))(
            qpos, qvel, ctrl)
    t = torch.as_tensor
    td = tio.make_data(tm, n_envs).replace(qpos=t(qpos), qvel=t(qvel),
                                           ctrl=t(ctrl))
    return jm, tm, jd, td


def write_full_width(path, arms: bool = False, weight=None) -> None:
    if weight is None:
        leaves, aux = export_model(jax_model(full=True, arms=arms))
    else:
        _, leaves, aux = carry_model(True, weight)
    tio.save_model_npz(path, leaves, aux)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

# (t1, t2, condim, k, pairs) of each contact group
CENSUS_FULL = [(0, 5, 3, 4, 4), (0, 7, 3, 8, 17)]
CENSUS_SMALL = [(0, 5, 3, 2, 2), (0, 7, 3, 3, 8)]


def census(m):
    return [(g.t1, g.t2, g.condim, g.k, len(g.pair_ids)) for g in m.groups]


def test_h1_fixture_census():
    """H1's census on the stand-in: nv 17 (the root, back_bkz, 10 leg
    hinges), 11 limited hinges and motors, pyramidal cones, Euler; a
    plane-cylinder group with k == P and a plane-mesh group on the
    kernels (k < P), uniform statics: the mega plan, 40 slots, 176 rows."""
    full = tio.load_model_npz(ASSET, device="cpu")
    assert (full.nv, full.nu, full.njnt) == (17, 11, 17)
    assert full.opt.cone == 0 and full.opt.integrator == 0
    assert (full.opt.iterations, full.opt.ls_iterations) == (8, 8)
    assert int(full.jnt_limited.sum()) == 11
    assert [full.names["joint"][n] for n, _, _ in PELVIS] == list(range(6))
    assert census(full) == CENSUS_FULL
    assert full.mesh_kernel[1] is not None
    plan = full.plan
    assert plan.mega and plan.uniform and plan.euler_dv and not plan.mega_ell
    assert [g["kind"] for g in plan.groups] == ["cyl", "mesh"]
    assert (plan.ncon, plan.nrows) == (40, 176)
    _, small = torch_model(full=False, dtype=torch.float32)
    assert small.nv == 12 and census(small) == CENSUS_SMALL
    assert small.plan.mega and (small.plan.ncon, small.plan.nrows) == (17, 76)
    assert os.path.getsize(ASSET) < 512 * 1024


def test_committed_h1_npz_matches_generator(tmp_path):
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


@pytest.mark.parametrize("mass", CARRY_MASSES)
def test_committed_carry_npz_matches_generator(tmp_path, mass):
    """Drift test of the carry pair: each committed model is what the
    generator makes now, leaf for leaf, with its shape constants; the two
    differ in masses and inertias only (and what MuJoCo derives from
    them), so they stack with one hull table."""
    fresh = tmp_path / "fresh.npz"
    write_full_width(fresh, weight=mass)
    got_l, got_a = tio.read_model_npz(fresh)
    ref_l, ref_a = tio.read_model_npz(carry_asset(mass))
    assert got_l.keys() == ref_l.keys() and got_a.keys() == ref_a.keys()
    for k in ref_l:
        np.testing.assert_array_equal(got_l[k], ref_l[k], err_msg=k)
    for k in ref_a:
        if k.startswith("geom_shape"):  # NaN where a geom has none
            np.testing.assert_array_equal(got_a[k], ref_a[k], err_msg=k)
        else:
            assert _same(got_a[k], ref_a[k]), k
    w = ref_a["names"]["body"]["weight"]
    assert ref_l["body_mass"][w] == mass
    box = ref_a["names"]["geom"]["weight_geom"]
    np.testing.assert_allclose(ref_a["geom_shape_volume"][box],
                               0.2 * 0.36 * 0.2, rtol=1e-12)
    assert np.isnan(ref_a["geom_shape_volume"][0])  # the floor
    models = [tio.model_from_numpy(*tio.read_model_npz(carry_asset(m)),
                                   device="cpu") for m in CARRY_MASSES]
    stacked, varied = tio.stack_variants(models)
    assert "body_mass" in varied and "mesh_vert" not in varied
    assert stacked.mesh_kernel[1].K == 1


def test_h1_states_touch_every_group():
    """The seeded states put both groups in contact, env 0's heel discs
    upright (axis along the normal) and env 1's on their rim."""
    from loco_mujoco_tpu_torch.ops import collision, kinematics

    m = tio.load_model_npz(ASSET, device="cpu", dtype=torch.float64)
    qpos, qvel, _ = biped_states(m, 64)
    d = tio.make_data(m, 64).replace(qpos=torch.as_tensor(qpos),
                                     qvel=torch.as_tensor(qvel))
    d = collision.collision(m, kinematics.kinematics(m, d))
    act = (d.contact.dist < d.contact.includemargin).numpy()
    for g in m.groups:
        assert act[:, g.offset:g.offset + g.k * g.slots].any(), g[:3]
    heel = [m.names["geom"][f"heel_{s}"] for s in "rl"]
    axis = d.geom_xmat[:, heel, :, 2].numpy()
    assert np.all(axis[0] == [0.0, 0.0, 1.0])
    assert np.all(np.abs(axis[1, :, 2]) < np.cos(0.4))
    # env 0: the three near-cap rim slots of a heel disc lie at one depth;
    # env 1: the near rim point of each heel disc is in contact
    o = m.groups[0].offset  # heel_r, toe_r, heel_l, toe_l: 4 slots each
    np.testing.assert_allclose(d.contact.dist[0, o:o + 3].numpy(),
                               d.contact.dist[0, o].item(), atol=1e-12)
    assert act[0, o] and act[1, o] and act[1, o + 8]


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py does
    for path, arms in ((ASSET, False), (ASSET_ARMS, True)):
        write_full_width(path, arms=arms)
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
    for m in CARRY_MASSES:
        write_full_width(carry_asset(m), weight=m)
        print(f"wrote {carry_asset(m)} "
              f"({os.path.getsize(carry_asset(m))} bytes)")
