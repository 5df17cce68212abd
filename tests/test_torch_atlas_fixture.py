"""The Atlas-shaped fixture of the PyTorch port: generator, census and the
committed model.

The fixture is an inline MJCF built from a seed with numpy, Atlas's shape
with its arms disabled (`models/humanoids/atlas.py`, `disable_arms=True`;
its XML, meshes and datasets are not in the repository): a pelvis on
Atlas's root of 3 slides and 3 hinges (the H1 fixture's `PELVIS`), a torso
chain on `back_bkz`, `back_bky` and `back_bkx`, and two legs of
`hip_rotation`, `hip_adduction`, `hip_flexion`, `knee_angle` and
`ankle_angle` hinges (13 limited hinges with damping, 13 motors of gear
100), RK4 at 2 ms (atlas.xml's integrator, `models/humanoids/atlas.py`)
and the env layer's solver budget (iterations 8 / ls_iterations 8). The
JAX package's model class names no link masses, so the masses and
inertias are chosen for the stand-in (a heavy upper torso that carries the
fixed arms). contype / conaffinity leave the floor against the robot as
the only pairs, in two groups, condim 3 and pyramidal cones, with one
margin, solref, solimp and friction, both ranked by the top-K (k < P):

* plane-cylinder: per leg two thigh and two shin cylinders (along the
  leg), a heel disc (along the shin: upright on the floor when the foot is
  flat) and an ankle roller (across the foot);
* plane-box: the pelvis, the three torso links, per hip a glute box, and
  per foot a sole, a toe and a heel box.

Two sizes come from the same generator:

* full width: nv = 19, plane-cylinder 12 pairs (k 8), plane-box 12 pairs
  (k 8): 64 contact slots (BENCH_NOTES.md's Atlas row), 272 rows.
  Committed as `loco_mujoco_tpu_torch/assets/atlas_shape.npz` (the `atlas`
  configuration of `chip_smoke.py`); regenerate it with
  `JAX_PLATFORMS=cpu python tests/test_torch_atlas_fixture.py`.
* small: no back joints, hip_flexion, knee and ankle per leg (nv = 12),
  plane budget 3: 6 cylinders (k 3) and 5 boxes (k 3): 24 slots, 104
  rows, for the interpret-mode comparisons.

With `arms=True` the generator keeps Atlas's arms
(`Atlas(disable_arms=False)`): the 12 limited hinges of the model class's
`ARMS` (shoulder z and x, elbow y and x, wrist y and x, the real Atlas's
ranges) on six links per arm under the upper torso, their motors (gear
60), a forearm cylinder each in the plane-cylinder group and a hand box
each in the plane-box group (both k 8 already: no slot added), the upper
torso lighter by the arms' masses, drawn after every other part so that
the model without them is unchanged: nv 31, 25 bodies, 25 limited hinges
and motors, 64 slots, 288 rows, on the plane-only plan (committed as
`loco_mujoco_tpu_torch/assets/atlas_arms_shape.npz`, the `atlasarms`
configuration; the script below writes both files). Its small variant
keeps the back chain that carries the arms and the small legs (nv 27, 8
cylinders and 10 boxes, k 3: 24 slots, 120 rows), for the float32 mega
comparison (tests/test_torch_arms_mega.py).

It is compiled by the JAX package's own `put_model`; the model arrays are
the "weights" carried across to the port. The seeded states are the H1
fixture's `biped_states`.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # run directly as a script
    sys.path.insert(0, str(REPO))

from loco_mujoco_tpu_torch.core import io as tio  # noqa: E402
from test_torch_fixture import _same, export_model  # noqa: E402
from test_torch_h1_fixture import (PELVIS, biped_states, census,  # noqa: E402
                                   hinge, inertial, root_joints)

ASSET = REPO / "loco_mujoco_tpu_torch" / "assets" / "atlas_shape.npz"
ASSET_ARMS = REPO / "loco_mujoco_tpu_torch" / "assets" / "atlas_arms_shape.npz"
SEED = 0
_ARMS = "<!-- arms -->"  # where the upper torso takes the arms (drawn last)
SOLE = -0.08  # the sole (the heel disc's bottom) in the foot body's frame
# chosen link masses (kg) and principal inertias (kg m^2)
LINKS = {"pelvis": (9.5, (0.11, 0.03, 0.12)),
         "ltorso": (2.3, (0.002, 0.002, 0.002)),
         "mtorso": (0.8, (0.0007, 0.0007, 0.0006)),
         "utorso": (84.0, (1.9, 1.4, 1.2)),
         "hip": (2.2, (0.004, 0.006, 0.005)),
         "uleg": (8.2, (0.09, 0.09, 0.02)),
         "lleg": (4.5, (0.08, 0.08, 0.01)),
         "foot": (2.5, (0.004, 0.007, 0.008)),
         # the arms (`arms=True`)
         "clav": (3.4, (0.011, 0.009, 0.005)),
         "scap": (3.0, (0.007, 0.005, 0.006)),
         "uarm": (1.9, (0.009, 0.009, 0.003)),
         "larm": (2.4, (0.010, 0.010, 0.003)),
         "ufarm": (0.6, (0.0007, 0.0007, 0.0005)),
         "lfarm": (1.0, (0.0015, 0.0015, 0.0008))}
# the arms' hinges (atlas.py ARMS, without the side) with the real
# Atlas's ranges (the left arm's; the right arm mirrors shz and elx)
ARM_JOINTS = (("arm_shz", "0 0 1", (-1.5708, 0.7854)),
              ("arm_shx", "1 0 0", (-1.5708, 1.5708)),
              ("arm_ely", "0 1 0", (0.0, 3.1416)),
              ("arm_elx", "1 0 0", (0.0, 2.3562)),
              ("arm_wry", "0 1 0", (-3.011, 3.011)),
              ("arm_wrx", "1 0 0", (-1.7628, 1.7628)))
ARM_LINKS = ("clav", "scap", "uarm", "larm", "ufarm", "lfarm")
ARM_GEAR = 60


def atlas_xml(full: bool, seed: int = SEED, arms: bool = False) -> str:
    """The fixture's MJCF (see the module note); `arms` keeps Atlas's arms
    (`Atlas(disable_arms=False)`), drawn after every other part so that
    the model without them is unchanged."""
    rng = np.random.default_rng(seed)
    links = LINKS
    if arms:  # the upper torso no longer carries the arms' masses
        arm_mass = 2 * sum(LINKS[n][0] for n in ARM_LINKS)
        links = dict(LINKS, utorso=(LINKS["utorso"][0] - arm_mass,
                                    LINKS["utorso"][1]))

    def u(lo, hi):
        return float(rng.uniform(lo, hi))

    def box(name, pos, size):
        return (f'<geom name="{name}" type="box" size="{size[0]:.4f} '
                f'{size[1]:.4f} {size[2]:.4f}" pos="{pos[0]:.4f} '
                f'{pos[1]:.4f} {pos[2]:.4f}"/>')

    def cyl(name, pos, r, hl, quat="1 0 0 0"):
        return (f'<geom name="{name}" type="cylinder" size="{r:.4f} {hl:.4f}" '
                f'pos="{pos[0]:.4f} {pos[1]:.4f} {pos[2]:.4f}" '
                f'quat="{quat}"/>')

    across = "0.70710678 0.70710678 0 0"  # the cylinder's axis along y

    def leg(side, y):
        hip = ((hinge(rng, f"hip_rotation_{side}", "0 0 1", -0.3, 0.8)
                + hinge(rng, f"hip_adduction_{side}", "1 0 0", -0.5, 0.5))
               if full else "")
        glute = (box(f"glute_{side}", (0, 0, -0.02), (0.05, 0.05, 0.04))
                 if full else "")
        thigh = "".join(
            cyl(f"thigh{i}_{side}", (0, 0, -0.12 - 0.17 * i), u(0.06, 0.08),
                0.08) for i in range(2 if full else 1))
        shin = "".join(
            cyl(f"shin{i}_{side}", (0, 0, -0.1 - 0.17 * i), u(0.045, 0.06),
                0.08) for i in range(2 if full else 1))
        heel_r = u(0.035, 0.045)
        feet = [cyl(f"heel_{side}", (-0.06, 0, SOLE + 0.01), heel_r, 0.01),
                box(f"sole_{side}", (0.04, 0, SOLE + 0.03),
                    (0.1, 0.06, 0.015)),
                box(f"toe_{side}", (0.17, 0, SOLE + 0.015),
                    (0.03, 0.05, 0.015))]
        if full:
            feet += [cyl(f"ankle_{side}", (0, 0, -0.01), 0.03, 0.04, across),
                     box(f"heelbox_{side}", (-0.09, 0, SOLE + 0.02),
                         (0.02, 0.05, 0.02))]
        return f"""
      <body name="hip_{side}" pos="0 {y:.4f} -0.05">
        {inertial(rng, "hip", 0, LINKS)}
        {hip}
        {glute}
        <body name="uleg_{side}" pos="0 0 -0.05">
          {inertial(rng, "uleg", -0.2, LINKS)}
          {hinge(rng, f"hip_flexion_{side}", "0 1 0", -1.6, 0.6)}
          {thigh}
          <body name="lleg_{side}" pos="0 0 -0.42">
            {inertial(rng, "lleg", -0.2, LINKS)}
            {hinge(rng, f"knee_angle_{side}", "0 1 0", 0.0, 2.35)}
            {shin}
            <body name="foot_{side}" pos="0 0 -0.42">
              {inertial(rng, "foot", -0.04, LINKS)}
              {hinge(rng, f"ankle_angle_{side}", "0 1 0", -1.0, 0.7)}
              {"".join(feet)}
            </body>
          </body>
        </body>
      </body>"""

    def arm(side):
        """Shoulder z and x, elbow y and x, wrist y and x under the upper
        torso, hanging down; a forearm cylinder (the plane-cylinder group)
        and a hand box (the plane-box group)."""
        sy = 1.0 if side == "l" else -1.0
        h = [hinge(rng, f"{side}_{n}", a, *(r if side == "l" or n not in (
            "arm_shz", "arm_elx") else (-r[1], -r[0])))
             for n, a, r in ARM_JOINTS]
        i = {n: inertial(rng, n, -0.1 if n in ("uarm", "larm") else 0, links)
             for n in ARM_LINKS}
        return f"""
        <body name="{side}_clav" pos="0 {0.22 * sy:.4f} 0.4">
          {i["clav"]}{h[0]}
          <body name="{side}_scap" pos="0 {0.05 * sy:.4f} 0">
            {i["scap"]}{h[1]}
            <body name="{side}_uarm" pos="0 {0.05 * sy:.4f} -0.05">
              {i["uarm"]}{h[2]}
              <body name="{side}_larm" pos="0 0 -0.25">
                {i["larm"]}{h[3]}
                {cyl(f"forearm_{side}", (0, 0, -0.12), u(0.04, 0.05), 0.08)}
                <body name="{side}_ufarm" pos="0 0 -0.25">
                  {i["ufarm"]}{h[4]}
                  <body name="{side}_lfarm" pos="0 0 -0.02">
                    {i["lfarm"]}{h[5]}
                    {box(f"hand_{side}", (0, 0, -0.07),
                         (u(0.035, 0.045), 0.02, 0.05))}
                  </body>
                </body>
              </body>
            </body>
          </body>
        </body>"""

    legs = [("r", -0.11), ("l", 0.11)]
    tree = full or arms  # the back chain, which carries the arms
    joints = [f"{j}_{s}" for s, _ in legs
              for j in (("hip_rotation", "hip_adduction") if full else ())
              + ("hip_flexion", "knee_angle", "ankle_angle")]
    if tree:
        joints = ["back_bkz", "back_bky", "back_bkx"] + joints
        torso = f"""
      <body name="ltorso" pos="0 0 0.1">
        {inertial(rng, "ltorso", 0, LINKS)}
        {hinge(rng, "back_bkz", "0 0 1", -0.66, 0.66)}
        {box("ltorso", (0, 0, 0.03), (0.08, 0.1, 0.04))}
        <body name="mtorso" pos="0 0 0.08">
          {inertial(rng, "mtorso", 0, LINKS)}
          {hinge(rng, "back_bky", "0 1 0", -0.22, 0.54)}
          {box("mtorso", (0, 0, 0.03), (0.08, 0.1, 0.03))}
          <body name="utorso" pos="0 0 0.06">
            {inertial(rng, "utorso", 0.25, links)}
            {hinge(rng, "back_bkx", "1 0 0", -0.52, 0.52)}
            {box("utorso", (0, 0, 0.25), (0.15, 0.2, 0.22))}{_ARMS}
          </body>
        </body>
      </body>"""
    else:
        torso = ""
    motors = [f'<motor name="{j}_actuator" joint="{j}" gear="100" '
              f'ctrllimited="true" ctrlrange="-1 1"/>' for j in joints]
    if arms:  # in atlas.py's ARMS order
        motors += [f'<motor name="{s}_{n}_actuator" joint="{s}_{n}" '
                   f'gear="{ARM_GEAR}" ctrllimited="true" ctrlrange="-1 1"/>'
                   for s in "lr" for n, _, _ in ARM_JOINTS]
    # pelvis height: the heel discs sit 2 mm above the floor at qpos0
    height = 0.05 + 0.05 + 0.42 + 0.42 - SOLE + 0.002
    pelvis = inertial(rng, "pelvis", 0, LINKS)
    legs_xml = "".join(leg(s, y) for s, y in legs)
    torso = torso.replace(_ARMS, "".join(arm(s) for s in "lr") if arms
                          else "")
    return f"""
<mujoco model="atlas{'_arms' if arms else ''}_shape_{'full' if full else 'small'}">
  <compiler angle="radian"/>
  <option timestep="0.002" integrator="RK4" iterations="8"
          ls_iterations="8"/>
  <default>
    <joint limited="true" armature="0.01"/>
    <geom contype="2" conaffinity="1" condim="3" friction="1 0.005 0.0001"/>
  </default>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 0.05" contype="1"
          conaffinity="2"/>
    <body name="pelvis" pos="0 0 {height:.4f}">
      {pelvis}
      {root_joints()}
      {box("pelvis", (0, 0, 0), (0.1, 0.13, 0.08))}
      {torso}
      {legs_xml}
    </body>
  </worldbody>
  <actuator>
    {chr(10).join(motors)}
  </actuator>
</mujoco>"""


def jax_model(full: bool, dtype=None, arms: bool = False):
    """The fixture compiled by the JAX package's own `put_model` (plane
    budget 8 at full width, 3 small)."""
    import jax.numpy as jnp
    import mujoco

    from loco_mujoco_tpu.core.io import put_model

    mjm = mujoco.MjModel.from_xml_string(atlas_xml(full, arms=arms))
    return put_model(mjm, dtype=dtype or jnp.float64,
                     contact_k_plane=8 if full else 3)


def torch_model(full: bool, dtype=torch.float64, device="cpu",
                arms: bool = False):
    """(JAX model, port model) of the fixture, both from one compile."""
    jm = jax_model(full, arms=arms)
    leaves, aux = export_model(jm)
    return jm, tio.model_from_numpy(leaves, aux, device=device, dtype=dtype)


def write_full_width(path, arms: bool = False) -> None:
    leaves, aux = export_model(jax_model(full=True, arms=arms))
    tio.save_model_npz(path, leaves, aux)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

# (t1, t2, condim, k, pairs) of each contact group
CENSUS_FULL = [(0, 5, 3, 8, 12), (0, 6, 3, 8, 12)]
CENSUS_SMALL = [(0, 5, 3, 3, 6), (0, 6, 3, 3, 5)]


def test_atlas_fixture_census():
    """Atlas's census on the stand-in: nv 19 (the root, 3 back and 10 leg
    hinges), 13 limited hinges and motors, pyramidal cones, RK4; top-K
    plane-cylinder and plane-box groups, uniform statics: the mega plan,
    64 slots, 272 rows."""
    full = tio.load_model_npz(ASSET, device="cpu")
    assert (full.nv, full.nu, full.njnt) == (19, 13, 19)
    assert full.opt.cone == 0 and full.opt.integrator == 1
    assert (full.opt.iterations, full.opt.ls_iterations) == (8, 8)
    assert int(full.jnt_limited.sum()) == 13
    assert [full.names["joint"][n] for n, _, _ in PELVIS] == list(range(6))
    assert census(full) == CENSUS_FULL
    plan = full.plan
    assert plan.mega and plan.uniform and not plan.euler_dv
    assert [g["kind"] for g in plan.groups] == ["cyl", "box"]
    assert (plan.ncon, plan.nrows) == (64, 272)
    _, small = torch_model(full=False, dtype=torch.float32)
    assert small.nv == 12 and census(small) == CENSUS_SMALL
    assert small.plan.mega and (small.plan.ncon, small.plan.nrows) == (24, 104)
    assert os.path.getsize(ASSET) < 64 * 1024


def test_committed_atlas_npz_matches_generator(tmp_path):
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


def test_atlas_states_touch_every_group():
    """The seeded states put both groups in contact, env 0's heel discs
    upright on the floor and env 1's on their rim."""
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
    g = m.groups[0]
    assert act[:2, g.offset:g.offset + g.k * g.slots].any(axis=1).all()


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py does
    for path, arms in ((ASSET, False), (ASSET_ARMS, True)):
        write_full_width(path, arms=arms)
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
