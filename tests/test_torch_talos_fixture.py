"""The Talos-shaped fixture of the PyTorch port: generator, census, the
committed model and its seeded states.

The fixture is an inline MJCF built from a seed with numpy, Talos's
default shape (`models/humanoids/talos.py`, `Talos(disable_arms=True)`:
its XML, meshes and datasets are not in the repository): a pelvis on the
root of 3 slides and 3 hinges of `PELVIS` (`pelvis_tx, pelvis_tz,
pelvis_ty, pelvis_tilt, pelvis_list, pelvis_rotation`), a torso chain on
`back_bkz` and `back_bky` (`BACK`) and two legs of `hip_flexion`,
`hip_adduction`, `hip_rotation`, `knee_angle` and `ankle_angle` hinges
(`LEGS`), declared in the model class's `ALL_JOINTS` order less the arms
(12 limited hinges with damping, 12 motors of gear 100), pyramidal cones,
condim 3 and the env layer's solver budget (iterations 8 / ls_iterations
8). BENCH_NOTES.md names no integrator for Talos; the stand-in takes
MJCF's default, Euler, at 2 ms (the H1 stand-in's step). The model class
names no link masses, so the masses, inertias and geometry are chosen for
the stand-in (a heavy upper torso that carries the fixed arms and the
head; Talos's link lengths, thigh 0.38 m and shin 0.325 m; joint ranges
near the real robot's, the knee's lower end just below 0 so that a
straight knee does not sit on its limit). contype / conaffinity leave the
floor against the robot as the only pairs, in two groups with one margin,
solref, solimp and friction, both at k = P:

* plane-box: the pelvis and the upper torso (k 2 of 2: pairs in order);
* plane-mesh: hulls from the torque fixture's generator, per leg on the
  thigh, the knee, the shin and the foot, the feet's named `right_foot`
  and `left_foot` (the geoms Talos's `foot_groups` read, `talos.py:142`):
  8 hulls, k 8 (`contact_k_plane`'s default, 8): every pair has a slot,
  and the mega kernels rank them, deepest first, as the reference's mega
  kernels do (`pallas_fk._mesh_group_slots`).

Two sizes come from the same generator:

* full width: nv = 18, plane-box 2 pairs (k 2), plane-mesh 8 pairs (k 8):
  32 contact slots, 144 rows (12 limit rows padded to 16), the
  plane-only mega plan. Committed as
  `loco_mujoco_tpu_torch/assets/talos_shape.npz` (the `talos`
  configuration of `chip_smoke.py`, `envs.standins.load_standin("talos")`);
  regenerate it with `JAX_PLATFORMS=cpu python
  tests/test_torch_talos_fixture.py`.
* small: the back joints, hip_flexion, knee and ankle per leg (nv = 14),
  the pelvis box (k 1) and per leg a shin and a foot hull (4 hulls, k 4):
  16 slots, 72 rows, for the interpret-mode comparisons.

It is compiled by the JAX package's own `put_model`; the model arrays are
the "weights" carried across to the port.
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
from loco_mujoco_tpu_torch.core.types import GeomType  # noqa: E402
from test_torch_fixture import _hull, _same, export_model  # noqa: E402
from test_torch_h1_fixture import (PELVIS, census, hinge,  # noqa: E402
                                   inertial, root_joints)

ASSET = REPO / "loco_mujoco_tpu_torch" / "assets" / "talos_shape.npz"
SEED = 0
K_PLANE = 8  # contact_k_plane's default (core/io.py)
SOLE = -0.1  # the sole in the foot body's frame
THIGH, SHIN = 0.38, 0.325
# chosen link masses (kg) and principal inertias (kg m^2)
LINKS = {"pelvis": (13.0, (0.10, 0.05, 0.11)),
         "torso1": (3.0, (0.006, 0.005, 0.005)),
         "torso2": (40.0, (1.2, 1.0, 0.5)),
         "thigh": (7.5, (0.15, 0.15, 0.03)),
         "shin": (4.5, (0.07, 0.07, 0.01)),
         "foot": (1.6, (0.002, 0.006, 0.006))}
# Talos's back and leg joints (talos.py BACK, LEGS), their axes and chosen
# ranges (the right leg's hip rotation mirrors the left's)
BACK = (("back_bkz", "0 0 1", (-1.309, 1.309)),
        ("back_bky", "0 1 0", (-0.2618, 0.7854)))
HIP = (("hip_flexion", "0 1 0", (-2.095, 0.7)),
       ("hip_adduction", "1 0 0", (-0.5236, 0.5236)),
       ("hip_rotation", "0 0 1", (-0.3491, 1.5708)))
KNEE = ("knee_angle", "0 1 0", (-0.2, 2.618))
ANKLE = ("ankle_angle", "0 1 0", (-1.27, 0.68))
GEAR = 100


def talos_xml(full: bool, seed: int = SEED) -> str:
    """The fixture's MJCF (see the module note)."""
    rng = np.random.default_rng(seed)
    assets = []

    def hull(name, pos, semi_lo, semi_hi, flat=1.0, sole=False):
        """A hull from the torque fixture's generator (8k vertices on an
        ellipsoid), its z semi-axis scaled by `flat`; `sole`: its centre
        that semi-axis above `pos`, so that it reaches down to pos's
        height."""
        semi = rng.uniform(semi_lo, semi_hi, size=3) * (1, 1, flat)
        n = 8 * int(rng.integers(5, 20))
        assets.append(f'<mesh name="{name}" vertex="{_hull(rng, semi, n)}"/>')
        z = pos[2] + (semi[2] if sole else 0.0)
        return (f'<geom name="{name}" type="mesh" mesh="{name}" '
                f'pos="{pos[0]:.4f} {pos[1]:.4f} {z:.4f}"/>')

    def box(name, pos, size):
        return (f'<geom name="{name}" type="box" size="{size[0]:.4f} '
                f'{size[1]:.4f} {size[2]:.4f}" pos="{pos[0]:.4f} '
                f'{pos[1]:.4f} {pos[2]:.4f}"/>')

    def leg(side, y):
        long = "right" if side == "r" else "left"
        hips = HIP if full else HIP[:1]
        h = "".join(hinge(rng, f"{n}_{side}", a, *(
            r if side == "l" or n != "hip_rotation" else (-r[1], -r[0])))
            for n, a, r in hips)
        thigh = (hull(f"thigh_{side}", (0, 0, -0.18), 0.05, 0.08)
                 + hull(f"knee_{side}", (0.04, 0, -THIGH + 0.02), 0.03, 0.05)
                 if full else "")
        return f"""
      <body name="thigh_{side}" pos="0 {y:.4f} -0.05">
        {inertial(rng, "thigh", -0.18, LINKS)}
        {h}
        {thigh}
        <body name="shin_{side}" pos="0 0 {-THIGH:.4f}">
          {inertial(rng, "shin", -0.15, LINKS)}
          {hinge(rng, f"{KNEE[0]}_{side}", KNEE[1], *KNEE[2])}
          {hull(f"shin_{side}", (0, 0, -0.16), 0.04, 0.06)}
          <body name="foot_{side}" pos="0 0 {-SHIN:.4f}">
            {inertial(rng, "foot", -0.05, LINKS)}
            {hinge(rng, f"{ANKLE[0]}_{side}", ANKLE[1], *ANKLE[2])}
            {hull(f"{long}_foot", (0.03, 0, SOLE), 0.09, 0.12, flat=0.25,
                  sole=True)}
          </body>
        </body>
      </body>"""

    legs = [("r", -0.085), ("l", 0.085)]
    joints = [n for n, _, _ in BACK] + [
        f"{n}_{s}" for s, _ in legs
        for n in [j for j, _, _ in (HIP if full else HIP[:1])]
        + [KNEE[0], ANKLE[0]]]
    torso = f"""
      <body name="torso_1_link" pos="0 0 0.1">
        {inertial(rng, "torso1", 0, LINKS)}
        {hinge(rng, BACK[0][0], BACK[0][1], *BACK[0][2])}
        <body name="torso_2_link" pos="0 0 0.05">
          {inertial(rng, "torso2", 0.25, LINKS)}
          {hinge(rng, BACK[1][0], BACK[1][1], *BACK[1][2])}
          {box("torso_2", (0, 0, 0.25), (0.12, 0.17, 0.2)) if full else ""}
        </body>
      </body>"""
    motors = [f'<motor name="{j}_actuator" joint="{j}" gear="{GEAR}" '
              f'ctrllimited="true" ctrlrange="-1 1"/>' for j in joints]
    # pelvis height: the sole, where the feet's hulls reach down to, 2 mm
    # above the floor at qpos0
    height = 0.05 + THIGH + SHIN - SOLE + 0.002
    pelvis = inertial(rng, "pelvis", 0, LINKS)
    legs_xml = "".join(leg(s, y) for s, y in legs)
    return f"""
<mujoco model="talos_shape_{'full' if full else 'small'}">
  <compiler angle="radian"/>
  <option timestep="0.002" integrator="Euler" iterations="8"
          ls_iterations="8"/>
  <default>
    <joint limited="true" armature="0.01"/>
    <geom contype="2" conaffinity="1" condim="3" friction="1 0.005 0.0001"/>
  </default>
  <asset>
    {chr(10).join(assets)}
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 0.05" contype="1"
          conaffinity="2"/>
    <body name="pelvis" pos="0 0 {height:.4f}">
      {pelvis}
      {root_joints()}
      {box("base_link", (0, 0, 0), (0.1, 0.14, 0.08))}
      {torso}
      {legs_xml}
    </body>
  </worldbody>
  <actuator>
    {chr(10).join(motors)}
  </actuator>
</mujoco>"""


def jax_model(full: bool, dtype=None):
    """The fixture compiled by the JAX package's own `put_model` (plane
    budget 8 at both sizes: k = P for every group)."""
    import jax.numpy as jnp
    import mujoco

    from loco_mujoco_tpu.core.io import put_model

    mjm = mujoco.MjModel.from_xml_string(talos_xml(full))
    return put_model(mjm, dtype=dtype or jnp.float64,
                     contact_k_plane=K_PLANE)


def torch_model(full: bool, dtype=torch.float64, device="cpu"):
    """(JAX model, port model) of the fixture, both from one compile."""
    jm = jax_model(full)
    leaves, aux = export_model(jm)
    return jm, tio.model_from_numpy(leaves, aux, device=device, dtype=dtype)


def talos_states(model, E: int, seed: int = 7, drop=(0.005, 0.015)):
    """(qpos, qvel, ctrl) numpy arrays of E seeded states in light contact:
    qpos0 with joint noise, the pelvis dropped by `drop` (the feet's hulls
    pressed into the floor at depths that differ per foot), small
    velocities and ctrls in [-0.3, 0.3]; except env 0, which stands with
    every hinge at 0, and env 1, fallen on its front (pelvis_tilt 1.62:
    the torso box lowest), each dropped so that its deepest slot lies 5 mm
    deep."""
    from loco_mujoco_tpu_torch.ops import collision, kinematics

    rng = np.random.default_rng(seed)
    jid = model.names["joint"]
    adr = lambda n: int(model.jnt_qposadr[jid[n]])  # noqa: E731
    qpos0 = np.asarray(model.qpos0, np.float64)
    z = adr("pelvis_tz")
    qpos = qpos0[None] + rng.normal(scale=0.02, size=(E, model.nq))
    qpos[:, z] = qpos0[z] - rng.uniform(*drop, size=E)
    special = qpos0[None].repeat(2, axis=0)
    special[1, adr("pelvis_tilt")] = 1.62
    m64 = model.to(dtype=torch.float64)
    d = tio.make_data(m64, 2).replace(qpos=torch.as_tensor(special))
    dist = collision.collision(m64, kinematics.kinematics(m64, d)) \
        .contact.dist.numpy()
    special[:, z] -= dist.min(axis=1) + 0.005
    qpos[:min(E, 2)] = special[:min(E, 2)]
    qvel = rng.normal(scale=0.1, size=(E, model.nv))
    qvel[:min(E, 2)] = 0.0
    ctrl = rng.uniform(-0.3, 0.3, size=(E, model.nu))
    return qpos, qvel, ctrl


def talos_mega_states(monkeypatch, n_envs: int, seed: int = 7):
    """(JAX model, port model, JAX data, port data) in float32 for the mega
    path tests, small variant: `talos_states`, the JAX plan built afresh
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

    leaves, aux = export_model(jax_model(False))
    tm = tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float32)
    monkeypatch.setenv("LMT_MESH_VCAP", str(max(tm.mesh_vert.shape[1], 8)))
    monkeypatch.setattr(pc, "_PLAN_CACHE", {})
    jm = jax_model(False, dtype=jnp.float32)
    qpos, qvel, ctrl = (np.asarray(x, np.float32)
                        for x in talos_states(tm, n_envs, seed))
    d0 = jax_make_data(jm)
    jd = jax.jit(jax.vmap(lambda q, v, u: jcoll.collision(
        jm, jkin.kinematics(jm, d0.replace(qpos=q, qvel=v, ctrl=u)))))(
            qpos, qvel, ctrl)
    t = torch.as_tensor
    td = tio.make_data(tm, n_envs).replace(qpos=t(qpos), qvel=t(qvel),
                                           ctrl=t(ctrl))
    return jm, tm, jd, td


def write_full_width(path) -> None:
    leaves, aux = export_model(jax_model(full=True))
    tio.save_model_npz(path, leaves, aux)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

# (t1, t2, condim, k, pairs) of each contact group
CENSUS_FULL = [(0, 6, 3, 2, 2), (0, 7, 3, 8, 8)]
CENSUS_SMALL = [(0, 6, 3, 1, 1), (0, 7, 3, 4, 4)]
# Talos's joints in `talos.py` ALL_JOINTS order, the arms left out
ALL_JOINTS = ([n for n, _, _ in PELVIS] + ["back_bkz", "back_bky"]
              + [f"{j}_{s}" for s in "rl" for j in (
                  "hip_flexion", "hip_adduction", "hip_rotation",
                  "knee_angle", "ankle_angle")])


def test_talos_fixture_census():
    """Talos's census on the stand-in: nv 18 in ALL_JOINTS order less the
    arms, 12 limited hinges and motors, pyramidal cones, Euler; a
    plane-box group and a plane-mesh group at k = P (off the staged
    kernels: `Model.mesh_kernel` None), uniform statics: the plane-only
    mega plan with the mesh group's tables, 32 slots, 144 rows."""
    full = tio.load_model_npz(ASSET, device="cpu")
    assert (full.nv, full.nu, full.njnt) == (18, 12, 18)
    assert full.opt.cone == 0 and full.opt.integrator == 0
    assert (full.opt.iterations, full.opt.ls_iterations) == (8, 8)
    assert int(full.jnt_limited.sum()) == 12
    assert sorted(full.names["joint"], key=full.names["joint"].get) \
        == ALL_JOINTS
    assert census(full) == CENSUS_FULL
    assert full.mesh_kernel == (None, None)
    geoms = full.names["geom"]
    mesh = full.groups[1]
    assert {geoms["right_foot"], geoms["left_foot"]} <= set(
        int(g) for g in full.pair_geom2[mesh.pair_ids])
    plan = full.plan
    assert plan.mega and plan.uniform and plan.euler_dv and not plan.mega_ell
    assert [g["kind"] for g in plan.groups] == ["box", "mesh"]
    assert plan.mesh is plan.groups[1]["mesh"] and plan.mesh.k == 8 == \
        plan.mesh.P
    assert (plan.ncon, plan.nrows) == (32, 144)
    _, small = torch_model(full=False, dtype=torch.float32)
    assert small.nv == 14 and census(small) == CENSUS_SMALL
    assert small.plan.mega and (small.plan.ncon, small.plan.nrows) == (16, 72)
    assert small.mesh_kernel == (None, None)
    assert os.path.getsize(ASSET) < 256 * 1024


def test_committed_talos_npz_matches_generator(tmp_path):
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


def test_talos_states_touch_both_feet():
    """The seeded states put both groups in contact, and both feet's
    hulls in contact together in most envs, at depths that differ (so the
    ranked slot order of the mega kernels is not the pair order)."""
    from loco_mujoco_tpu_torch.ops import collision, kinematics

    m = tio.load_model_npz(ASSET, device="cpu", dtype=torch.float64)
    qpos, qvel, _ = talos_states(m, 64)
    d = tio.make_data(m, 64).replace(qpos=torch.as_tensor(qpos),
                                     qvel=torch.as_tensor(qvel))
    d = collision.collision(m, kinematics.kinematics(m, d))
    act = (d.contact.dist < d.contact.includemargin).numpy()
    for g in m.groups:
        assert act[:, g.offset:g.offset + g.k * g.slots].any(), g[:3]
    g = m.groups[1]
    assert int(m.geom_type[m.pair_geom2[g.pair_ids[0]]]) == int(
        GeomType.MESH)
    geom2 = d.contact.geom2.numpy()[0]  # k = P: every pair, one layout
    foot = [g.offset + int(np.nonzero(geom2[g.offset:] == m.names["geom"][
        f"{s}_foot"])[0][0]) for s in ("right", "left")]
    both = act[:, foot[0]] & act[:, foot[1]]
    assert both.mean() > 0.5
    depth = d.contact.dist.numpy()
    assert np.all(depth[both, foot[0]] != depth[both, foot[1]])


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py does
    write_full_width(ASSET)
    print(f"wrote {ASSET} ({os.path.getsize(ASSET)} bytes)")
