"""The UnitreeA1-shaped fixture of the PyTorch port: generator, census and
the committed model.

The fixture is an inline MJCF built from a seed with numpy, A1's shape
(its XML, meshes and datasets are not in the repository), with A1's link
masses and inertias: a box trunk on
A1's root of 3 slides and 3 hinges (`trunk_tx, trunk_ty, trunk_tz,
trunk_list, trunk_tilt, trunk_rotation`), four legs of hip, thigh and calf
hinges (12 limited hinges with damping and friction loss, 12 motors of
gear 34), elliptic cones with impratio 100, Euler at 2 ms and the env
layer's solver budget (iterations 8 / ls_iterations 8). Each leg carries a
hip cylinder, a thigh cylinder and capsule, two calf capsules and a foot
sphere (`FL_foot`, ...) of condim 6; every other geom has condim 3, so
every pair with a foot is condim 6. contype / conaffinity give one contact
group of every classic analytic kind but plane-mesh:

* against the plane: sphere (the feet), capsule, cylinder, box (the trunk);
* self pairs: sphere-sphere (foot-foot), sphere-capsule (a foot against
  the other legs' lower calves), sphere-box (a foot against the trunk),
  capsule-capsule (lower calves).

No pair is convex (GJK; `collision.CONVEX_SLOTS`). Two sizes come from the
same generator:

* full width: nv = 18, 76 contact slots (16 of them condim 6), 300 rows,
  the census A1 is cited at (nv 18, 306 rows, 76 slots). Committed as
  `loco_mujoco_tpu_torch/assets/unitree_a1_shape.npz` (the model
  `chip_smoke.py` runs); regenerate it and the position stand-in with
  `JAX_PLATFORMS=cpu python tests/test_torch_a1_fixture.py`.
* small: two diagonal legs (nv = 12), plane budget 2 and self budget 1, so
  every group keeps its kind and most take the top-K path (k < P): 23
  slots, 100 rows, for the interpret-mode comparisons.

The actuators come in three modes (`MODES`): A1's torque motors; its
position mode (`UnitreeA1(action_mode="position")` loads
`unitree_a1_position.xml` in the reference, which is not in the
repository): a position servo per leg joint as MuJoCo compiles `<position
kp>` with a velocity term, fixed gain KP, affine bias (0, -KP, -KV), the
ctrl a target angle in the joint's range, the force limited to A1's 33.5 N
m, committed at full width as
`loco_mujoco_tpu_torch/assets/unitree_a1_position_shape.npz`; and, small
only, an all-terms variant (`ALL_TERMS`: affine gain and bias, filter,
FILTEREXACT and integrator activations). KP and KV were chosen on the CPU:
the JAX package's float64 path stays bounded under Euler at 2 ms over the
smoke's 20 control steps with targets redrawn uniform in the joint ranges
each step (leg speeds below 50 rad/s), and KV dt over the lightest joint's
inertia (the calf with its armature, ~0.015 kg m^2) is ~0.2.

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
if str(REPO) not in sys.path:  # direct `python tests/test_torch_a1_fixture.py`
    sys.path.insert(0, str(REPO))

from loco_mujoco_tpu_torch.core import io as tio  # noqa: E402
from test_torch_fixture import _same, export_model  # noqa: E402

ASSET = REPO / "loco_mujoco_tpu_torch" / "assets" / "unitree_a1_shape.npz"
POSITION_ASSET = ASSET.with_name("unitree_a1_position_shape.npz")
SEED = 0
LEGS = {"FR": (1, -1), "FL": (1, 1), "RR": (-1, -1), "RL": (-1, 1)}
SMALL_LEGS = ("FL", "RR")
HEIGHT = 0.42  # trunk centre above the foot bottoms at qpos0
# A1's link masses (kg) and principal inertias (kg m^2), from its URDF
A1_LINKS = {"trunk": (4.713, (0.0168, 0.0566, 0.0647)),
            "hip": (0.696, (0.00047, 0.00081, 0.00055)),
            "thigh": (1.013, (0.00553, 0.00514, 0.00137)),
            "calf": (0.166, (0.00300, 0.00301, 0.0000325))}

# the leg joints' ranges (rad), which are the position servos' ctrlranges
JOINT_RANGE = {"hip": (-0.8, 0.8), "thigh": (-1.0, 3.0), "calf": (-2.7, 0.3)}
# the position servos (`MODES`): stiffness kp (N m / rad), damping kv
# (N m s / rad) and the force limit (N m, A1's torque limit)
KP, KV, FORCE = 60.0, 1.5, 33.5
# the all-terms variant's six actuators (small size: FL then RR, hip, thigh,
# calf): affine gain and bias with all six prms nonzero, a filter with
# actlimited, a FILTEREXACT, an integrator, a position servo and an affine
# gain without bias
ALL_TERMS = (
    'gaintype="affine" gainprm="20 -3 -0.4" biastype="affine" '
    'biasprm="0.5 -25 -1.2" ctrllimited="true" ctrlrange="-1 1"',
    'dyntype="filter" dynprm="0.03" gaintype="affine" gainprm="15 2 -0.3" '
    'biastype="affine" biasprm="-0.4 -20 -0.8" actlimited="true" '
    'actrange="-0.5 0.8" ctrllimited="true" ctrlrange="-1 1"',
    'dyntype="filterexact" dynprm="0.05" gaintype="fixed" gainprm="18" '
    'biastype="affine" biasprm="0.3 -12 -0.5" ctrllimited="true" '
    'ctrlrange="-1 1" forcelimited="true" forcerange="-20 20"',
    'dyntype="integrator" gaintype="fixed" gainprm="10" biastype="affine" '
    'biasprm="0.2 -8 -0.6" ctrllimited="true" ctrlrange="-1 1" '
    'actlimited="true" actrange="-1 1"',
    f'gaintype="fixed" gainprm="{KP}" biastype="affine" '
    f'biasprm="0 {-KP} {-KV}" ctrllimited="true" ctrlrange="-1 3"',
    'gaintype="affine" gainprm="12 1.5 -0.2" ctrllimited="true" '
    'ctrlrange="-1 1"')
# the actuators of `a1_xml`: A1's torque motors (gear 34, ctrl in [-1, 1]),
# its position mode (`<position kp>` with a velocity term as MuJoCo compiles
# it: fixed gain kp, affine bias (0, -kp, -kv), the ctrl a target angle in
# the joint's range, the force limited), and the all-terms variant
MODES = ("torque", "position", "all_terms")

# contype / conaffinity bits: 1 the floor, 2 the feet, 4 the lower calves
# (the floor collides with everything; feet with feet, lower calves and the
# trunk; lower calves with each other)
_FLOOR = 'contype="1" conaffinity="0"'
_FOOT = 'contype="2" conaffinity="3"'
_LOWER = 'contype="4" conaffinity="7"'
_TRUNK = 'contype="0" conaffinity="3"'
_OTHER = 'contype="0" conaffinity="1"'


def a1_xml(full: bool, seed: int = SEED, mode: str = "torque") -> str:
    """The fixture's MJCF (see the module note); `mode` the actuators
    (`MODES`: the torque motors, the position servos, or the all-terms
    variant of the small size)."""
    rng = np.random.default_rng(seed)

    def u(lo, hi):
        return float(rng.uniform(lo, hi))

    def inertial(link, z=0.0):
        """A1's link mass and principal inertias (its URDF), scaled by one
        factor within +-10%."""
        mass, diag = A1_LINKS[link]
        f = u(0.9, 1.1)
        mass *= f
        i = [v * f for v in diag]
        return (f'<inertial pos="0 0 {z:.4f}" mass="{mass:.4f}" '
                f'diaginertia="{i[0]:.7f} {i[1]:.7f} {i[2]:.7f}"/>')

    def hinge(name, axis, lo, hi):
        return (f'<joint name="{name}" axis="{axis}" range="{lo} {hi}" '
                f'damping="{u(0.5, 1.5):.3f}" '
                f'frictionloss="{u(0.1, 0.3):.3f}"/>')

    def leg(name, sx, sy):
        hip_r, cyl_len = u(0.04, 0.05), u(0.018, 0.024)
        return f"""
      <body name="{name}_hip" pos="{0.183 * sx:.4f} {0.047 * sy:.4f} 0">
        {inertial("hip")}
        {hinge(f"{name}_hip_joint", "1 0 0", -0.8, 0.8)}
        <geom name="{name}_hip" type="cylinder" size="{hip_r:.4f} {cyl_len:.4f}"
              quat="0.70710678 0.70710678 0 0" {_OTHER}/>
        <body name="{name}_thigh" pos="0 {0.08 * sy:.4f} 0">
          {inertial("thigh", -0.03)}
          {hinge(f"{name}_thigh_joint", "0 1 0", -1.0, 3.0)}
          <geom name="{name}_thigh_rotor" type="cylinder"
                size="{u(0.03, 0.04):.4f} {u(0.012, 0.018):.4f}"
                pos="0 {-0.02 * sy:.4f} -0.02"
                quat="0.70710678 0.70710678 0 0" {_OTHER}/>
          <geom name="{name}_thigh" type="capsule" size="{u(0.018, 0.024):.4f}"
                fromto="0 0 -0.03 0 0 -0.17" {_OTHER}/>
          <body name="{name}_calf" pos="0 0 -0.2">
            {inertial("calf", -0.1)}
            {hinge(f"{name}_calf_joint", "0 1 0", -2.7, 0.3)}
            <geom name="{name}_calf_upper" type="capsule"
                  size="{u(0.012, 0.016):.4f}" fromto="0 0 -0.01 0 0 -0.09"
                  {_OTHER}/>
            <geom name="{name}_calf_lower" type="capsule"
                  size="{u(0.011, 0.014):.4f}" fromto="0 0 -0.1 0 0 -0.17"
                  {_LOWER}/>
            <geom name="{name}_foot" type="sphere" size="0.02" pos="0 0 -0.2"
                  condim="6" friction="0.8 0.02 0.01" {_FOOT}/>
          </body>
        </body>
      </body>"""

    legs = [n for n in LEGS if full or n in SMALL_LEGS]
    motors = [actuator(mode, i, n, j)
              for i, (n, j) in enumerate((n, j) for n in legs
                                         for j in ("hip", "thigh", "calf"))]
    root = "\n".join(
        f'<joint name="trunk_{n}" type="{t}" axis="{a}" limited="false" '
        f'damping="0" armature="0" frictionloss="0"/>'
        for n, t, a in (("tx", "slide", "1 0 0"), ("ty", "slide", "0 1 0"),
                        ("tz", "slide", "0 0 1"), ("list", "hinge", "1 0 0"),
                        ("tilt", "hinge", "0 1 0"),
                        ("rotation", "hinge", "0 0 1")))
    name = "" if mode == "torque" else f"_{mode}"
    return f"""
<mujoco model="unitree_a1{name}_shape_{'full' if full else 'small'}">
  <compiler angle="radian"/>
  <option timestep="0.002" integrator="Euler" cone="elliptic"
          impratio="100" iterations="8" ls_iterations="8"/>
  <default>
    <joint limited="true" armature="0.01"/>
    <geom condim="3" friction="1 0.005 0.0001"/>
  </default>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 0.05" {_FLOOR}/>
    <body name="trunk" pos="0 0 {HEIGHT + 0.002:.4f}">
      {inertial("trunk")}
      {root}
      <geom name="trunk" type="box" size="0.1335 0.097 0.057" {_TRUNK}/>
      {"".join(leg(n, *LEGS[n]) for n in legs)}
    </body>
  </worldbody>
  <actuator>
    {chr(10).join(motors)}
  </actuator>
</mujoco>"""


def actuator(mode: str, i: int, leg: str, joint: str) -> str:
    """The MJCF of leg joint `joint`'s actuator, the i-th (see `MODES`)."""
    name = f'name="{leg}_{joint}" joint="{leg}_{joint}_joint"'
    if mode == "torque":
        return f'<motor {name} gear="34" ctrllimited="true" ctrlrange="-1 1"/>'
    lo, hi = JOINT_RANGE[joint]
    servo = (f'gaintype="fixed" gainprm="{KP}" biastype="affine" '
             f'biasprm="0 {-KP} {-KV}" ctrllimited="true" '
             f'ctrlrange="{lo} {hi}" forcelimited="true" '
             f'forcerange="{-FORCE} {FORCE}"')
    if mode == "position":
        return f"<general {name} {servo}/>"
    return f"<general {name} {ALL_TERMS[i]}/>"


def jax_model(full: bool, dtype=None, mode: str = "torque"):
    """The fixture compiled by the JAX package's own `put_model` (plane
    budget 8 and self budget 4 at full width, 2 and 1 small)."""
    import jax.numpy as jnp
    import mujoco

    from loco_mujoco_tpu.core.io import put_model

    mjm = mujoco.MjModel.from_xml_string(a1_xml(full, mode=mode))
    return put_model(mjm, dtype=dtype or jnp.float64,
                     contact_k_plane=8 if full else 2,
                     contact_k_other=4 if full else 1)


def torch_model(full: bool, dtype=torch.float64, device="cpu",
                mode: str = "torque"):
    """(JAX model, port model) of the fixture, both from one compile."""
    jm = jax_model(full, mode=mode)
    leaves, aux = export_model(jm)
    return jm, tio.model_from_numpy(leaves, aux, device=device, dtype=dtype)


def a1_states(model, E: int, seed: int = 7, drop=(0.005, 0.015)):
    """(qpos, qvel, ctrl) numpy arrays of E seeded states in light contact.
    Half stand: qpos0 with joint noise, the trunk lowered by `drop` (the
    feet pressed into the floor). A quarter have their legs in contact
    with each other or the trunk (joint angles drawn within range until a
    self pair touches, at most 20 mm deep), a quarter lie tipped over
    (trunk list and tilt, joint angles drawn within range); both then sit
    on the floor 2-12 mm deep at their lowest slot, so that the legs, hips
    and trunk touch it."""
    from loco_mujoco_tpu_torch.ops import collision, kinematics

    rng = np.random.default_rng(seed)
    jid = model.names["joint"]
    adr = lambda n: int(model.jnt_qposadr[jid[n]])  # noqa: E731
    qpos0 = np.asarray(model.qpos0, np.float64)
    hinges = [j for j in jid if not j.startswith("trunk_")]
    rng_lo = np.asarray(model.jnt_range[:, 0], np.float64)
    rng_hi = np.asarray(model.jnt_range[:, 1], np.float64)
    m64 = model.to(dtype=torch.float64)

    def contact(q):
        d = tio.make_data(m64, len(q)).replace(qpos=torch.as_tensor(q))
        c = collision.collision(m64, kinematics.kinematics(m64, d)).contact
        return c.dist.numpy(), np.asarray(
            [g.t1 == 0 for g in m64.groups for _ in range(g.k * g.slots)])

    def draw(n, tipped):
        q = np.repeat(qpos0[None], n, axis=0)
        for j in hinges:
            q[:, adr(j)] = rng.uniform(rng_lo[jid[j]], rng_hi[jid[j]], size=n)
        if tipped:
            q[:, adr("trunk_list")] = rng.uniform(-3.1, 3.1, size=n)
            q[:, adr("trunk_tilt")] = rng.uniform(-0.6, 0.6, size=n)
        return q

    n_self = E // 4
    n_tip = E // 4
    n_stand = E - n_self - n_tip
    q_stand = qpos0[None] + rng.normal(scale=0.05, size=(n_stand, model.nq))
    q_stand[:, adr("trunk_tz")] = qpos0[adr("trunk_tz")] - rng.uniform(
        *drop, size=n_stand)
    picked = []
    while sum(len(p) for p in picked) < n_self:
        q = draw(256, False)
        dist, plane = contact(q)
        ds = dist[:, ~plane].min(axis=1)
        picked.append(q[(ds < 0) & (ds > -0.02)])
    q_self = np.concatenate(picked)[:n_self] \
        if picked else np.zeros((0, model.nq))
    q_low = np.concatenate([q_self, draw(n_tip, True)])
    dist, plane = contact(q_low)
    q_low[:, adr("trunk_tz")] -= (dist[:, plane].min(axis=1)
                                  + rng.uniform(0.002, 0.012, size=len(q_low)))
    qpos = np.concatenate([q_stand, q_low])[rng.permutation(E)]
    qvel = rng.normal(scale=0.1, size=(E, model.nv))
    ctrl = rng.uniform(-0.5, 0.5, size=(E, model.nu))
    return qpos, qvel, ctrl


def servo_targets(model, E: int, seed: int = 9):
    """(E, nu) seeded position-servo targets, uniform in each actuator's
    ctrlrange (the leg joints' ranges)."""
    cr = np.asarray(model.actuator_ctrlrange, np.float64)
    return np.random.default_rng(seed).uniform(cr[:, 0], cr[:, 1],
                                               size=(E, model.nu))


def ell_states(n_envs: int, full: bool = False, seed: int = 7,
               mode: str = "torque"):
    """(JAX model, port model, JAX data, port data) in float32 for the
    interpret-mode comparisons: `a1_states` of the fixture (the position
    servos' ctrls `servo_targets`), the JAX data with its contacts and dims
    from one collision pass, as the env's reset does. Call inside
    `jax.enable_x64(False)`."""
    import jax
    import jax.numpy as jnp

    from loco_mujoco_tpu.core.io import make_data as jax_make_data
    from loco_mujoco_tpu.ops import collision as jcoll
    from loco_mujoco_tpu.ops import kinematics as jkin

    leaves, aux = export_model(jax_model(full, mode=mode))
    tm = tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float32)
    jm = jax_model(full, dtype=jnp.float32, mode=mode)
    qpos, qvel, ctrl = a1_states(tm, n_envs, seed)
    if mode != "torque":
        ctrl = servo_targets(tm, n_envs)
    qpos, qvel, ctrl = (np.asarray(x, np.float32) for x in (qpos, qvel, ctrl))
    d0 = jax_make_data(jm)
    jd = jax.jit(jax.vmap(lambda q, v, u: jcoll.collision(
        jm, jkin.kinematics(jm, d0.replace(qpos=q, qvel=v, ctrl=u)))))(
            qpos, qvel, ctrl)
    t = torch.as_tensor
    td = tio.make_data(tm, n_envs).replace(qpos=t(qpos), qvel=t(qvel),
                                           ctrl=t(ctrl))
    return jm, tm, jd, td


def write_full_width(path, mode: str = "torque") -> None:
    leaves, aux = export_model(jax_model(full=True, mode=mode))
    tio.save_model_npz(path, leaves, aux)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

# (t1, t2, condim, k, pairs) of each contact group
CENSUS_FULL = [(0, 2, 6, 4, 4), (0, 3, 3, 8, 12), (0, 5, 3, 8, 8),
               (0, 6, 3, 1, 1), (2, 2, 6, 4, 6), (2, 3, 6, 4, 12),
               (2, 6, 6, 4, 4), (3, 3, 3, 4, 6)]
CENSUS_SMALL = [(0, 2, 6, 2, 2), (0, 3, 3, 2, 6), (0, 5, 3, 2, 4),
                (0, 6, 3, 1, 1), (2, 2, 6, 1, 1), (2, 3, 6, 1, 2),
                (2, 6, 6, 1, 2), (3, 3, 3, 1, 1)]


def _census(m):
    return [(g.t1, g.t2, g.condim, g.k, len(g.pair_ids)) for g in m.groups]


def test_a1_fixture_census():
    """A1's census on the stand-in: nv 18, 12 limited hinges with friction
    loss, 12 motors of gear 34, elliptic cones at impratio 100, Euler; one
    group of every classic pair kind but plane-mesh, none convex; 76 slots
    and 300 rows with `ell_runs` over the condim 6 / 3 runs, on the mega
    path with the extended collision (`mega_ell`)."""
    from loco_mujoco_tpu_torch.ops import collision

    full = tio.load_model_npz(ASSET, device="cpu")
    assert (full.nv, full.nu, full.njnt) == (18, 12, 18)
    assert full.opt.cone == 1 and full.opt.integrator == 0
    assert float(full.opt.impratio) == 100.0
    assert (full.opt.iterations, full.opt.ls_iterations) == (8, 8)
    assert int(full.jnt_limited.sum()) == 12
    assert int((full.dof_frictionloss > 0).sum()) == 12
    assert np.all(full.actuator_gear[:, 0].numpy() == 34)
    assert [full.names["joint"][n] for n in (
        "trunk_tx", "trunk_ty", "trunk_tz", "trunk_list", "trunk_tilt",
        "trunk_rotation")] == list(range(6))
    assert {f"{n}_foot" for n in LEGS} <= set(full.names["geom"])
    assert _census(full) == CENSUS_FULL
    assert not any(g.convex for g in full.groups)
    assert collision.classic_ncon(full.groups, full.ncon) == full.ncon == 76
    plan = full.plan
    assert plan is not None and plan.elliptic and plan.mega_ell
    assert (plan.ncon, plan.nrows, plan.pack_w) == (76, 300, 29)
    assert plan.ell_runs == ((24, 4, 6), (48, 52, 3), (204, 12, 6),
                             (276, 8, 3))
    _, small = torch_model(full=False, dtype=torch.float32)
    assert small.nv == 12 and _census(small) == CENSUS_SMALL
    assert (small.plan.ncon, small.plan.nrows) == (23, 100)
    assert small.plan.mega_ell
    assert os.path.getsize(ASSET) < 256 * 1024


def test_committed_a1_npz_matches_generator(tmp_path):
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


def test_committed_a1_position_npz_matches_generator(tmp_path):
    """Drift test of the committed position stand-in, leaf for leaf."""
    fresh = tmp_path / "fresh.npz"
    write_full_width(fresh, "position")
    got_l, got_a = tio.read_model_npz(fresh)
    ref_l, ref_a = tio.read_model_npz(POSITION_ASSET)
    assert got_l.keys() == ref_l.keys() and got_a.keys() == ref_a.keys()
    for k in ref_l:
        np.testing.assert_array_equal(got_l[k], ref_l[k], err_msg=k)
    for k in ref_a:
        assert _same(got_a[k], ref_a[k]), k


def test_a1_position_census_and_plan():
    """A1's position mode on the stand-in: the torque stand-in's tree,
    contacts and rows, with 12 position servos (gear 1, fixed gain KP,
    affine bias (0, -KP, -KV), the ctrlrange each joint's range, the force
    limited to FORCE); its plan is the extended elliptic one (`mega_ell`)
    and its actuator table carries each servo's qpos address, gain and
    bias (`sm_acts`, F_ACT / I_ACT)."""
    from loco_mujoco_tpu_torch.ops import plan as plan_mod

    m = tio.load_model_npz(POSITION_ASSET, device="cpu")
    torque = tio.load_model_npz(ASSET, device="cpu")
    assert (m.nv, m.nu, m.na) == (18, 12, 0)
    assert _census(m) == _census(torque) == CENSUS_FULL
    np.testing.assert_array_equal(m.actuator_gear[:, 0].numpy(), 1.0)
    np.testing.assert_array_equal(m.actuator_gainprm[:, :3].numpy(),
                                  np.float32([[KP, 0, 0]] * 12))
    np.testing.assert_array_equal(m.actuator_biasprm[:, :3].numpy(),
                                  np.float32([[0, -KP, -KV]] * 12))
    jnt = m.actuator_trnid[:, 0]
    assert bool((m.actuator_ctrlrange == m.jnt_range[jnt]).all())
    assert m.actuator_forcelimited.all() and bool(
        (m.actuator_forcerange == torch.tensor([-FORCE, FORCE])).all())
    p = m.plan
    assert p.mega and p.mega_ell and p.elliptic and p.smooth
    assert (p.ncon, p.nrows, p.pack_w) == (76, 300, 29)
    assert [(a["u"], a["q"], a["v"]) for a in p.sm_acts] == [
        (u, int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j]))
        for u, j in enumerate(jnt)]
    assert all(a["b_affine"] and not a["g_affine"] for a in p.sm_acts)
    ints, flts = p.pack()
    hdr = {k: int(ints[plan_mod.H[k]]) for k in ("F_ACT", "I_ACT")}
    f_act = flts[hdr["F_ACT"]:hdr["F_ACT"] + 12 * 12].reshape(12, 12)
    i_act = ints[hdr["I_ACT"]:hdr["I_ACT"] + 8 * 12].reshape(12, 8)
    np.testing.assert_array_equal(f_act[:, 6:11], np.float32(
        [[0, 0, 0, -KP, -KV]] * 12))
    np.testing.assert_array_equal(i_act[:, 4:7], [[a["q"], 0, 1]
                                                  for a in p.sm_acts])


def test_a1_states_touch_every_group():
    """The seeded states put every group's slots in contact somewhere."""
    from loco_mujoco_tpu_torch.ops import collision, kinematics

    m = tio.load_model_npz(ASSET, device="cpu", dtype=torch.float64)
    qpos, qvel, _ = a1_states(m, 256)
    d = tio.make_data(m, 256).replace(qpos=torch.as_tensor(qpos),
                                      qvel=torch.as_tensor(qvel))
    d = collision.collision(m, kinematics.kinematics(m, d))
    act = (d.contact.dist < d.contact.includemargin).numpy()
    for g in m.groups:
        assert act[:, g.offset:g.offset + g.k * g.slots].any(), g[:3]


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py does
    for path, mode in ((ASSET, "torque"), (POSITION_ASSET, "position")):
        write_full_width(path, mode)
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
