"""The HumanoidTorque-shaped fixture of the PyTorch port, and the port's
structural tests.

The fixture is an inline MJCF built from a seed with numpy: a planar root of
3 slides and 3 hinges (nq == nv), hinge trunk and legs with limits, damping
and motors, a JOINT equality, friction loss on the knees, RK4 at 1 ms with
the env layer's solver budget (iterations 8 / ls_iterations 8), a plane, two
box feet and `<mesh vertex=...>` hulls on the limbs. contype/conaffinity
leave floor-vs-box and floor-vs-hull as the only contact pairs, as in
HumanoidTorque's census. Two sizes come from the same generator:

* full width: nv = 19, one plane-box group of 2 pairs (k = 2) and one
  plane-mesh group of 75 pairs (k = 8), hulls of 40-300 vertices. It is
  committed as `loco_mujoco_tpu_torch/assets/humanoid_torque_shape.npz`
  (the model `chip_smoke.py` runs); regenerate it with
  `JAX_PLATFORMS=cpu python tests/test_torch_fixture.py`.
* small: nv = 10, 10 hulls in the mesh group with k = 4 < P, so the mesh
  group takes the kernel path in float32.

The muscle variant (`muscle=True`, HumanoidMuscle's shape; its XML is not
in the repository) keeps the bodies, joints, hulls, equality and friction
loss, and adds sites on the torso, abdomen, thighs, shins and feet, spatial
tendons over 2-4 of them spanning the lumbar, hip, knee and ankle joints and
one `<general>` muscle per tendon, with Euler at 1 ms. At full width its
92 muscles replace the 13 motors (committed as
`loco_mujoco_tpu_torch/assets/humanoid_muscle_shape.npz`); the small
variant's 4 muscles sit between its 4 motors. The same command regenerates
both committed models.

Both are compiled by the JAX package's own `put_model`; the model arrays
are the "weights" carried across to the port.

The 4-ages stand-ins (`scaling=s`, HumanoidTorque4Ages' scalings 0.4, 0.6,
0.8 and 1.0) apply the body-scaling law of the JAX package's `_scale_spec`
(models/humanoids/humanoid_4_ages.py:37-60) to the torque fixture's MjSpec
before compile (`scale_spec`): the meshes scaled by s, body positions by
s, masses by s^3, the (diagonal) inertias by s^5 and the motors' gear by
s^2, and, as the reference's surgery scales its box feet, the stand-in's
own geom offsets and box sizes by s. The hull graphs are scale-invariant,
so the four share one structure and stack as model variants. The full
width ones are committed as `assets/humanoid_torque_s0{4,6,8}_shape.npz`;
scaling 1.0 is `humanoid_torque_shape.npz` itself.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # direct `python tests/test_torch_fixture.py`
    sys.path.insert(0, str(REPO))
# One torch thread per test process where pytest-xdist runs several at
# once (every worker imports this module when it collects the suite):
# torch's default of a thread per core in each of them oversubscribes the
# cores, and its spinning threads made the port's CPU tests 10-100 times
# slower than alone (A1's plain elliptic solves: 5 s alone, 636 s in the
# suite).
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

from loco_mujoco_tpu_torch.core import io as tio  # noqa: E402

ASSET = REPO / "loco_mujoco_tpu_torch" / "assets" / "humanoid_torque_shape.npz"
MUSCLE_ASSET = ASSET.with_name("humanoid_muscle_shape.npz")
SEED = 0


def _hull(rng, semi, n):
    """n points on an ellipsoid with semi-axes `semi` (all are hull
    vertices), as an MJCF vertex string."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return " ".join(f"{v:.6f}" for v in (d * semi).ravel())


# Sites of the muscle variant per body: (count, center, half extents), in
# the body frame
_SITES_FULL = {"torso": (8, (0, 0, -0.12), (0.1, 0.1, 0.07)),
               "abdomen": (8, (0, 0, -0.06), (0.1, 0.12, 0.06)),
               "thigh": (8, (0, 0, -0.19), (0.06, 0.05, 0.15)),
               "shin": (8, (0, 0, -0.19), (0.05, 0.04, 0.15)),
               "foot": (4, (0.035, 0, -0.03), (0.085, 0.04, 0.02))}
_SITES_SMALL = {"torso": (4, (0, 0, -0.05), (0.1, 0.1, 0.05)),
                "thigh": (4, (0, 0, -0.19), (0.06, 0.05, 0.15)),
                "shin": (2, (0, 0, -0.1), (0.05, 0.04, 0.06))}
# Tendon spans of the muscle variant, per side: (count, bodies the path
# visits from origin to insertion). One joint group spanned: 2-3 sites;
# two: 3-4 sites, one on the middle body.
_SPANS_FULL = ((12, ("abdomen", "thigh")), (8, ("thigh", "shin")),
               (8, ("shin", "foot")), (8, ("abdomen", "thigh", "shin")),
               (6, ("thigh", "shin", "foot")))
_SPANS_SMALL = ((1, ("torso", "thigh")), (1, ("thigh", "shin")))
_LUMBAR = 8  # torso -> abdomen tendons (full width)
# the compiler's muscle length ranges: the default tolerance (0.05) does not
# converge on the shortest-range muscles
LENGTHRANGE = '<lengthrange tolrange="0.5"/>'
# the motors of the affine variant (`humanoid_xml(affine=True)`): gain
# g0 + g1 ln + g2 vel and bias b0 + b1 ln + b2 vel, ln and vel in the
# actuator's units (gear 100 times the joint's)
AFFINE_GAIN, AFFINE_BIAS = (1.0, 0.002, -0.0005), (0.02, -0.003, -0.001)
AFFINE_MOTOR = ('gaintype="affine" gainprm="{} {} {}" '
                'biastype="affine" biasprm="{} {} {}"').format(
                    *AFFINE_GAIN, *AFFINE_BIAS)


def _muscle_parts(full: bool, seed: int):
    """(sites per body name, tendon XML, actuator XML of the muscles) of the
    muscle variant, from its own generator so the torque fixture's hulls do
    not move. Every tendon drives one `<general>` muscle (MuJoCo 3.x's
    `<muscle>` shortcut refuses actlimited); half give their force
    explicitly, half as force=-1 with a scale (force = scale / acc0)."""
    rng = np.random.default_rng(seed + 1)
    spec = _SITES_FULL if full else _SITES_SMALL
    sites = {}
    for body in (["torso", "abdomen"] if full else ["torso"]) + [
            f"{b}_{s}" for s in "rl"
            for b in (("thigh", "shin", "foot") if full else ("thigh", "shin"))]:
        n, c, h = spec[body.split("_")[0]]
        pts = np.asarray(c) + rng.uniform(-1, 1, size=(n, 3)) * np.asarray(h)
        sites[body] = [(f"s_{body}_{i}", p) for i, p in enumerate(pts)]
    paths = []
    if full:
        for _ in range(_LUMBAR):
            paths.append(("torso", "abdomen"))
    for side in "rl":
        for count, bodies in (_SPANS_FULL if full else _SPANS_SMALL):
            for _ in range(count):
                paths.append(tuple(b if b in ("torso", "abdomen")
                                   else f"{b}_{side}" for b in bodies))
    tendons, muscles = [], []
    for t, bodies in enumerate(paths):
        names = [sites[b][int(rng.integers(len(sites[b])))][0] for b in bodies]
        if rng.uniform() < 0.5 or not full:  # a second insertion site
            extra = sites[bodies[-1]][int(rng.integers(len(sites[bodies[-1]])))]
            if extra[0] != names[-1]:
                names.append(extra[0])
        tendons.append(f'<spatial name="t{t}">'
                       + "".join(f'<site site="{s}"/>' for s in names)
                       + "</spatial>")
        force, scale = ((float(rng.uniform(150, 600)), 200.0) if t % 2 == 0
                        else (-1.0, float(rng.uniform(100, 300))))
        prm = f"0.75 1.05 {force:.2f} {scale:.2f} 0.5 1.6 1.5 1.3 1.2"
        muscles.append(
            f'<general name="m{t}" tendon="t{t}" dyntype="muscle" '
            f'gaintype="muscle" biastype="muscle" ctrllimited="true" '
            f'ctrlrange="0 1" actlimited="true" actrange="0 1" '
            f'dynprm="0.01 0.04 0" gainprm="{prm}" biasprm="{prm}"/>')
    return sites, tendons, muscles


def humanoid_xml(full: bool, seed: int = SEED, muscle: bool = False,
                 affine: bool = False) -> str:
    """The fixture's MJCF (see the module note); `muscle`: the muscle
    variant (sites, spatial tendons and muscles, Euler)."""
    rng = np.random.default_rng(seed)
    sites, tendons, muscles = (_muscle_parts(full, seed) if muscle
                               else ({}, [], []))

    def site_xml(body):
        return "\n".join(f'<site name="{n}" pos="{p[0]:.4f} {p[1]:.4f} '
                         f'{p[2]:.4f}"/>' for n, p in sites.get(body, []))
    # vertex counts are multiples of 8: the reference's
    # pack_plane_mesh_buckets fails when the largest hull's count is not;
    # its mega plan (ColPlan, vertex cap 5632) needs a multiple of 32, or
    # LMT_MESH_VCAP at the table width, as mega_states sets (ROADMAP,
    # Queue 3)
    nvert = (5, 38) if full else (2, 7)
    meshes, counter = [], [0]

    def hulls(count, center, spread, semi_lo, semi_hi):
        """`count` hull geoms around `center` +- spread (body frame)."""
        out = []
        for _ in range(count):
            name = f"hull{counter[0]}"
            counter[0] += 1
            semi = rng.uniform(semi_lo, semi_hi, size=3)
            n = 8 * int(rng.integers(*nvert))
            meshes.append(f'<mesh name="{name}" vertex="{_hull(rng, semi, n)}"/>')
            p = np.asarray(center) + rng.uniform(-1, 1, size=3) * spread
            out.append(f'<geom type="mesh" mesh="{name}" '
                       f'pos="{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"/>')
        return "\n".join(out)

    def inertial(mass, z):
        return (f'<inertial pos="0 0 {z}" mass="{mass}" '
                f'diaginertia="{0.02 * mass} {0.02 * mass} {0.005 * mass}"/>')

    def hinge(name, axis, lo, hi, damping):
        return (f'<joint name="{name}" type="hinge" axis="{axis}" '
                f'range="{lo} {hi}" damping="{damping}"/>')

    sole = -0.065  # foot-box bottom in the body frame that carries the box

    def foot(side):
        return (f'<geom name="foot_{side}" type="box" size="0.09 0.045 0.025" '
                f'pos="0.04 0 -0.04"/>' + site_xml(f"foot_{side}")
                + hulls(8 if full else 3, (0.04, 0, sole + 0.03),
                        (0.05, 0.02, 0.006), 0.02, 0.035))

    def leg(side, y):
        if full:
            return f"""
      <body name="thigh_{side}" pos="0 {y} -0.1">
        {inertial(5, -0.19)}
        {hinge(f"hip_x_{side}", "1 0 0", -0.5, 0.5, 5)}
        {hinge(f"hip_z_{side}", "0 0 1", -0.6, 0.6, 5)}
        {hinge(f"hip_y_{side}", "0 1 0", -1.5, 0.5, 5)}
        {site_xml(f"thigh_{side}")}
        {hulls(8, (0, 0, -0.19), (0.04, 0.03, 0.15), 0.03, 0.06)}
        <body name="shin_{side}" pos="0 0 -0.38">
          {inertial(3, -0.19)}
          {hinge(f"knee_{side}", "0 1 0", -0.1, 2.0, 3)}
          {site_xml(f"shin_{side}")}
          {hulls(8, (0, 0, -0.19), (0.03, 0.02, 0.15), 0.025, 0.05)}
          <body name="foot_{side}" pos="0 0 -0.38">
            {inertial(1, -0.04)}
            {hinge(f"ankle_{side}", "0 1 0", -0.7, 0.7, 2)}
            {foot(side)}
          </body>
        </body>
      </body>"""
        return f"""
      <body name="thigh_{side}" pos="0 {y} -0.1">
        {inertial(5, -0.19)}
        {hinge(f"hip_y_{side}", "0 1 0", -1.5, 0.5, 5)}
        {site_xml(f"thigh_{side}")}
        {hulls(1, (0, 0, -0.19), (0.04, 0.03, 0.15), 0.03, 0.06)}
        <body name="shin_{side}" pos="0 0 -0.38">
          {inertial(3, -0.25)}
          {hinge(f"knee_{side}", "0 1 0", -0.1, 2.0, 3)}
          {site_xml(f"shin_{side}")}
          <geom name="foot_{side}" type="box" size="0.09 0.045 0.025"
                pos="0.04 0 -0.4"/>
          {hulls(3, (0.04, 0, -0.4 + sole + 0.07), (0.05, 0.02, 0.006),
                 0.02, 0.035)}
        </body>
      </body>"""

    # torso height: the foot-box bottoms sit 2 mm above the floor at qpos0
    height = (0.25 + 0.1 + 0.38 + 0.38 - sole + 0.002 if full
              else 0.1 + 0.38 + 0.4 + 0.025 + 0.002)
    if full:
        body = f"""
      {hulls(15, (0, 0, 0.05), (0.08, 0.1, 0.12), 0.04, 0.08)}
      <body name="abdomen" pos="0 0 -0.25">
        {inertial(8, 0)}
        {hinge("abdomen_z", "0 0 1", -0.8, 0.8, 5)}
        {hinge("abdomen_y", "0 1 0", -0.8, 0.8, 5)}
        {hinge("abdomen_x", "1 0 0", -0.6, 0.6, 5)}
        {site_xml("abdomen")}
        {hulls(12, (0, 0, 0), (0.06, 0.1, 0.06), 0.03, 0.07)}
        {leg("r", -0.1)}
        {leg("l", 0.1)}
      </body>"""
        equality = ('<joint joint1="abdomen_x" joint2="abdomen_z" '
                    'polycoef="0 0.5 0 0 0"/>')
        actuated = ["abdomen_z", "abdomen_y", "abdomen_x"] + [
            f"{j}_{s}" for s in "rl"
            for j in ("hip_x", "hip_z", "hip_y", "knee", "ankle")]
    else:
        body = f"""
      {hulls(2, (0, 0, 0.05), (0.08, 0.1, 0.12), 0.04, 0.08)}
      {leg("r", -0.1)}
      {leg("l", 0.1)}"""
        equality = ('<joint joint1="hip_y_l" joint2="hip_y_r" '
                    'polycoef="0 -0.5 0 0 0"/>')
        actuated = [f"{j}_{s}" for s in "rl" for j in ("hip_y", "knee")]

    root = "\n".join(
        f'<joint name="root_{n}" type="{t}" axis="{a}" limited="false" '
        f'damping="0" armature="0"/>'
        for n, t, a in (("x", "slide", "1 0 0"), ("z", "slide", "0 0 1"),
                        ("y", "slide", "0 1 0"), ("rx", "hinge", "1 0 0"),
                        ("ry", "hinge", "0 1 0"), ("rz", "hinge", "0 0 1")))
    motors = [f'<motor joint="{j}" gear="100" ctrllimited="true" '
              f'ctrlrange="-1 1"/>' for j in actuated]
    if affine:
        motors = [m.replace("<motor ", f"<general {AFFINE_MOTOR} ")
                  for m in motors]
    if muscle and full:
        actuators = muscles  # the muscles replace the joint motors
    else:  # motors and muscles interleaved
        actuators = [a for pair in zip(motors, muscles + [""] * len(motors))
                     for a in pair if a]
    return f"""
<mujoco model="humanoid_{'muscle' if muscle else 'torque'}_shape_{'full' if full else 'small'}">
  <compiler angle="radian">{LENGTHRANGE if muscle else ""}</compiler>
  <option timestep="0.001" integrator="{'Euler' if muscle else 'RK4'}"
          iterations="8" ls_iterations="8"/>
  <default>
    <joint limited="true" armature="0.01"/>
    <geom contype="2" conaffinity="1" condim="3" friction="1 0.005 0.0001"/>
  </default>
  <asset>
    {chr(10).join(meshes)}
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 0.05" contype="1"
          conaffinity="2"/>
    <body name="torso" pos="0 0 {height:.4f}">
      {inertial(10, 0)}
      {root}
      {site_xml("torso")}
      {body}
    </body>
  </worldbody>
  <equality>
    {equality}
  </equality>
  <tendon>
    {chr(10).join(tendons)}
  </tendon>
  <actuator>
    {chr(10).join(actuators)}
  </actuator>
  <contact/>
</mujoco>"""


def _joint_friction(xml: str) -> str:
    """Friction loss on the knees (two friction-loss rows)."""
    for side in "rl":
        xml = xml.replace(f'name="knee_{side}" type="hinge"',
                          f'name="knee_{side}" frictionloss="0.5" type="hinge"')
    return xml


# Configurations of the fixture, each a change of the model's arrays
# (`jax_model`: a static option, or the first column of the last contact
# pair's row of a leaf): RK4 with uniform contact statics (the mega plan's
# 5-float contact pack), Euler (in-kernel implicit damping), the last
# pair's sliding friction (per-pair friction: the 7-float pack) and the
# last pair's solref time constant (the generic 26-float pack).
CONFIGS = {
    "rk4": {},
    "euler": {"opt.integrator": 0},
    "fric": {"leaf:pair_friction": 0.8},
    "solref": {"leaf:pair_solref": 0.03},
}


SCALINGS = (0.4, 0.6, 0.8, 1.0)  # humanoid_4_ages.py DEFAULT_SCALINGS


def scale_spec(spec, s: float) -> None:
    """The 4-ages body-scaling law of the torque model (`_scale_spec`,
    models/humanoids/humanoid_4_ages.py:37-60) on the fixture's MjSpec: mesh
    scale x s, body pos x s, mass x s^3, inertia x s^5 (the fixture gives
    diagonal inertias, `diaginertia`, which `_scale_spec`'s fullinertia
    branch leaves as they are), motor gear x s^2; and the stand-in's geoms'
    offsets and box sizes x s, as the reference's surgery scales its box
    feet (humanoid.py:100-104)."""
    for mesh in spec.meshes:
        mesh.scale = np.asarray(mesh.scale) * s
    for b in spec.bodies:
        if b.name == "world":
            continue
        b.pos = np.asarray(b.pos) * s
        b.mass = b.mass * s ** 3
        b.inertia = np.asarray(b.inertia) * s ** 5
    for g in spec.geoms:
        if g.name == "floor":
            continue
        g.pos = np.asarray(g.pos) * s
        if g.type == 6:  # mjGEOM_BOX
            g.size = np.asarray(g.size) * s
    for a in spec.actuators:
        a.gear = np.asarray(a.gear) * s ** 2


def jax_model(full: bool, dtype=None, change=None, muscle=False,
              affine=False, scaling=None):
    """The fixture (or its muscle variant, or with `affine` its motors'
    gain and bias affine, `AFFINE_MOTOR`, or at a 4-ages `scaling`,
    `scale_spec`) compiled by the JAX package's own `put_model`, with a
    configuration change (`CONFIGS`)."""
    import jax.numpy as jnp
    import mujoco

    from loco_mujoco_tpu.core.io import put_model

    xml = _joint_friction(humanoid_xml(full, muscle=muscle, affine=affine))
    if scaling is None:
        mjm = mujoco.MjModel.from_xml_string(xml)
    else:
        spec = mujoco.MjSpec.from_string(xml)
        scale_spec(spec, scaling)
        mjm = spec.compile()
    jm = put_model(mjm, dtype=dtype or jnp.float64,
                   contact_k_plane=8 if full else 4)
    for k, v in (change or {}).items():
        if k.startswith("opt."):
            jm = jm.replace(opt=jm.opt.replace(**{k[4:]: v}))
        else:
            arr = np.array(getattr(jm, k[5:]))
            arr[-1, 0] = v
            jm = jm.replace(**{k[5:]: jnp.asarray(arr)})
    return jm


def export_model(model):
    """(leaves, aux) of a JAX `Model`: numeric leaves as numpy arrays (option
    leaves as `opt.<name>`), static aux fields as they are."""
    leaves, aux = {}, {}
    for f in dataclasses.fields(model):
        v = getattr(model, f.name)
        if f.name == "opt":
            for g in dataclasses.fields(v):
                w = getattr(v, g.name)
                if g.metadata.get("static"):
                    aux[f"opt.{g.name}"] = w
                else:
                    leaves[f"opt.{g.name}"] = np.asarray(w)
        elif f.metadata.get("static"):
            aux[f.name] = v
        else:
            leaves[f.name] = np.asarray(v)
    return leaves, aux


def torch_model(full: bool, dtype=torch.float64, device="cpu", change=None,
                muscle=False, affine=False, scaling=None):
    """(JAX model, port model) of the fixture, both from one compile."""
    jm = jax_model(full, change=change, muscle=muscle, affine=affine,
                   scaling=scaling)
    leaves, aux = export_model(jm)
    return jm, tio.model_from_numpy(leaves, aux, device=device, dtype=dtype)


def mega_states(monkeypatch, full: bool, n_envs: int, seed: int = 7,
                change=None, muscle=False, affine=False):
    """(JAX model, port model, JAX data, port data) in float32 for the mega
    path tests: n_envs seeded states of the fixture in light contact (the
    feet pressed 5-15 mm into the floor, small joint noise and velocities).
    The JAX plan is built afresh with `LMT_MESH_VCAP` at the width of the
    fixture's vertex table (the reference's default cap rounds the largest
    hull past it; ROADMAP, Queue 3), and the JAX data gets its contact dims
    from one collision pass, as the env's reset does. `change`: a
    configuration (`CONFIGS`) applied to both models; `muscle`: the muscle
    variant, its muscle ctrls in [0, 1] and activations from `seeded_act`;
    `affine`: the motors' gain and bias affine (`AFFINE_MOTOR`).
    Call inside `jax.enable_x64(False)`."""
    import jax
    import jax.numpy as jnp

    from loco_mujoco_tpu.core.io import make_data as jax_make_data
    from loco_mujoco_tpu.ops import collision as jcoll
    from loco_mujoco_tpu.ops import kinematics as jkin
    from loco_mujoco_tpu.ops import pallas_constraint as pc

    jm64 = jax_model(full, change=change, muscle=muscle, affine=affine)
    leaves, aux = export_model(jm64)
    tm = tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float32)
    monkeypatch.setenv("LMT_MESH_VCAP", str(tm.mesh_vert.shape[1]))
    monkeypatch.setattr(pc, "_PLAN_CACHE", {})
    jm = jax_model(full, dtype=jnp.float32, change=change, muscle=muscle,
                   affine=affine)
    rng = np.random.default_rng(seed)
    E = n_envs
    qpos = np.asarray(tm.qpos0)[None] + rng.normal(scale=0.02,
                                                   size=(E, tm.nq))
    qpos[:, int(tm.jnt_qposadr[tm.names["joint"]["root_z"]])] -= \
        rng.uniform(0.005, 0.015, size=E)
    qvel = rng.normal(scale=0.1, size=(E, tm.nv))
    ctrl = rng.uniform(-0.3, 0.3, size=(E, tm.nu))
    act = seeded_act(rng, E, tm.na) if tm.na else np.zeros((E, 0))
    if muscle:
        ctrl = hold_ctrl(tm, np.where(tm.actuator_trntype == 3,
                                      np.abs(ctrl) / 0.3, ctrl), act)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    d0 = jax_make_data(jm)
    jd = jax.jit(jax.vmap(lambda q, v, u, a: jcoll.collision(
        jm, jkin.kinematics(jm, d0.replace(qpos=q, qvel=v, ctrl=u, act=a)))))(
        f32(qpos), f32(qvel), f32(ctrl), f32(act))
    t = lambda x: torch.as_tensor(f32(x))  # noqa: E731
    td = tio.make_data(tm, E).replace(qpos=t(qpos), qvel=t(qvel),
                                      ctrl=t(ctrl), act=t(act))
    return jm, tm, jd, td


def seeded_act(rng, E, na):
    """(E, na) activations in [0, 1), but every fourth one up to 2e-3 above
    1 (outside actrange, as a reset may leave it): the muscle dynamics see
    the raw value and the next Euler step clamps it to 1. From inside the
    range, Euler at dt below the activation time constants never reaches
    the clamp."""
    act = rng.uniform(0.0, 1.0, size=(E, na))
    act[:, ::4] = 1.0 + rng.uniform(0.0, 2e-3, size=act[:, ::4].shape)
    return act


def hold_ctrl(model, ctrl, act):
    """`ctrl` with the muscles whose activation starts above 1 at full
    control, so that their first Euler step ends above 1 and is clamped."""
    ctrl = ctrl.copy()
    for u in np.nonzero(model.actuator_trntype == 3)[0]:
        above = act[:, int(model.actuator_actadr[u])] > 1
        ctrl[above, u] = 1.0
    return ctrl


def write_full_width(path, muscle=False, scaling=None) -> None:
    leaves, aux = export_model(jax_model(full=True, muscle=muscle,
                                         scaling=scaling))
    tio.save_model_npz(path, leaves, aux)


def scaling_asset(s: float) -> Path:
    """The committed full-width stand-in at 4-ages scaling s."""
    if s == 1.0:
        return ASSET
    return ASSET.with_name(f"humanoid_torque_s{int(round(10 * s)):02d}"
                           f"_shape.npz")


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a, b)
    return a == b


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------


def test_package_imports_no_jax():
    """AST scan: the port imports neither jax nor the JAX package."""
    bad = []
    pkg = REPO / "loco_mujoco_tpu_torch"
    for path in [*pkg.rglob("*.py"), REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "loco_mujoco_tpu"):
                    bad.append(f"{path.relative_to(REPO)}: {n}")
    assert not bad, bad


def test_entry_points_need_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.load_model_npz(ASSET)
    m = tio.load_model_npz(ASSET, device="cpu")
    assert m.qpos0.device.type == "cpu" and m.qpos0.dtype == torch.float32


def test_converter_is_leaf_equal():
    """The port's Model holds exactly the JAX model's leaves and aux."""
    jm, tm = torch_model(full=False)
    leaves, aux = export_model(jm)
    leaf_names, aux_names = tio.model_field_names()
    assert sorted(leaf_names) == sorted(leaves)
    assert sorted(aux_names) == sorted(aux)
    for n, v in leaves.items():
        got = getattr(tm.opt, n[4:]) if n.startswith("opt.") else getattr(tm, n)
        np.testing.assert_array_equal(got.numpy(), v, err_msg=n)
    for n, v in aux.items():
        got = getattr(tm.opt, n[4:]) if n.startswith("opt.") else getattr(tm, n)
        assert _same(got, v), n


def test_fixture_census_and_kernel_gate():
    """Both sizes: the box and mesh groups of HumanoidTorque's census, and
    the mesh group gated onto the Hopper kernels (k < P, graph hulls)."""
    full = tio.load_model_npz(ASSET, device="cpu")
    assert full.nv == 19
    kinds = [(g.t2, g.k, len(g.pair_ids)) for g in full.groups]
    assert kinds == [(6, 2, 2), (7, 8, 75)]
    plan = full.mesh_kernel[1]
    assert plan is not None and plan.P == 75
    assert len(plan.buckets) > 1
    counts = full.mesh_vertmask.sum(1)
    assert counts.min() >= 40 and counts.max() <= 300
    _, small = torch_model(full=False)
    assert small.nv == 10
    assert [(g.t2, g.k, len(g.pair_ids)) for g in small.groups] == [
        (6, 2, 2), (7, 4, 10)]
    assert small.mesh_kernel[1] is not None
    assert os.path.getsize(ASSET) < 2 * 1024 * 1024


def test_muscle_fixture_census():
    """The muscle variant: the torque fixture's tree, contact groups and
    constraint rows; 92 site-path tendons of 2-4 sites (150-250 segments)
    driving 92 muscles (half force = -1 with a scale), no motors, Euler; the
    small variant's 4 muscles interleaved with its 4 motors."""
    full = tio.load_model_npz(MUSCLE_ASSET, device="cpu")
    torque = tio.load_model_npz(ASSET, device="cpu")
    assert (full.nv, full.ntendon, full.nu, full.na) == (19, 92, 92, 92)
    assert [(g.t2, g.k, len(g.pair_ids)) for g in full.groups] == \
        [(g.t2, g.k, len(g.pair_ids)) for g in torque.groups]
    assert full.opt.integrator == 0 and np.all(full.actuator_trntype == 3)
    sites = full.tendon_sitemask.sum(axis=1)
    assert sites.min() == 2 and sites.max() <= 4
    assert 150 <= int((sites - 1).sum()) <= 250
    assert int((full.actuator_gainprm[:, 2] < 0).sum()) == 46
    assert bool((full.actuator_lengthrange[:, 1]
                 > full.actuator_lengthrange[:, 0]).all())
    assert full.plan.mega and full.plan.mp.nseg == int((sites - 1).sum())
    assert full.plan.nrows == torque.plan.nrows
    _, small = torch_model(full=False, muscle=True)
    assert small.actuator_trntype.tolist() == [0, 3] * 4
    assert small.plan.mp.mus == [1, 3, 5, 7]
    assert os.path.getsize(MUSCLE_ASSET) < 2 * 1024 * 1024


@pytest.mark.parametrize("muscle", [False, True], ids=["torque", "muscle"])
def test_committed_npz_matches_generator(tmp_path, muscle):
    """Drift test: each committed full-width model is what the generator
    makes now, leaf for leaf."""
    fresh = tmp_path / "fresh.npz"
    write_full_width(fresh, muscle)
    got_l, got_a = tio.read_model_npz(fresh)
    ref_l, ref_a = tio.read_model_npz(MUSCLE_ASSET if muscle else ASSET)
    assert got_l.keys() == ref_l.keys() and got_a.keys() == ref_a.keys()
    for k in ref_l:
        np.testing.assert_array_equal(got_l[k], ref_l[k], err_msg=k)
    for k in ref_a:
        assert _same(got_a[k], ref_a[k]), k


@pytest.mark.parametrize("s", SCALINGS)
def test_committed_scalings_match_generator(tmp_path, s):
    """Drift test of the 4-ages stand-ins: each committed scaling is what
    the generator makes now (scaling 1.0 is the torque stand-in itself,
    leaf for leaf), and the four share one structure."""
    fresh = tmp_path / "fresh.npz"
    write_full_width(fresh, scaling=s)
    got_l, got_a = tio.read_model_npz(fresh)
    ref_l, ref_a = tio.read_model_npz(scaling_asset(s))
    assert got_l.keys() == ref_l.keys() and got_a.keys() == ref_a.keys()
    for k in ref_l:
        np.testing.assert_array_equal(got_l[k], ref_l[k], err_msg=k)
    for k in ref_a:
        assert _same(got_a[k], ref_a[k]), k
    base_l, base_a = tio.read_model_npz(ASSET)
    for k in ("mesh_vertmask", "mesh_nbr", "pair_geom2", "geom_meshid"):
        assert _same(base_a[k], ref_a[k]), k
    if s != 1.0:
        np.testing.assert_allclose(ref_l["body_mass"][1:],
                                   base_l["body_mass"][1:] * s ** 3,
                                   rtol=1e-12)
        np.testing.assert_allclose(ref_l["actuator_gear"][:, 0],
                                   base_l["actuator_gear"][:, 0] * s ** 2,
                                   rtol=1e-12)


@pytest.mark.parametrize("change", [
    {"tendon_stiffness": 1.0},
    {"eq_type": 0},
    {"opt.integrator": 2},
    {"actuator_gaintype": 2},
    {"jnt_type": 1},
    {"actuator_trntype": 4},
    {"tendon_damping": 1.0},
    {"tendon_limited": 1},
    {"tendon_sitemask": False},
    {"actuator_dyntype": 2},
    {"actuator_biastype": 2},
    {"pair_geom1": 76},
])
def test_unsupported_features_raise_at_load(change):
    """Features outside this slice are refused when the model is loaded in
    float64 (tendon changes on the muscle fixture: its last tendon's
    stiffness, damping, limits, or a path of no site; the equality as a
    CONNECT; the last joint motor's muscle gain, site transmission, filter
    activation without an act slot or muscle bias; the last pair between
    two hulls, a convex pair, which float64 would need GJK for). Affine
    gain and bias and one integrator or filter activation are admitted
    (tests/test_torch_affine.py)."""
    tendon = any(k.startswith("tendon_") for k in change)
    leaves, aux = tio.read_model_npz(MUSCLE_ASSET if tendon else ASSET)
    for k, v in change.items():
        if isinstance(aux[k], np.ndarray):  # set the last entry (a hull)
            aux[k] = aux[k].copy()
            aux[k][-1] = v
        else:
            aux[k] = v
    with pytest.raises(NotImplementedError):
        tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float64)


def test_to_casts_float_leaves_only():
    m = tio.load_model_npz(ASSET, device="cpu")
    d = tio.make_data(m, 3)
    m64, d64 = m.to(dtype=torch.float64), d.to(dtype=torch.float64)
    assert m64.qpos0.dtype == torch.float64 and m64.opt.timestep.dtype == \
        torch.float64
    assert d64.qpos.shape == (3, m.nq) and d64.qpos.dtype == torch.float64
    assert d64.contact.geom1.dtype == torch.int64
    assert d64.solver_niter.dtype == torch.int32
    assert m64.groups == m.groups and m64.cache is m.cache


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py does
    for path, muscle in ((ASSET, False), (MUSCLE_ASSET, True)):
        write_full_width(path, muscle)
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
    for s in SCALINGS[:-1]:  # scaling 1.0 is ASSET
        write_full_width(scaling_asset(s), scaling=s)
        print(f"wrote {scaling_asset(s)} "
              f"({os.path.getsize(scaling_asset(s))} bytes)")
