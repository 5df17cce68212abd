"""The port's tendon and muscle stages, forward and Euler steps against the
JAX package's XLA path, in float64, on both muscle fixtures.

`test_torch_fixture.humanoid_xml(muscle=True)`: full width (92 site-path
tendons driving 92 muscles, no motors) and small (4 muscles interleaved with
4 motors), Euler at 1 ms. 4 envs seeded with numpy: joint noise, the feet
pressed into the floor, velocities, muscle ctrls in [0, 1] and activations
in [0, 1) but every fourth just above 1 at full control (`seeded_act`,
`hold_ctrl`), so that the first Euler step clamps it to actrange. Float64
data gets no plan, in the port and the reference alike, so both run every
stage (`forward_staged`; the XLA stages and the Euler step after them,
compiled once with jit + vmap). Tolerances: the tendon and actuation fields
rel 1e-9 of their largest value, qacc rel 1e-7, qpos / qvel / act after 5
Euler substeps rel 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import collision as jcoll
from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import kinematics as jkin
from loco_mujoco_tpu.ops import solver as jsolver
from loco_mujoco_tpu.ops import constraint as jcon
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import forward
from test_torch_fixture import hold_ctrl, seeded_act, torch_model

E = 4
SUBSTEPS = 5
FIELDS = ("ten_length", "ten_J", "ten_velocity", "actuator_length",
          "actuator_velocity", "actuator_force", "act_dot", "qfrc_actuator")


def _forward_and_step(jm, d):
    """(the staged forward of d, the Euler step after it)."""
    d = jfwd.fwd_position(jm, d)
    d = jfwd.fwd_acceleration(jm, jfwd.fwd_actuation(
        jm, jfwd.fwd_velocity(jm, d)))
    d = jsolver.solve(jm, d, jcon.make_constraint(jm, d))
    return d, jfwd._euler(jm, d)


@pytest.fixture(scope="module", params=[True, False], ids=["full", "small"])
def setup(request):
    jm, tm = torch_model(request.param, muscle=True)
    assert tm.ntendon and tm.na and tm.opt.integrator == 0
    rng = np.random.default_rng(11)
    qpos = np.asarray(tm.qpos0)[None] + rng.normal(scale=0.05,
                                                   size=(E, tm.nq))
    qpos[:, int(tm.jnt_qposadr[tm.names["joint"]["root_z"]])] -= 0.02
    qvel = rng.normal(scale=0.3, size=(E, tm.nv))
    muscle = tm.actuator_trntype == 3
    ctrl = np.where(muscle, rng.uniform(0, 1, size=(E, tm.nu)),
                    rng.uniform(-1, 1, size=(E, tm.nu)))
    act = seeded_act(rng, E, tm.na)
    ctrl = hold_ctrl(tm, ctrl, act)
    d0 = jax_make_data(jm)
    # contact dims from one collision pass, as the env's reset gives them:
    # the step's output then has its input's static structure (one compile)
    jd = jax.jit(jax.vmap(lambda q, v, u, a: jcoll.collision(
        jm, jkin.kinematics(jm, d0.replace(qpos=q, qvel=v, ctrl=u, act=a)))))(
        qpos, qvel, ctrl, act)
    staged = jax.jit(jax.vmap(lambda d: _forward_and_step(jm, d)))
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    td = tio.make_data(tm, E).replace(qpos=t(qpos), qvel=t(qvel),
                                      ctrl=t(ctrl), act=t(act))
    return jm, tm, jd, td, staged


def rel_err(got, ref):
    ref = np.asarray(ref)
    return np.abs(got.numpy() - ref).max() / (np.abs(ref).max() + 1e-30)


@pytest.fixture(scope="module")
def forwards(setup):
    jm, tm, jd, td, staged = setup
    assert forward.mega_enabled(tm, td) is None  # float64: no plan
    return staged(jd)[0], forward.forward(tm, td)


@pytest.mark.parametrize("field", FIELDS)
def test_tendon_and_actuation_match(setup, forwards, field):
    ref, got = forwards
    assert rel_err(getattr(got, field), getattr(ref, field)) < 1e-9


def test_forward_qacc_matches(setup, forwards):
    ref, got = forwards
    active = (got.efc_force_contact != 0).any(dim=-1)
    assert int(active.sum()) > E, "too few active contact slots"
    assert rel_err(got.qacc, ref.qacc) < 1e-7


@pytest.fixture(scope="module")
def euler_runs(setup):
    """5 Euler substeps of both: implicit damping from qM (float64 has no
    plan) and act += dt act_dot clamped to [0, 1]; whether the first step
    clamped the activations seeded above 1."""
    jm, tm, jd, td, staged = setup
    for i in range(SUBSTEPS):
        jd = staged(jd)[1]
        td = forward.step(tm, td)
        if i == 0:
            clamped = bool((td.act == 1.0).any())
    return jd, td, clamped


@pytest.mark.parametrize("field", ["qpos", "qvel", "act"])
def test_euler_substeps_match(euler_runs, field):
    jd, td, clamped = euler_runs
    assert clamped and bool(((td.act >= 0) & (td.act <= 1)).all())
    assert rel_err(getattr(td, field), getattr(jd, field)) < 1e-6
    np.testing.assert_allclose(td.time.numpy(), np.asarray(jd.time),
                               rtol=1e-12)
