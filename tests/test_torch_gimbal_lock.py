"""Float32 at the Euler-angle root's gimbal lock: a known behaviour of the
reference, not a port fault.

The A1 position stand-in (`test_torch_a1_fixture.jax_model(True,
mode="position")`) carries its trunk on three slides and three hinges
(list, tilt, rotation). At a trunk tilt of pi/2 the list and rotation
axes align and the mass matrix is near singular (cond(M) ~1e6 at 0.007 rad
from the lock), so float32 resolves qacc_smooth there only to ~1e-3 of
its largest value. Here, on a few seeded states with trunk_tilt =
pi/2 - 0.007:

- the JAX package's own float32 XLA forward parts from its float64 XLA
  forward by more than rel 5e-4 of the largest qacc_smooth (the
  tolerance the port's float32 kernels are held to): no float32 version,
  the reference's included, can be held to it at the lock;
- the port's float64 plain forward matches the JAX float64 XLA path at
  rel 1e-7 (qacc_smooth), so the port's formulation is the reference's
  there.

The JAX side runs its XLA forward's smooth stages (kinematics, com,
tendons, CRB and its factor, velocity, actuation, acceleration: what
qacc_smooth depends on; the trunk is lifted off the floor), which compile
in seconds where the whole forward's contact stages take a minute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import inertia as jinertia
from loco_mujoco_tpu.ops import kinematics as jkin
from loco_mujoco_tpu.ops import tendon as jtendon
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import forward as fwd
from test_torch_a1_fixture import jax_model
from test_torch_fixture import export_model

E = 4
GAP = 0.007  # rad from the lock (the A1 position cell's env 781 sat at 0.0074)


def _states(tm):
    """E seeded states at the lock: qpos0 with hinge noise, the trunk
    tilted to pi/2 - GAP and lifted off the floor, small velocities, the
    servos' targets uniform in their ctrlrange."""
    rng = np.random.default_rng(11)
    jid = tm.names["joint"]
    adr = lambda n: int(tm.jnt_qposadr[jid[n]])  # noqa: E731
    qpos = np.asarray(tm.qpos0, np.float64)[None] + rng.normal(
        scale=0.05, size=(E, tm.nq))
    qpos[:, adr("trunk_tilt")] = np.pi / 2 - GAP
    qpos[:, adr("trunk_tz")] += 0.5
    qvel = rng.normal(scale=0.3, size=(E, tm.nv))
    cr = np.asarray(tm.actuator_ctrlrange, np.float64)
    ctrl = rng.uniform(cr[:, 0], cr[:, 1], size=(E, tm.nu))
    return qpos, qvel, ctrl


def _smooth(jm, d):
    """The XLA forward's stages up to qacc_smooth (forward.fwd_position
    without its collision, then fwd_velocity, fwd_actuation,
    fwd_acceleration)."""
    d = jkin.kinematics(jm, d)
    d = jkin.com_pos(jm, d)
    d = jtendon.tendon(jm, d)
    d = jinertia.factor_m(jm, jinertia.crb(jm, d))
    d = jfwd.fwd_acceleration(jm, jfwd.fwd_actuation(
        jm, jfwd.fwd_velocity(jm, d)))
    return d.qacc_smooth


def _jax_qacc_smooth(jm, qpos, qvel, ctrl):
    d0 = jax_make_data(jm)
    dt = d0.qpos.dtype
    jd = jax.vmap(lambda q, v, u: d0.replace(qpos=q, qvel=v, ctrl=u))(
        *(jnp.asarray(x, dt) for x in (qpos, qvel, ctrl)))
    return np.asarray(jax.jit(jax.vmap(lambda d: _smooth(jm, d)))(jd),
                      np.float64)


@pytest.fixture(scope="module")
def forwards():
    jm = jax_model(True, mode="position")
    leaves, aux = export_model(jm)
    tm = tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float64)
    qpos, qvel, ctrl = _states(tm)
    ref64 = _jax_qacc_smooth(jm, qpos, qvel, ctrl)
    with jax.enable_x64(False):
        jm32 = jax_model(True, dtype=jnp.float32, mode="position")
        ref32 = _jax_qacc_smooth(jm32, qpos, qvel, ctrl)
    t = torch.as_tensor
    got = fwd.forward(tm, tio.make_data(tm, E).replace(
        qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl)))
    return tm, ref64, ref32, got


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_states_sit_at_the_lock(forwards):
    tm = forwards[0]
    jid = tm.names["joint"]
    qpos = _states(tm)[0]
    tilt = qpos[:, int(tm.jnt_qposadr[jid["trunk_tilt"]])]
    np.testing.assert_allclose(np.pi / 2 - tilt, GAP, rtol=1e-12)


def test_reference_float32_parts_from_float64_at_the_lock(forwards):
    _, ref64, ref32, _ = forwards
    rel = _rel(ref32, ref64)
    assert rel > 5e-4, rel


def test_port_float64_matches_reference_float64(forwards):
    _, ref64, _, got = forwards
    assert _rel(got.qacc_smooth.numpy(), ref64) < 1e-7
