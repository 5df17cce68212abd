"""Per-env joint damping in float64 against the JAX package's XLA path,
under vmap of a per-env damping model (`jm.replace(dof_damping=dd)` per
env), on the small humanoid: the plain versions `mega_forward_plain` and
`fused_constraint_plain` with the plan's damping rows (qacc,
qfrc_constraint rel 1e-7), `mega_step_n_plain` over 5 RK4 substeps and 5
Euler substeps of the per-substep path (the forward, then each env's
implicit damping solved from qM, `forward.damping_dv`), qpos and qvel rel
1e-6: tests/test_torch_forward.py's limits. The draws come from
tests/test_torch_dr_mega.py.
"""

import jax
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import constraint as jcon
from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import solver as jsolver
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import collision as coll
from loco_mujoco_tpu_torch.ops import forward, hopper_fused, hopper_mega
from loco_mujoco_tpu_torch.ops import kinematics
from test_torch_dr_mega import dr, draws, rel_err
from test_torch_fixture import export_model, torch_model

E64, SUBSTEPS = 4, 5


def _staged(jm, d):
    d = jfwd.fwd_position(jm, d)
    d = jfwd.fwd_acceleration(jm, jfwd.fwd_actuation(
        jm, jfwd.fwd_velocity(jm, d)))
    return jsolver.solve(jm, d, jcon.make_constraint(jm, d))


@pytest.fixture(scope="module")
def f64():
    jm, tm = torch_model(full=False)
    rng = np.random.default_rng(7)
    E = E64
    qpos = np.asarray(tm.qpos0)[None] + rng.normal(scale=0.05,
                                                   size=(E, tm.nq))
    qpos[:, int(tm.jnt_qposadr[tm.names["joint"]["root_z"]])] -= 0.02
    qvel = rng.normal(scale=0.3, size=(E, tm.nv))
    ctrl = rng.uniform(-1, 1, size=(E, tm.nu))
    dd = draws(tm, E)
    d0 = jax_make_data(jm)
    jd = jax.vmap(lambda q, v, u: d0.replace(qpos=q, qvel=v, ctrl=u))(
        qpos, qvel, ctrl)
    staged = jax.jit(jax.vmap(
        lambda d, x: _staged(jm.replace(dof_damping=x), d)))
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    td = tio.make_data(tm, E).replace(qpos=t(qpos), qvel=t(qvel),
                                      ctrl=t(ctrl), dof_damping=t(dd))
    return jm, tm, jd, td, dd, staged


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint"])
def test_f64_mega_forward_plain_with_rows(f64, field):
    jm, tm, jd, td, dd, staged = f64
    ref = staged(jd, dd)
    got = hopper_mega.mega_forward_plain(dr(tm), td)
    assert rel_err(getattr(got, field).numpy(), getattr(ref, field)) < 1e-7
    # the draws move the answer: the model's own damping gives another
    plain = staged(jd, np.broadcast_to(np.asarray(jm.dof_damping), dd.shape))
    assert rel_err(plain.qacc, ref.qacc) > 1e-4


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint"])
def test_f64_fused_plain_with_rows(f64, field):
    jm, tm, jd, td, dd, staged = f64
    ref = staged(jd, dd)
    d = coll.collision(tm, kinematics.kinematics(tm, td))
    got = hopper_fused.fused_constraint_plain(dr(tm), d)
    assert got.euler_dv is None
    assert rel_err(getattr(got, field).numpy(), getattr(ref, field)) < 1e-7


def test_f64_rk4_megastep_plain_with_rows(f64, monkeypatch):
    jm, tm, jd, td, dd, staged = f64
    monkeypatch.setattr(jfwd, "forward", lambda m, d: staged(d, dd))
    for _ in range(SUBSTEPS):
        jd = jfwd._rk4(jm, staged(jd, dd))
    got = hopper_mega.mega_step_n_plain(dr(tm), td, SUBSTEPS)
    assert rel_err(got.qpos.numpy(), jd.qpos) < 1e-6
    assert rel_err(got.qvel.numpy(), jd.qvel) < 1e-6


def test_f64_euler_per_substep_with_rows(f64):
    """Euler with per-env damping: no megastep (`step_n` None, no
    euler_dv), each substep runs the forward and solves every env's
    implicit damping from qM (`forward.damping_dv`)."""
    jm, tm, jd, td, dd, staged = f64
    leaves, aux = export_model(jm)
    aux["opt.integrator"] = 0
    tm = tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float64)
    jm = jm.replace(opt=jm.opt.replace(integrator=0))
    euler = jax.jit(jax.vmap(
        lambda d, x: jfwd._euler(jm.replace(dof_damping=x), d)))
    assert hopper_mega.megastep_mode(dr(tm)) is None
    assert forward.step_n(dr(tm), td, SUBSTEPS) is None
    for _ in range(SUBSTEPS):
        jd = euler(staged(jd, dd), dd)
        td = forward.step(dr(tm), td)
    assert rel_err(td.qpos.numpy(), jd.qpos) < 1e-6
    assert rel_err(td.qvel.numpy(), jd.qvel) < 1e-6


