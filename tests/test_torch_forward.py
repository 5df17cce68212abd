"""The port's staged forward and RK4 step against the JAX package's XLA
path, in float64, on the small fixture.

The JAX forward is compiled once (jit + vmap of the staged stages, returning
the constraint rows too); RK4 is driven eagerly around it by patching
`forward`, as compiling the whole step takes minutes on this CPU.
Tolerances: constraint rows J/aref/D/R atol 1e-9 on active rows (D = 1/R
reaches 1e4, so relative to D this is 1e-13), rtol 1e-12 on all rows, and
the active flags exact; forward qacc and
constraint forces rel 1e-7; qpos/qvel after 5 RK4 substeps, and after 5
Euler substeps of the fixture's Euler configuration, rel 1e-6.
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
from loco_mujoco_tpu_torch.ops import constraint, forward
from test_torch_fixture import export_model, torch_model

E = 4
SUBSTEPS = 5


def _staged(jm, d):
    d = jfwd.fwd_position(jm, d)
    d = jfwd.fwd_acceleration(jm, jfwd.fwd_actuation(
        jm, jfwd.fwd_velocity(jm, d)))
    efc = jcon.make_constraint(jm, d)
    return jsolver.solve(jm, d, efc), (efc.J, efc.aref, efc.D, efc.R,
                                       efc.active)


@pytest.fixture(scope="module")
def setup():
    jm, tm = torch_model(full=False)
    rng = np.random.default_rng(7)
    qpos = np.asarray(tm.qpos0)[None] + rng.normal(scale=0.05,
                                                   size=(E, tm.nq))
    qpos[:, int(tm.jnt_qposadr[tm.names["joint"]["root_z"]])] -= 0.02
    qvel = rng.normal(scale=0.3, size=(E, tm.nv))
    ctrl = rng.uniform(-1, 1, size=(E, tm.nu))
    d0 = jax_make_data(jm)
    jd = jax.vmap(lambda q, v, u: d0.replace(qpos=q, qvel=v, ctrl=u))(
        qpos, qvel, ctrl)
    staged = jax.jit(jax.vmap(lambda d: _staged(jm, d)))
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)
    td = tio.make_data(tm, E).replace(qpos=t(qpos), qvel=t(qvel),
                                      ctrl=t(ctrl))
    return jm, tm, jd, td, staged


def rel_err(got, ref):
    ref = np.asarray(ref)
    return np.abs(got.numpy() - ref).max() / (np.abs(ref).max() + 1e-30)


def test_constraint_rows_match(setup):
    jm, tm, jd, td, staged = setup
    _, (J, aref, D, R, active) = staged(jd)
    d = forward.fwd_position(tm, td)
    d = forward.fwd_acceleration(tm, forward.fwd_actuation(
        tm, forward.fwd_velocity(tm, d)))
    efc = constraint.make_constraint(tm, d)
    np.testing.assert_array_equal(efc.active.numpy(), np.asarray(active))
    assert np.asarray(active).sum() > 4 * E, "too few active rows"
    on = np.asarray(active)
    for name, ref in (("J", J), ("aref", aref), ("D", D), ("R", R)):
        got, ref = getattr(efc, name).numpy(), np.asarray(ref)
        np.testing.assert_allclose(got[on], ref[on], rtol=0, atol=1e-9,
                                   err_msg=name)
        # inactive contact slots sit at the 1e10 sentinel depth, which puts
        # their (masked) rows at ~5e9: there the agreement is relative
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-9,
                                   err_msg=name)


@pytest.mark.parametrize("field", ["qacc", "qacc_smooth", "qfrc_constraint",
                                   "efc_force_contact"])
def test_forward_matches(setup, field):
    jm, tm, jd, td, staged = setup
    ref, _ = staged(jd)
    got = forward.forward(tm, td)
    assert rel_err(getattr(got, field), getattr(ref, field)) < 1e-7


def test_rk4_substeps_match(setup, monkeypatch):
    jm, tm, jd, td, staged = setup
    monkeypatch.setattr(jfwd, "forward", lambda m, d: staged(d)[0])
    for _ in range(SUBSTEPS):
        jd = jfwd._rk4(jm, staged(jd)[0])
        td = forward.step(tm, td)
    assert rel_err(td.qpos, jd.qpos) < 1e-6
    assert rel_err(td.qvel, jd.qvel) < 1e-6
    np.testing.assert_allclose(td.time.numpy(), np.asarray(jd.time),
                               rtol=1e-12)


def test_euler_substeps_match(setup):
    """The fixture with the Euler integrator: float64 data gets no plan, so
    the implicit damping (qM + dt diag(damping))^-1 qM qacc is solved from
    qM (`forward.damping_dv`), as the JAX package's `_euler` solves it
    after the same staged forward (which does not read the integrator)."""
    jm, tm, jd, td, staged = setup
    leaves, aux = export_model(jm)
    aux["opt.integrator"] = 0
    tm = tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float64)
    jm = jm.replace(opt=jm.opt.replace(integrator=0))
    for _ in range(SUBSTEPS):
        jd = jfwd._euler(jm, staged(jd)[0])
        td = forward.step(tm, td)
        assert td.euler_dv is None
    assert rel_err(td.qpos, jd.qpos) < 1e-6
    assert rel_err(td.qvel, jd.qvel) < 1e-6
    np.testing.assert_allclose(td.time.numpy(), np.asarray(jd.time),
                               rtol=1e-12)
