"""Elliptic contact rows, the Newton solve with cone zones and Euler steps
of the A1-shaped fixture against the JAX package's XLA path, in float64 on
the CPU.

Full-width fixture (`test_torch_a1_fixture`), 32 seeded states in light
contact (every group touching somewhere): `make_constraint`'s rows (J,
aref, R, active, the row types, `con_efcadr`, `ell_start`, `ell_dim` and the
cone coefficients) within 1e-9 of the largest value; one forward (the
Newton solve of the rows with the zones' forces and middle-zone Hessian
terms, `hopper_newton.newton_plain`) with qacc within rel 1e-7,
qfrc_constraint and the per-contact forces (dim rows per elliptic slot)
within rel 1e-6; five Euler substeps with qpos and qvel within rel 1e-6
(PERF.md's float64 limits). Float64 data takes no row plan, as in the
reference, so this is the staged path with every stage in plain PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import constraint as jcon
from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import constraint as con
from loco_mujoco_tpu_torch.ops import forward as fwd
from test_torch_a1_fixture import a1_states, torch_model

E, STEPS = 32, 5


def rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


@pytest.fixture(scope="module")
def setup():
    jm, tm = torch_model(full=True)
    qpos, qvel, ctrl = a1_states(tm, E)
    d0 = jax_make_data(jm)
    jd = jax.vmap(lambda q, v, u: d0.replace(qpos=q, qvel=v, ctrl=u))(
        *(jnp.asarray(x) for x in (qpos, qvel, ctrl)))
    td = tio.make_data(tm, E).replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
        ctrl=torch.as_tensor(ctrl))
    return jm, tm, jd, td


@pytest.fixture(scope="module")
def rows(setup):
    jm, tm, jd, td = setup

    def ref_rows(d):
        d = jfwd.fwd_velocity(jm, jfwd.fwd_position(jm, d))
        return jcon.make_constraint(jm, d)

    ref = jax.jit(jax.vmap(ref_rows))(jd)
    d = fwd.fwd_velocity(tm, fwd.fwd_position(tm, td))
    return ref, con.make_constraint(tm, d)


def test_elliptic_rows_match_xla(rows):
    ref, got = rows
    assert int((got.type == con.CONTACT_ELLIPTIC).sum()) == 276
    np.testing.assert_array_equal(got.type, ref.type)
    for name in ("con_efcadr", "con_dim", "ell_start", "ell_dim"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(ref.active))
    assert int(got.active[:, 24:].sum()) > 4 * E, "too few active rows"
    for name in ("J", "aref", "R", "pos", "con_mu"):
        assert rel(getattr(got, name).numpy(), getattr(ref, name)) < 1e-9, \
            name


@pytest.fixture(scope="module")
def steps(setup):
    """STEPS Euler steps of both, and each step's forward outputs, the
    reference's as one traced scan (one compile)."""
    jm, tm, jd, td = setup
    fields = ("qacc", "qfrc_constraint", "efc_force_contact")

    def run(d):
        def body(c, _):
            out = jfwd.step(jm, d.replace(qpos=c[0], qvel=c[1],
                                          qacc_warmstart=c[2]))
            return ((out.qpos, out.qvel, out.qacc_warmstart),
                    tuple(getattr(out, f) for f in fields))

        c, ys = jax.lax.scan(body, (d.qpos, d.qvel, d.qacc_warmstart), None,
                             length=STEPS)
        return c, ys

    (qpos, qvel, _), ys = jax.jit(jax.vmap(run))(jd)
    ref = dict(qpos=qpos, qvel=qvel, **{f: y[:, 0] for f, y in zip(fields,
                                                                   ys)})
    d, first = td, None
    for _ in range(STEPS):
        d = fwd.step(tm, d)
        first = first or d
    got = dict(qpos=d.qpos, qvel=d.qvel,
               **{f: getattr(first, f) for f in fields})
    return {k: np.asarray(v) for k, v in ref.items()}, got, first


@pytest.mark.parametrize("field,tol", [("qacc", 1e-7),
                                       ("qfrc_constraint", 1e-6),
                                       ("efc_force_contact", 1e-6)])
def test_elliptic_solve_matches_xla(steps, field, tol):
    ref, got, _ = steps
    assert rel(got[field].numpy(), ref[field]) < tol


def test_elliptic_forces_fill_dim_rows(steps):
    """efc_force_contact holds dim rows per elliptic slot (6 on the feet
    groups, 3 elsewhere), zero past them."""
    _, got, first = steps
    f = got["efc_force_contact"].numpy()
    dims = first.contact.dim
    for d in (3, 6):
        assert np.abs(f[:, dims == d, d:]).max() == 0.0
        assert np.abs(f[:, dims == d, :d]).max() > 0.0


@pytest.mark.parametrize("field", ["qpos", "qvel"])
def test_euler_steps_match_xla(setup, steps, field):
    _, _, _, td = setup
    ref, got, _ = steps
    start = getattr(td, field).numpy()
    assert rel(got[field].numpy() - start, ref[field] - start) < 1e-6
