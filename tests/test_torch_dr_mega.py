"""Per-env joint damping (domain randomization) as operand rows of the mega
forward, the megastep and the fused kernel, held on the CPU. This file
holds the plan and the mega forward; tests/test_torch_dr_f64.py the
float64 comparisons, tests/test_torch_dr_megastep.py and
tests/test_torch_dr_fused.py the other two kernels' float32 ones (one
interpret-mode compile per file).

1. The plan flag: the port's `plan.dyn_damping()` against the reference's
   `RowPlan` built with a traced `dof_damping` (the reference's own test of
   randomized damping, `_conc` None under vmap): `sm_dyn_damping` set and
   `euler_dv` off, on the small humanoid (RK4 and Euler) and the small A1;
   the plans without it unchanged; the flag bit `DAMP_ROWS` in the packed
   tables and in csrc/forward_core.cuh's enum.
2. The operand check: a plan with the rows needs `Data.dof_damping`, and
   per-env damping needs the plan's variant.
3. float32 against the reference's interpret-mode mega kernel with the
   damping rows (`_forward_env_block`'s operand rows, `:1237-1240`): the
   plain version `mega_forward_plain`, warm-started from the port's own
   solve of the same state as tests/test_torch_mega.py does; qacc,
   qfrc_constraint and efc_force_contact within rel 5e-4 of the largest
   value, as tools/verify_dr_parity.py holds the reference's own.

Damping draws: the model's damping times U(0.3, 3) per env and dof, from a
numpy seed, the same numbers on both sides.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import collision as jcoll
from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import kinematics as jkin
from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu.ops import pallas_newton as pn
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import forward, hopper_fused, hopper_mega
from loco_mujoco_tpu_torch.ops import plan as tplan
import test_torch_a1_fixture as a1fx
from test_torch_fixture import (CONFIGS, REPO, export_model, jax_model,
                                mega_states)

E32 = 8


def draws(model, E, seed=11):
    """(E, nv) per-env damping: the model's times U(0.3, 3)."""
    base = np.asarray(model.dof_damping, np.float64)
    return base[None] * np.random.default_rng(seed).uniform(
        0.3, 3.0, size=(E, model.nv))


def dr(model):
    """The port's model with the plan's per-env damping variant."""
    return model.replace(plan=model.plan.dyn_damping())


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def _jax_dr_plan(jm, contact0, dd):
    """The reference's plan as its forward builds it for a model whose
    dof_damping is traced (a vmap over per-env damping)."""
    got = {}

    def f(d):
        got["plan"] = pc.get_plan(jm.replace(dof_damping=d), contact0)
        return d

    jax.vmap(f)(jnp.asarray(dd, jnp.float32))
    return got["plan"]


# ---------------------------------------------------------------------------
# 1. the plan flag
# ---------------------------------------------------------------------------


def _plans(name, monkeypatch):
    if name == "a1":
        jm = a1fx.jax_model(False)
        leaves, aux = export_model(jm)
        tm = tio.model_from_numpy(leaves, aux, device="cpu",
                                  dtype=torch.float32)
    else:
        jm = jax_model(False, change=CONFIGS[name])
        leaves, aux = export_model(jm)
        tm = tio.model_from_numpy(leaves, aux, device="cpu",
                                  dtype=torch.float32)
        monkeypatch.setenv("LMT_MESH_VCAP", str(tm.mesh_vert.shape[1]))
    monkeypatch.setattr(pc, "_PLAN_CACHE", {})
    d = jax.jit(lambda d: jcoll.collision(jm, jkin.kinematics(
            jm, d)))(jax_make_data(jm))
    with jax.enable_x64(False):
        jbase = pc.get_plan(jm, d.contact)
        jdyn = _jax_dr_plan(jm, d.contact, draws(tm, 2))
    return tm, jbase, jdyn


@pytest.mark.parametrize("name", ["rk4", "euler", "a1"])
def test_dyn_damping_plan_matches_reference(name, monkeypatch):
    tm, jbase, jdyn = _plans(name, monkeypatch)
    base, dyn = tm.plan, tm.plan.dyn_damping()
    assert jbase is not None and jdyn is not None
    assert not base.sm_dyn_damping and not jbase.sm_dyn_damping
    assert dyn.sm_dyn_damping and jdyn.sm_dyn_damping
    assert dyn.euler_dv == bool(jdyn.euler_dv) is False
    assert base.euler_dv == bool(jbase.euler_dv) == (name != "rk4")
    assert dyn.dof_damping is None and jdyn.dof_damping is None
    # the rows keep the mega path, as in the reference (:529-537)
    assert dyn.mega == base.mega == bool(jdyn.mega) is True
    for field in ("nrows", "ncon", "smooth", "mega_ell"):
        assert getattr(dyn, field) == getattr(base, field), field
    # made once, and the plan without it is left as it was
    assert tm.plan.dyn_damping() is dyn and dyn.dyn_damping() is dyn
    ib, _ = base.pack()
    idn, _ = dyn.pack()
    flags = tplan.H["FLAGS"]
    assert ib[flags] & tplan.DAMP_ROWS == 0
    assert idn[flags] == ib[flags] | tplan.DAMP_ROWS
    ib[flags] = idn[flags]
    np.testing.assert_array_equal(ib, idn)


def test_damp_rows_flag_matches_kernel_source():
    src = (REPO / "loco_mujoco_tpu_torch" / "csrc"
           / "forward_core.cuh").read_text()
    assert re.search(r"DAMP_ROWS = (\d+)", src).group(1) == str(
        tplan.DAMP_ROWS)


def test_damping_operand_goes_with_the_plan():
    tm = tio.load_model_npz(REPO / "loco_mujoco_tpu_torch" / "assets"
                            / "humanoid_torque_shape.npz", device="cpu")
    d = tio.make_data(tm, 2)
    with pytest.raises(ValueError, match="dyn_damping"):
        hopper_mega.mega_forward_plain(dr(tm), d)
    rows = tm.dof_damping.expand(2, -1).clone()
    with pytest.raises(ValueError, match="dyn_damping"):
        hopper_fused.vec(tm, d.replace(dof_damping=rows))
    v = hopper_fused.vec(dr(tm), d.replace(dof_damping=rows))
    assert v.shape[1] == hopper_fused.smooth_vec(d).shape[1] + tm.nv
    assert hopper_mega.megastep_mode(dr(tm)) == (True, False)


# ---------------------------------------------------------------------------
# 3. float32 against the reference's interpret-mode mega kernel with the rows
# ---------------------------------------------------------------------------


def f32_states(mp):
    """(JAX model, the port's DR model, JAX data, port data with its
    damping, the draws) in float32: `mega_states` of the small fixture.
    Call inside `jax.enable_x64(False)`."""
    jm, tm, jd, td = mega_states(mp, full=False, n_envs=E32)
    dd = np.asarray(draws(tm, E32), np.float32)
    return jm, dr(tm), jd, td.replace(dof_damping=torch.as_tensor(dd)), dd


def warm(tm, td, jd):
    """Both data warm-started from the port's own forward of the state."""
    ws = forward.forward(tm, td).qacc
    return (td.replace(qacc_warmstart=ws),
            jd.replace(qacc_warmstart=jnp.asarray(ws.numpy())))


def interpret(mp):
    mp.setattr(pn, "_INTERPRET", True)
    mp.setattr(pn, "pallas_enabled", lambda: True)


@pytest.fixture(scope="module")
def mega32():
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td, dd = f32_states(mp)
            interpret(mp)
            td, jd = warm(tm, td, jd)
            ref = jax.jit(jax.vmap(lambda d, x: jfwd.forward(
                jm.replace(dof_damping=x), d)))(jd, dd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    return ref, forward.forward(tm, td)


def check_fields(ref, got, field):
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field == "efc_force_contact":
        assert int((g != 0).any(axis=-1).sum()) > 2 * E32
        w = min(g.shape[-1], r.shape[-1])
        g, r = g[..., :w], r[..., :w]
    assert rel_err(g, r) < 5e-4


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact"])
def test_f32_mega_forward_matches_reference_kernel_with_rows(mega32, field):
    check_fields(*mega32, field)
