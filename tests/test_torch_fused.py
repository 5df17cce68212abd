"""The port's row plan and fused constraint kernel against the JAX package.

1. The plan (`ops/plan.py`) against `pallas_constraint.get_plan` on the four
   configurations of the small fixture (`test_torch_fixture.CONFIGS`): RK4
   with uniform statics (mega, 5-float pack), Euler (`euler_dv`), per-pair
   friction (7-float pack, no mega) and one pair's solref (generic 26-float
   pack, no mega). The JAX plan is built as its forward builds it, on
   contacts from one collision pass, with `LMT_MESH_VCAP` at the fixture's
   vertex-table width; equal.
2. `hopper_fused.fused_constraint_plain` (float32, on the CPU: the fused
   kernel's plain version) against the reference's
   `pallas_constraint.fused_constraint`, whose kernel (`_fused_batched`)
   runs in interpret mode, on the Euler and generic-pack configurations:
   8 envs in light contact (`test_torch_fixture.mega_states`), both from the
   same FK outputs, contacts and warm start. qacc, qfrc_constraint,
   efc_force_contact and euler_dv within rel 5e-4 of the largest value
   (tests/test_pallas_newton.py's limit for the fused path). The warm start
   is the port's own solve of the same state, as a stepped env is
   warm-started from its last step: from a cold start, float32 summation
   orders stop some envs one Newton step apart (the termination test
   compares an improvement with a floor below the costs' rounding), and
   the reference's kernel does not return its decisions for a replay.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import collision as jcoll
from loco_mujoco_tpu.ops import kinematics as jkin
from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu.ops import pallas_newton as pn
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import collision as coll
from loco_mujoco_tpu_torch.ops import hopper_fused as hf
from loco_mujoco_tpu_torch.ops import kinematics
from test_torch_fixture import CONFIGS, export_model, jax_model, mega_states

E = 8
# (mega, uniform, fric_uniform, euler_dv, pack_w) of each configuration
EXPECT = {"rk4": (True, True, True, False, 5),
          "euler": (True, True, True, True, 5),
          "fric": (False, True, False, False, 7),
          "solref": (False, False, False, False, 26)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plan_matches_jax_row_plan(name, monkeypatch):
    change = CONFIGS[name]
    jm = jax_model(False, change=change)
    leaves, aux = export_model(jm)
    tm = tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float32)
    monkeypatch.setenv("LMT_MESH_VCAP", str(tm.mesh_vert.shape[1]))
    monkeypatch.setattr(pc, "_PLAN_CACHE", {})
    d = jax.jit(lambda d: jcoll.collision(jm, jkin.kinematics(
            jm, d)))(jax_make_data(jm))
    with jax.enable_x64(False):
        jp = pc.get_plan(jm, d.contact)
    tp = tm.plan
    assert jp is not None and tp is not None
    got = (tp.mega, tp.uniform, tp.fric_uniform, tp.euler_dv, tp.pack_w)
    ref = (bool(jp.mega), bool(jp.uniform),
           bool(getattr(jp, "fric_uniform", False)), bool(jp.euler_dv),
           jp.pack_w)
    assert got == ref == EXPECT[name]
    assert tp.smooth and jp.smooth
    for field in ("nrows", "npad", "ncon", "ne", "nfl", "nl"):
        assert getattr(tp, field) == getattr(jp, field), field
    np.testing.assert_array_equal(tp.con_efcadr, jp.con_efcadr)
    if jp.euler_dv:
        np.testing.assert_array_equal(tp.dof_damping, jp.dof_damping)
    else:
        assert tp.dof_damping is None


@pytest.fixture(scope="module")
def outputs():
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name in ("euler", "solref"):
            with jax.enable_x64(False):
                jm, tm, jd, td = mega_states(mp, full=False, n_envs=E,
                                             change=CONFIGS[name])
                mp.setattr(pn, "_INTERPRET", True)
                mp.setattr(pn, "pallas_enabled", lambda: True)
                d = coll.collision(tm, kinematics.kinematics(tm, td))
                ws = hf.fused_constraint_plain(tm, d).qacc
                d = d.replace(qacc_warmstart=ws)
                jd = jd.replace(qacc_warmstart=jnp.asarray(ws.numpy()))
                d0 = jax.tree_util.tree_map(lambda x: x[0], jd)
                plan = pc.get_plan(jm, d0.contact)
                assert plan is not None and plan.pack_w == tm.plan.pack_w
                ref = jax.jit(jax.vmap(
                    lambda d, plan=plan, jm=jm: pc.fused_constraint(
                        jm, d, plan)))(jd)
                ref = jax.tree_util.tree_map(np.asarray, ref)
            out[name] = (tm, ref, hf.fused_constraint_plain(tm, d))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact", "euler_dv"])
@pytest.mark.parametrize("name", ["euler", "solref"])
def test_fused_plain_matches_jax_fused_kernel(outputs, name, field):
    tm, ref, got = outputs[name]
    g, r = getattr(got, field), getattr(ref, field)
    if field == "euler_dv":
        assert (g is None) == (r is None) == (not tm.plan.euler_dv)
        if g is None:
            return
    g = g.numpy()
    if field == "efc_force_contact":
        active = (got.efc_force_contact != 0).any(dim=-1)
        assert int(active.sum()) > 2 * E, "too few active contact slots"
        w = min(g.shape[-1], r.shape[-1])
        assert not g[..., w:].any() and not r[..., w:].any()
        g, r = g[..., :w], r[..., :w]
    assert np.abs(g - r).max() / (np.abs(r).max() + 1e-9) < 5e-4
