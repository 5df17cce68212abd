"""The row plan and the fused kernel's elliptic layout against the JAX
package, on the A1-shaped fixture (`test_torch_a1_fixture`).

1. The plan (`ops/plan.py`) against `pallas_constraint.get_plan` on both
   sizes: elliptic, `ell_runs`, `con_efcadr`, `con_dim`, the row counts,
   the 29-float generic pack (5 frictions), `euler_dv` and `mega_ell`;
   equal.
2. `hopper_fused.fused_constraint_plain` (float32, on the CPU: the fused
   kernel's plain version) against the reference's
   `pallas_constraint.fused_constraint`, whose kernel (`_fused_batched`,
   elliptic rows and `solve_core(ell_runs=...)`) runs in interpret mode,
   on 8 envs of the small fixture in light contact (`ell_states`), both
   from the same FK outputs, contacts and warm start: qacc and euler_dv
   within rel 5e-4 of the largest value, qfrc_constraint and the
   per-contact forces within the reference's own 2e-3 for the fused path's
   forces (tests/test_pallas_newton.py). Both warm-start from the port's
   converged solve, as a stepped env is (test_torch_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu_torch.ops import collision as coll
from loco_mujoco_tpu_torch.ops import hopper_fused as hf
from loco_mujoco_tpu_torch.ops import kinematics
from test_torch_a1_fixture import ell_states
from test_torch_muscle_mega import reference_mode

E = 8


@pytest.mark.parametrize("full", [False, True], ids=["small", "full"])
def test_plan_matches_jax_row_plan(full, monkeypatch):
    monkeypatch.setattr(pc, "_PLAN_CACHE", {})
    with jax.enable_x64(False):
        jm, tm, jd, _ = ell_states(2, full=full)
        jp = pc.get_plan(jm, jax.tree_util.tree_map(lambda x: x[0],
                                                    jd).contact)
    tp = tm.plan
    assert jp is not None and tp is not None
    for field in ("elliptic", "mega_ell", "mega", "euler_dv", "smooth",
                  "ell_runs", "pack_w", "nfric", "nrows", "npad", "ncon",
                  "ne", "nfl", "nl", "rows_per"):
        got, ref = getattr(tp, field), getattr(jp, field)
        assert (list(got) if field == "rows_per" else got) == ref, field
    np.testing.assert_array_equal(tp.con_efcadr, jp.con_efcadr)
    np.testing.assert_array_equal(tp.con_dim, jp.con_dim)
    assert tp.impratio == jp.impratio == 100.0
    assert tp.elliptic and tp.mega_ell and tp.pack_w == 29


@pytest.fixture(scope="module")
def outputs():
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td = ell_states(E)
            mp.setattr(pc, "_PLAN_CACHE", {})
            reference_mode(mp)
            d = coll.collision(tm, kinematics.kinematics(tm, td))
            ws = hf.fused_constraint_plain(tm, d).qacc
            d = d.replace(qacc_warmstart=ws)
            jd = jd.replace(qacc_warmstart=jnp.asarray(ws.numpy()))
            plan = pc.get_plan(jm, jax.tree_util.tree_map(lambda x: x[0],
                                                          jd).contact)
            assert plan.elliptic and plan.pack_w == tm.plan.pack_w == 29
            ref = jax.jit(jax.vmap(lambda d: pc.fused_constraint(
                jm, d, plan)))(jd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    return tm, d, ref, hf.fused_constraint_plain(tm, d)


@pytest.mark.parametrize("field,tol", [("qacc", 5e-4), ("euler_dv", 5e-4),
                                       ("qfrc_constraint", 2e-3),
                                       ("efc_force_contact", 2e-3)])
def test_fused_plain_matches_jax_elliptic_kernel(outputs, field, tol):
    tm, d, ref, got = outputs
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field == "efc_force_contact":
        active = d.contact.dist < d.contact.includemargin
        assert int(active.sum()) > E, "too few active contact slots"
        # dim rows per slot: 6 on the feet groups, zero past them
        dims = torch.as_tensor(d.contact.dim)
        assert not g[:, (dims == 3).numpy(), 3:].any()
    assert np.abs(g - r).max() / (np.abs(r).max() + 1e-9) < tol
