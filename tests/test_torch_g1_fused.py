"""The row plan and the fused kernel's generic 26-float pack against the JAX
package, on the G1-shaped fixture (`test_torch_g1_fixture`): G1's staged
path, pyramidal rows over groups with per-group statics.

1. The plan (`ops/plan.py`) against `pallas_constraint.get_plan` on both
   sizes: the row counts, `con_efcadr`, `con_dim`, the pack width (26:
   the generic pack with 2 frictions, `:2225-2236`), `euler_dv`, `mega`
   and `mega_ell` with pyramidal cones; equal.
2. `hopper_fused.fused_constraint_plain` (float32, on the CPU: the fused
   kernel's plain version, with the port's contact pack) against the
   reference's `pallas_constraint.fused_constraint` (its generic pack of
   the same contact slots, `_fused_batched` in interpret mode), on 8 envs
   of `g1_states` (standing, self groups in contact), both from the same
   FK outputs, contacts and warm start: qacc, euler_dv, qfrc_constraint
   and the per-contact forces within rel 5e-4 of the largest value
   (tests/test_mega.py's tolerance). Both warm-start from the port's
   converged solve, as a stepped env is (test_torch_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import collision as coll
from loco_mujoco_tpu_torch.ops import hopper_fused as hf
from loco_mujoco_tpu_torch.ops import kinematics
from test_torch_cyl_mega import one_key_chain
from test_torch_fixture import export_model
from test_torch_g1_fixture import g1_mega_states, jax_model
from test_torch_muscle_mega import reference_mode

E = 8


@pytest.mark.parametrize("full", [False, True], ids=["small", "full"])
def test_g1_plan_matches_jax_row_plan(full, monkeypatch):
    from loco_mujoco_tpu.core.io import make_data as jax_make_data
    from loco_mujoco_tpu.ops import collision as jcoll
    from loco_mujoco_tpu.ops import kinematics as jkin

    leaves, aux = export_model(jax_model(full))
    tm = tio.model_from_numpy(leaves, aux, device="cpu")
    monkeypatch.setenv("LMT_MESH_VCAP", str(max(tm.mesh_vert.shape[1], 8)))
    monkeypatch.setattr(pc, "_PLAN_CACHE", {})
    with jax.enable_x64(False):
        jm = jax_model(full, dtype=jnp.float32)
        jd = jax.jit(lambda d: jcoll.collision(jm, jkin.kinematics(
            jm, d)))(jax_make_data(jm))
        jp = pc.get_plan(jm, jd.contact)
    tp = tm.plan
    assert jp is not None and tp is not None
    for field in ("elliptic", "mega_ell", "mega", "euler_dv", "smooth",
                  "uniform", "pack_w", "nfric", "nrows", "npad", "ncon",
                  "ne", "nfl", "nl", "rows_per"):
        got, ref = getattr(tp, field), getattr(jp, field)
        assert (list(got) if field == "rows_per" else got) == ref, field
    np.testing.assert_array_equal(tp.con_efcadr, jp.con_efcadr)
    np.testing.assert_array_equal(tp.con_dim, jp.con_dim)
    assert not tp.elliptic and tp.mega_ell and tp.pack_w == 26


@pytest.fixture(scope="module")
def outputs():
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td = g1_mega_states(mp, E)
            reference_mode(mp)
            one_key_chain(mp)
            d = coll.collision(tm, kinematics.kinematics(tm, td))
            ws = hf.fused_constraint_plain(tm, d).qacc
            d = d.replace(qacc_warmstart=ws)
            jd = jd.replace(qacc_warmstart=jnp.asarray(ws.numpy()))
            plan = pc.get_plan(jm, jax.tree_util.tree_map(lambda x: x[0],
                                                          jd).contact)
            assert plan.pack_w == tm.plan.pack_w == 26
            ref = jax.jit(jax.vmap(lambda d: pc.fused_constraint(
                jm, d, plan)))(jd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    return tm, d, ref, hf.fused_constraint_plain(tm, d)


@pytest.mark.parametrize("field", ["qacc", "euler_dv", "qfrc_constraint",
                                   "efc_force_contact"])
def test_g1_fused_plain_matches_jax_kernel(outputs, field):
    tm, d, ref, got = outputs
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field == "efc_force_contact":
        active = (d.contact.dist < d.contact.includemargin).numpy()
        assert int(active.sum()) > E, "too few active contact slots"
        for grp in tm.groups:  # every group has a slot in contact
            assert active[:, grp.offset:grp.offset + grp.k * grp.slots].any()
        w = min(g.shape[-1], r.shape[-1])
        g, r = g[..., :w], r[..., :w]
    assert np.abs(g - r).max() / (np.abs(r).max() + 1e-9) < 5e-4
