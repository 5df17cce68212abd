"""The port's muscle plan and mega forward (float32, on the CPU: the
kernel's plain version) against the JAX package's plan and its
interpret-mode mega kernel, on the small muscle fixture.

`test_torch_fixture.mega_states(muscle=True)`: 8 envs in light contact, the
4 muscles' ctrls in [0, 1] and activations from `seeded_act` (every fourth
above 1, at full control), beside the 4 joint motors; the JAX plan is
built afresh with `LMT_MESH_VCAP` at the fixture's vertex-table width.

1. The plan against `pallas_constraint.get_plan`: the flags `smooth`,
   `smooth_mu`, `mega`, `euler_dv`, the motors' actuator and dof indices
   and every table of `pallas_fk.MusclePlan`, equal (floats as the
   reference's float32; its incidence tables built here from
   `tendon.site_path_tables`), and the kernels' tables read from those.
2. `hopper_mega.mega_forward_plain` (the mega path's forward) against
   `pallas_constraint.mega_forward` (`_mega_batched`, the muscle block
   inlined): qacc, qfrc_constraint, efc_force_contact and act_dot within rel
   5e-4 of the largest value.

The reference's `pallas_fk._gather_dot` splits its table into two bfloat16
pieces and rounds the other operand to bfloat16 when the contraction runs
over more than 8 entries: exact for the one-hot gathers of its collision
stage, but its muscle block gathers site coordinates, qvel-weighted cdof
and forces through it (~1% of qacc_smooth on this fixture). The comparison
therefore runs it in float32 (`exact_gather_dot`), as the reference's XLA
path and the port compute. Both forwards warm-start from the port's own
converged solve of the same state (tests/test_torch_fused.py: from a cold
start float32 summation orders stop some envs one Newton step apart). The
staged path's non-smooth fused stage is held in
tests/test_torch_muscle_fused.py, the Euler megastep in
tests/test_torch_muscle_megastep.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu.ops import pallas_fk as pfk
from loco_mujoco_tpu.ops import pallas_newton as pn
from loco_mujoco_tpu_torch.ops import forward, tendon
from loco_mujoco_tpu_torch.ops.support import dof_body_mask
from test_torch_fixture import mega_states

E = 8


def exact_gather_dot(tbl, x):
    """`pallas_fk._gather_dot` in float32: (R, V) table x (V, *E) rows."""
    return jax.lax.dot_general(tbl, x, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)


def reference_mode(mp):
    """The JAX package's Pallas kernels in interpret mode, as its own tests
    run them, with `_gather_dot` in float32 (see the module note)."""
    mp.setattr(pn, "_INTERPRET", True)
    mp.setattr(pn, "pallas_enabled", lambda: True)
    mp.setattr(pfk, "_gather_dot", exact_gather_dot)


def forwards(path):
    """(port model, reference forward as numpy, port forward, JAX plan,
    reference act bounds) on the states of `mega_states`, on the mega path
    or the staged path (`LMT_MEGA=0`), both warm-started from the port's
    converged solve."""
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td = mega_states(mp, full=False, n_envs=E,
                                         muscle=True)
            reference_mode(mp)
            if path == "staged":
                mp.setenv("LMT_MEGA", "0")
            jplan = pc.get_plan(
                jm, jax.tree_util.tree_map(lambda x: x[0], jd).contact)
            ws = forward.forward(tm, td).qacc
            t = td.replace(qacc_warmstart=ws)
            j = jd.replace(qacc_warmstart=jnp.asarray(ws.numpy()))
            ref = jax.jit(jax.vmap(lambda d: jfwd.forward(jm, d)))(j)
            return (tm, jax.tree_util.tree_map(np.asarray, ref),
                    forward.forward(tm, t), jplan, pc._act_bounds_static(jm))
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def outputs():
    tm, ref, got, jplan, bounds = forwards("mega")
    return tm, {"mega": (ref, got), "jplan": jplan, "act_bounds": bounds}


def test_plan_matches_jax_plan(outputs):
    tm, out = outputs
    jp, tp = out["jplan"], tm.plan
    assert jp is not None and tp is not None
    flags = ("smooth", "smooth_mu", "mega", "euler_dv", "uniform")
    assert [bool(getattr(tp, f)) for f in flags] == \
        [bool(getattr(jp, f)) for f in flags] == \
        [False, True, True, True, True]
    assert [(a["u"], a["v"]) for a in tp.sm_acts] == \
        [(a["u"], a["v"]) for a in jp.sm_acts]
    for field in ("nrows", "ncon", "ne", "nfl", "nl", "na"):
        assert getattr(tp, field) == getattr(jp, field), field
    assert list(zip(*tp.act_bounds)) == list(out["act_bounds"])


def incidence_tables(tm):
    """The reference's incidence tables of the muscle stage, built from the
    staged path's `tendon.site_path_tables` on the loaded model (the plan
    keeps only the kernels' per-muscle, per-segment and per-site tables):
    SB and SBo (site -> body, and the site's local position), GA and GB
    (segment -> its first and second site), WA and WB (the dof chains of
    a segment's endpoints), S_u (muscle -> its tendon's segments)."""
    site_ids, GA, GB, S, WA, WB = tendon.site_path_tables(
        tm.tendon_site, tm.tendon_sitemask, tm.site_bodyid,
        dof_body_mask(tm))
    spos = tm.site_pos.numpy()
    SB = np.zeros((len(site_ids), tm.nbody), np.float32)
    SBo = np.zeros((3, len(site_ids), tm.nbody), np.float32)
    for i, s in enumerate(site_ids):
        SB[i, tm.site_bodyid[s]] = 1.0
        SBo[:, i, tm.site_bodyid[s]] = spos[s]
    tid = np.asarray(tm.actuator_trnid)[tm.plan.mp.mus, 0]
    return {"SB": SB, "SBo": SBo, "GA": np.float32(GA), "GB": np.float32(GB),
            "WA": np.float32(WA), "WB": np.float32(WB),
            "S_u": np.float32(S)[tid]}


@pytest.mark.parametrize("name", [
    "SB", "SBo", "GA", "GB", "WA", "WB", "S_u", "prm", "site_ids", "mus",
    "gear", "act_adr", "ctrl_lim", "force_lim", "nmus", "nseg", "ns",
    "clampctrl", "actuation_on"])
def test_muscle_tables_match(outputs, name):
    tm, out = outputs
    tables = incidence_tables(tm)
    got = tables[name] if name in tables else getattr(tm.plan.mp, name)
    ref = getattr(out["jplan"].mp, name)
    if isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


def test_kernel_tables_follow_incidence(outputs):
    """The kernels' tables are the incidence tables' content: each muscle's
    segments in `i_seg` (their first and second site, in the tendon's
    order, from `i_mus`' range), each site's body and local position."""
    tm, _ = outputs
    mp, t = tm.plan.mp, incidence_tables(tm)
    for i, q in enumerate(mp.i_mus):
        segs = np.nonzero(t["S_u"][i])[0]
        assert q[1] == len(segs)
        assert mp.i_seg[q[0]:q[0] + q[1]] == [
            [int(t["GA"][k].argmax()), int(t["GB"][k].argmax())]
            for k in segs]
    assert mp.i_site == [int(b) for b in t["SB"].argmax(axis=1)]
    np.testing.assert_array_equal(
        np.float32(mp.f_site)[:, :3],
        np.einsum("cib,ib->ic", t["SBo"], t["SB"]))


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact", "act_dot"])
def test_mega_forward_matches_jax_mega_kernel(outputs, field):
    tm, out = outputs
    ref, got = out["mega"]
    close(got, ref, field)


def close(got, ref, field):
    """got's field within rel 5e-4 of ref's largest value (facet forces:
    the common width, the active slots enough)."""
    g, r = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
    if field == "efc_force_contact":
        active = (g != 0).any(axis=-1)
        assert int(active.sum()) > 2 * E, "too few active contact slots"
        w = min(g.shape[-1], r.shape[-1])
        assert not g[..., w:].any() and not r[..., w:].any()
        g, r = g[..., :w], r[..., :w]
    assert np.abs(g - r).max() / (np.abs(r).max() + 1e-9) < 5e-4
