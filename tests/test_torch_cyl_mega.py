"""Plane-cylinder groups on the mega path: the H1- and Atlas-shaped
fixtures (`test_torch_h1_fixture`, `test_torch_atlas_fixture`).

- The port's forward on the mega path (float32, on the CPU: the plain
  version of the mega kernel, `hopper_mega.mega_forward_plain`) against
  the JAX package's mega kernel (`pallas_constraint._mega_batched` with
  `pallas_fk.collide_env_block`'s box, cylinder and mesh branches), run in
  interpret mode as tests/test_mega.py runs it, on the small variants: H1's
  plane-cylinder group takes its pairs in order (k == P) beside a
  plane-mesh group, Atlas's plane-cylinder and plane-box groups the top-K
  (k < P). 8 envs of `biped_states`: env 0 stands with its heel discs
  upright on the floor (the rim direction's fallback to the geom's x
  axis), env 1 with them tipped onto their rim. Tolerances are
  tests/test_mega.py's: qacc, qfrc_constraint and efc_force_contact within
  rel 5e-4 of the largest value; active slots equal, geom2 exact on them,
  depths atol 1e-5. Both forwards warm-start from the port's own forward
  of the same state (test_torch_mega.py). The reference's top-K rounds
  take `m = min(key)` and then the pair where `key == m`; under interpret
  mode on the CPU, XLA may compute `key` twice, in two fusions that round
  differently, and the equality then misses by an ulp and gathers no pair
  (pallas_fk.py:1966-1972 notes it and its extended collision scans
  instead). Here its stacked arrays are pinned by an optimization barrier
  (`one_key_chain`), an identity, so that each round compares the
  key with its own minimum, as the kernel on the TPU does.
- The float64 staged forward of each fixture against the JAX package's
  XLA path, qacc and the constraint forces at rel 1e-7
  (test_torch_forward.py's tolerance).
- The plan: the cylinder tables (F_CYL, I_CYL and the NCYL / KCYL / OFFCYL
  counts) hold the group's pairs in `contact_groups`' order, and match the
  JAX package's `ColPlan` on both full-width fixtures; a second
  plane-cylinder group, or a pair margin that differs, gets no mega plan.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_atlas_fixture as atlas_fix
import test_torch_h1_fixture as h1_fix
from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import collision as jcoll
from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import kinematics as jkin
from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu.ops import pallas_fk as pf
from loco_mujoco_tpu.ops import pallas_newton as pn
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import forward as fwd
from loco_mujoco_tpu_torch.ops import plan as tplan
from test_torch_fixture import export_model
from test_torch_forward import _staged

E = 8
FIXTURES = {"h1": h1_fix, "atlas": atlas_fix}


def one_key_chain(monkeypatch):
    """The reference's collision with every stacked array of
    `pallas_fk` (its top-K keys among them) behind an optimization
    barrier: one value per key, however XLA fuses its consumers (see the
    module note)."""
    proxy = types.ModuleType("jnp")
    proxy.__getattr__ = lambda name: getattr(jnp, name)
    proxy.stack = lambda xs, *a, **k: jax.lax.optimization_barrier(
        jnp.stack(xs, *a, **k))
    monkeypatch.setattr(pf, "jnp", proxy)


@pytest.fixture(scope="module", params=list(FIXTURES))
def outputs(request):
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td = h1_fix.cyl_states(mp, FIXTURES[request.param], E)
            d0 = jax.tree_util.tree_map(lambda x: x[0], jd)
            jplan = pc.get_plan(jm, d0.contact)
            assert jplan is not None and jplan.mega, "the reference's mega"
            mp.setattr(pn, "_INTERPRET", True)
            mp.setattr(pn, "pallas_enabled", lambda: True)
            one_key_chain(mp)
            ws = fwd.forward(tm, td).qacc
            td = td.replace(qacc_warmstart=ws)
            jd = jd.replace(qacc_warmstart=jnp.asarray(ws.numpy()))
            ref = jax.jit(jax.vmap(lambda d: jfwd.forward(jm, d)))(jd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    return request.param, tm, ref, fwd.forward(tm, td)


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def _cyl_slots(tm):
    g = next(g for g in tm.groups if g.t2 == 5)  # GeomType.CYLINDER
    return g, slice(g.offset, g.offset + g.k * g.slots)


def test_cyl_mega_takes_the_mega_path(outputs):
    """The mega plan with its plane-cylinder group (pairs in order on H1,
    the top-K on Atlas); the cylinder slots in contact, env 0's heel discs
    upright with their three near-cap rim slots at one depth."""
    name, tm, ref, got = outputs
    plan = tm.plan
    assert plan.mega and not plan.mega_ell
    cyl = next(d for d in plan.groups if d["kind"] == "cyl")
    assert (cyl["k"] == len(cyl["pairs"])) == (name == "h1")
    if name == "atlas":
        assert all(d["k"] < len(d["pairs"]) for d in plan.groups)
    g, sl = _cyl_slots(tm)
    active = (got.contact.dist < got.contact.includemargin).numpy()
    assert active[:, sl].sum() > E, "too few active cylinder slots"
    assert active[0, sl].any() and active[1, sl].any()
    heel = tm.names["geom"]["heel_r"]
    on0 = np.nonzero(got.contact.geom2.numpy()[0, sl] == heel)[0]
    d0 = got.contact.dist.numpy()[0, sl][on0]
    assert len(on0) == 4 and np.all(d0[:3] == d0[0]), d0
    assert bool((got.contact.geom1 == plan.plane_gid).all())


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact"])
def test_cyl_mega_forward_matches_jax_mega_kernel(outputs, field):
    name, tm, ref, got = outputs
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field == "efc_force_contact":
        w = min(g.shape[-1], r.shape[-1])
        assert not g[..., w:].any() and not r[..., w:].any()
        g, r = g[..., :w], r[..., :w]
    assert rel_err(g, r) < 5e-4, name


def test_cyl_mega_contacts_match_jax_mega_kernel(outputs):
    name, tm, ref, got = outputs
    active = ref.contact.dist < ref.contact.includemargin
    np.testing.assert_array_equal(
        (got.contact.dist < got.contact.includemargin).numpy(), active)
    np.testing.assert_array_equal(got.contact.geom2.numpy()[active],
                                  ref.contact.geom2[active])
    err = np.abs(got.contact.dist.numpy() - ref.contact.dist)[active].max()
    assert err <= 1e-5


@pytest.mark.parametrize("name", list(FIXTURES))
def test_cyl_staged_float64_matches_xla(name):
    """The staged forward in float64 (no plan: the port's collision,
    make_constraint and Newton solve) against the XLA path."""
    jm, tm = FIXTURES[name].torch_model(full=False)
    qpos, qvel, ctrl = h1_fix.biped_states(tm, 4)
    d0 = jax_make_data(jm)
    jd = jax.vmap(lambda q, v, u: d0.replace(qpos=q, qvel=v, ctrl=u))(
        qpos, qvel, ctrl)
    ref, (_, _, _, _, active) = jax.jit(jax.vmap(lambda d: _staged(jm, d)))(
        jd)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    got = fwd.forward(tm, tio.make_data(tm, 4).replace(
        qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl)))
    assert np.asarray(active).sum() > 8, "too few active rows"
    for field in ("qacc", "qfrc_constraint", "efc_force_contact"):
        assert rel_err(getattr(got, field).numpy(),
                       getattr(ref, field)) < 1e-7, field


@pytest.mark.parametrize("name", list(FIXTURES))
def test_cyl_plan_tables_match_groups(name, monkeypatch):
    """The cylinder tables hold the group's pairs in `contact_groups`'
    order (geom, body, local pose, radius and half-length, margin) and
    its budget and first slot; the groups match the JAX `ColPlan`."""
    jm = FIXTURES[name].jax_model(True)
    leaves, aux = export_model(jm)
    tm = tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float32)
    plan = tm.plan
    g, _ = _cyl_slots(tm)
    ints, flts = plan.pack()
    H = tplan.H
    assert (ints[H["NCYL"]], ints[H["KCYL"]], ints[H["OFFCYL"]]) == (
        len(g.pair_ids), g.k, g.offset)
    gid = np.asarray(tm.pair_geom2)[g.pair_ids]
    icyl = ints[ints[H["I_CYL"]]:][:2 * len(gid)].reshape(-1, 2)
    np.testing.assert_array_equal(icyl[:, 1], gid)
    np.testing.assert_array_equal(icyl[:, 0], np.asarray(tm.geom_bodyid)[gid])
    fcyl = flts[ints[H["F_CYL"]]:][:12 * len(gid)].reshape(-1, 12)
    np.testing.assert_array_equal(fcyl[:, :3], tm.geom_pos[gid].numpy())
    np.testing.assert_array_equal(fcyl[:, 3:7], tm.geom_quat[gid].numpy())
    np.testing.assert_array_equal(fcyl[:, 7:9], tm.geom_size[gid, :2].numpy())
    np.testing.assert_array_equal(fcyl[:, 10], tm.pair_margin[g.pair_ids])
    # the JAX plan, built as its forward builds it
    monkeypatch.setenv("LMT_MESH_VCAP", str(max(tm.mesh_vert.shape[1], 8)))
    monkeypatch.setattr(pc, "_PLAN_CACHE", {})
    d = jax.jit(lambda d: jcoll.collision(jm, jkin.kinematics(
            jm, d)))(jax_make_data(jm))
    with jax.enable_x64(False):
        jp = pc.get_plan(jm, d.contact)
    assert jp is not None and jp.mega and plan.mega
    def desc(groups):
        return [(d["kind"], d["k"], d["slots"], d["margin"]) for d in groups]

    assert desc(jp.colp.groups) == desc(plan.groups)
    assert [d["offset"] for d in plan.groups] == [g.offset for g in tm.groups]
    for a, b in zip(plan.groups, jp.colp.groups):
        assert [(p["gid"], p["body"]) for p in a["pairs"]] == \
            [(p["gid"], p["body"]) for p in b["pairs"]]
        for p, q in zip(a["pairs"], b["pairs"]):
            for k in ("gpos", "gquat", "size"):
                if k in q:
                    assert p[k] == q[k], k
    assert (plan.nrows, plan.ncon) == (jp.nrows, jp.ncon)


@pytest.mark.parametrize("change", ["split", "margin"])
def test_cyl_outside_the_envelope_gets_no_mega_plan(change):
    """Two plane-cylinder groups (the Atlas group split in two): no
    plane-only mega plan, so the extended plan with pyramidal rows takes
    the model (the reference's gate, `pallas_constraint.py:435-460`: any
    smooth model that the plane-only plan refuses); one cylinder pair's
    margin changed (statics no longer uniform within the group): a row
    plan, no mega of either kind."""
    leaves, aux = tio.read_model_npz(atlas_fix.ASSET)
    m = tio.model_from_numpy(leaves, aux, device="cpu")
    assert m.plan.mega
    if change == "margin":
        g, _ = _cyl_slots(m)
        arr = np.array(leaves["pair_margin"])
        arr[g.pair_ids[-1]] = 0.01
        leaves["pair_margin"] = arr
        m = tio.model_from_numpy(leaves, aux, device="cpu")
        assert m.plan is not None and not m.plan.mega
        assert not m.plan.mega_ell and m.plan.pack_w == 26
        return
    g = m.groups[0]
    half = len(g.pair_ids) // 2
    first = g._replace(pair_ids=g.pair_ids[:half], k=half)
    second = g._replace(pair_ids=g.pair_ids[half:], k=g.k - half,
                        offset=g.offset + 4 * half)
    groups = [first, second, *m.groups[1:]]
    plan = tplan.build_plan(leaves, aux, groups, (None,) * len(groups))
    assert plan is not None and plan.uniform and not plan.groups
    assert plan.mega and plan.mega_ell and not plan.elliptic
