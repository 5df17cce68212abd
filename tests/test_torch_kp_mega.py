"""Plane-mesh groups at k = P on the mega path: the G1-shaped stand-in with
its plane-mesh group at k = P (`test_torch_g1_fixture`, `k_plane` 10: the
small size's 10 hulls, k 10), on the extended collision with pyramidal
rows; the Talos-shaped one (plane-only) is held the same way in
tests/test_torch_talos_mega.py, with the helpers of this module.

At k = P the reference's mega kernels rank every pair of the group,
deepest first, first index on ties (`pallas_fk._mesh_group_slots`
:825-850), while its staged XLA path keeps them in bucket order
(`collision.py:397-410`). The port's mega plain version ranks them
(`hopper_mega.plain_stages`, `collision.collision(ranked=True)`), its
staged path keeps them in order.

- The port's forward on the mega path (float32, on the CPU: the plain
  version of the mega kernel's extended pyramidal instance) against the
  JAX package's `mega_ell` forward (`pallas_constraint._mega_batched`
  with `collide_env_block_ext` and `_mesh_group_slots`), run in interpret
  mode as tests/test_mega.py runs it, its gathers in float32
  (`test_torch_muscle_mega.reference_mode`) and its stacked arrays behind
  an optimization barrier (`test_torch_cyl_mega.one_key_chain`), compiled
  once. 8 envs of `g1_states`. Tolerances are tests/test_mega.py's: qacc,
  qfrc_constraint and efc_force_contact within rel 5e-4 of the largest
  value; active slots equal, geom1 and geom2 exact on active slots, depths
  atol 1e-5. Both forwards warm-start from the port's own forward of the
  same state (test_torch_mega.py). The same port forward with its
  plane-mesh slots in the staged path's order (in order, not ranked)
  parts from the reference on these states: the comparison fails if the
  plain version takes the in-order branch.
- The float64 staged forward against the JAX package's XLA path at rel
  1e-7, its plane-mesh slots in the reference XLA path's order (geom ids
  exact on every slot): tests/test_torch_kp_f64.py, with this module's
  helpers.
- The committed stand-in (census, drift against the generator), its
  plane-mesh group off the staged kernels (`Model.mesh_kernel` None) with
  the mega plan's tables (`RowPlan.mesh`); and every earlier committed
  stand-in's row plan, packed tables and staged mesh plans as they were
  before k = P groups took a mega plan (digests).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_g1_fixture as g1_fix
from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import pallas_constraint as pc
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.core.types import GeomType
from loco_mujoco_tpu_torch.envs import standins
from loco_mujoco_tpu_torch.ops import forward as fwd
from loco_mujoco_tpu_torch.ops import hopper_mega as hm
from test_torch_cyl_mega import one_key_chain
from test_torch_fixture import _same
from test_torch_forward import _staged
from test_torch_h1_fixture import census
from test_torch_muscle_mega import reference_mode

E = 8
# (t1, t2, condim, k, pairs) of each contact group of the k = P stand-in
CENSUS_KP = [(0, 2, 3, 4, 4), (0, 3, 3, 2, 2), (0, 7, 3, 10, 10),
             (2, 2, 3, 2, 4), (2, 3, 3, 2, 4), (3, 3, 3, 1, 1)]
# sha256 (first 16 hex digits) of each committed stand-in's row plan (its
# packed int and float tables, mega, mega_ell, slots, rows) and staged
# plane-mesh plans, as the tree before k = P groups took a mega plan
# computed them (`_digest`); the torque humanoid's no-plan configuration
# (34 slots per mesh group) and G1 with its arms' (20 hulls at k = P)
# beside them
DIGESTS = {
    ("humanoid", None): "0f42c690e7d9449d", ("muscle", None): "7d2bb8aa7fbfa041",
    ("a1", None): "c71f2761548591c5", ("a1pos", None): "cd577caf20a38f58",
    ("h1", None): "6ed717712a194577", ("atlas", None): "b25fcdd9f3571bd3",
    ("g1", None): "5c5ccab9a7a24ccc", ("g1arms", None): "e40ab8825b6fac4d",
    ("h1arms", None): "9a44738770d3f269",
    ("atlasarms", None): "8f1fadf0bcf61069",
    ("humanoid", 34): "90705930282ed6d0", ("g1arms", 20): "26910a72a74a4f0d",
}


def mega_outputs(states, in_order=False):
    """(port model, reference forward as numpy, port forward) on the mega
    path for the fixture states `states(monkeypatch, E)` (a `*_mega_states`
    of the fixtures: JAX model, port model, JAX data, port data in
    float32), the reference in interpret mode, compiled once; with
    `in_order` also the port's forward with the plane-mesh slots in the
    staged path's order (the in-order branch at k = P)."""
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td = states(mp, E)
            jplan = pc.get_plan(jm, jax.tree_util.tree_map(
                lambda x: x[0], jd).contact)
            assert jplan is not None and jplan.mega, "the reference's mega"
            reference_mode(mp)
            one_key_chain(mp)
            ws = fwd.forward(tm, td).qacc
            td = td.replace(qacc_warmstart=ws)
            jd = jd.replace(qacc_warmstart=jnp.asarray(ws.numpy()))
            ref = jax.jit(jax.vmap(lambda d: jfwd.forward(jm, d)))(jd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    got = fwd.forward(tm, td)
    if not in_order:
        return tm, ref, got, None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hm, "plain_stages", lambda m, d: fwd.stages(
            m, d, plain=True))
        flat = fwd.forward(tm, td)
    return tm, ref, got, flat


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def check_fields(got, ref, field):
    """tests/test_mega.py's rel 5e-4 on a force or acceleration field."""
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field == "efc_force_contact":
        w = min(g.shape[-1], r.shape[-1])
        assert not g[..., w:].any() and not r[..., w:].any()
        g, r = g[..., :w], r[..., :w]
    assert rel_err(g, r) < 5e-4, field


def check_contacts(got, ref):
    """Active slots equal, geom1 and geom2 exact on them, depths atol
    1e-5 (tests/test_mega.py)."""
    active = ref.contact.dist < ref.contact.includemargin
    np.testing.assert_array_equal(
        (got.contact.dist < got.contact.includemargin).numpy(), active)
    for name in ("geom1", "geom2"):
        np.testing.assert_array_equal(
            getattr(got.contact, name).numpy()[active],
            getattr(ref.contact, name)[active])
    err = np.abs(got.contact.dist.numpy() - ref.contact.dist)[active].max()
    assert err <= 1e-5


def check_kp_group(tm, ref, got, flat, pairs=1):
    """The model's plane-mesh group is at k = P, off the staged kernels
    and on the mega plan's tables; the ranked slots hold at least `pairs`
    active pairs in some env, and the in-order layout parts from the
    reference on these states (its active slots or their geoms differ)."""
    gi, g = next((i, g) for i, g in enumerate(tm.groups)
                 if g.t2 == int(GeomType.MESH))
    assert g.k == len(g.pair_ids) and tm.mesh_kernel[gi] is None
    assert tm.plan.mesh is not None and tm.plan.mesh.k == tm.plan.mesh.P
    sl = slice(g.offset, g.offset + g.k * g.slots)
    active = (ref.contact.dist < ref.contact.includemargin)[:, sl]
    pairs_on = active[:, ::g.slots].sum(1)
    assert pairs_on.max() >= pairs, "too few mesh pairs in contact"
    on = (flat.contact.dist < flat.contact.includemargin).numpy()[:, sl]
    same = np.all(on == active, axis=1) & np.all(
        np.where(active, flat.contact.geom2.numpy()[:, sl]
                 == ref.contact.geom2[:, sl], True), axis=1)
    assert not same.all(), "the in-order layout matches the ranked one"


def staged_f64(fixture_model, states, n=4):
    """(port forward, JAX XLA forward, active rows) of the float64 staged
    forward on `states(model, n)` of the small fixture."""
    jm, tm = fixture_model()
    qpos, qvel, ctrl = states(tm, n)
    d0 = jax_make_data(jm)
    jd = jax.vmap(lambda q, v, u: d0.replace(qpos=q, qvel=v, ctrl=u))(
        qpos, qvel, ctrl)
    ref, (_, _, _, _, active) = jax.jit(jax.vmap(lambda d: _staged(jm, d)))(
        jd)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    got = fwd.forward(tm, tio.make_data(tm, n).replace(
        qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl)))
    return tm, got, ref, active


def check_staged_f64(tm, got, ref, active):
    """rel 1e-7 (test_torch_forward.py's tolerance), and every slot's geoms
    in the reference XLA path's order (its plane-mesh group at k = P in
    bucket order, not ranked)."""
    assert np.asarray(active).sum() > 8, "too few active rows"
    for field in ("qacc", "qfrc_constraint", "efc_force_contact"):
        assert rel_err(getattr(got, field).numpy(),
                       getattr(ref, field)) < 1e-7, field
    for name in ("geom1", "geom2"):
        np.testing.assert_array_equal(getattr(got.contact, name).numpy(),
                                      np.asarray(getattr(ref.contact, name)))


def _digest(m) -> str:
    h = hashlib.sha256()
    if m.plan is not None:
        ints, flts = m.plan.pack()
        h.update(ints.tobytes())
        h.update(flts.tobytes())
        h.update(repr((m.plan.mega, m.plan.mega_ell, m.plan.ncon,
                       m.plan.nrows)).encode())
    else:
        h.update(b"none")
    for mk in m.mesh_kernel:
        if mk is None:
            h.update(b"-")
            continue
        # the geoms the group uses and each pair's two among them, as the
        # plans held them before the kernel read the poses in place
        used = np.unique(np.concatenate([mk.pg1, mk.pg2])).astype(np.int64)
        pg_local = np.searchsorted(used, np.stack([mk.pg1, mk.pg2], 1))
        for a in (mk.pid, mk.flat, mk.pair_i, mk.pair_f, mk.tbl16,
                  pg_local.astype(np.int32), used):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(str(mk.k).encode())
    return h.hexdigest()[:16]


# --------------------------------------------------------------------------
# G1 at k = P
# --------------------------------------------------------------------------


def kp_states(mp, n):
    return g1_fix.g1_mega_states(mp, n, k_plane=g1_fix.K_PLANE_KP)


@pytest.fixture(scope="module")
def outputs():
    return mega_outputs(kp_states, in_order=True)


def test_kp_mega_takes_the_ext_pyramidal_path(outputs):
    """The extended plan with pyramidal rows (the kernels' instance 2),
    its plane-mesh group at k = P ranked; the in-order layout parts from
    the reference on these states."""
    tm, ref, got, flat = outputs
    plan = tm.plan
    assert plan.mega and plan.mega_ell and not plan.elliptic
    assert hm.ext_mode(plan) == 2 and plan.euler_dv
    check_kp_group(tm, ref, got, flat)


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact"])
def test_kp_mega_forward_matches_jax_mega_ell(outputs, field):
    tm, ref, got, _ = outputs
    check_fields(got, ref, field)


def test_kp_mega_contacts_match_jax(outputs):
    tm, ref, got, _ = outputs
    check_contacts(got, ref)
    for name in ("includemargin", "friction"):
        np.testing.assert_allclose(getattr(got.contact, name).numpy(),
                                   getattr(ref.contact, name), rtol=1e-6)


def test_kp_standin_census():
    """The committed k = P stand-in: the small G1 at plane budget 10 (its
    hull count), 44 slots, the extended pyramidal plan; its plane-mesh
    group off the staged kernels, on the mega plan's tables."""
    m = standins.load_standin("g1kp", device="cpu")
    assert m.nv == 15 and census(m) == CENSUS_KP
    plan = m.plan
    assert plan.mega and plan.mega_ell and not plan.elliptic
    assert (plan.ncon, plan.nrows) == (44, 192)
    gi = next(i for i, g in enumerate(m.groups) if g.t2 == int(GeomType.MESH))
    assert m.mesh_kernel[gi] is None
    assert plan.mesh is plan.ext_mesh["mesh"] and plan.mesh.k == 10 == \
        plan.mesh.P
    assert standins.standin_kind(m) == "g1"


def test_committed_kp_npz_matches_generator(tmp_path):
    fresh = tmp_path / "fresh.npz"
    g1_fix.write_kp(fresh)
    got_l, got_a = tio.read_model_npz(fresh)
    ref_l, ref_a = tio.read_model_npz(g1_fix.ASSET_KP)
    assert got_l.keys() == ref_l.keys() and got_a.keys() == ref_a.keys()
    for k in ref_l:
        np.testing.assert_array_equal(got_l[k], ref_l[k], err_msg=k)
    for k in ref_a:
        assert _same(got_a[k], ref_a[k]), k


@pytest.mark.parametrize("name,k_plane", list(DIGESTS))
def test_earlier_standins_keep_their_plans(name, k_plane):
    """Every earlier committed stand-in keeps its row plan, its packed
    tables and its staged plane-mesh plans (`Model.mesh_kernel`)."""
    from pathlib import Path

    root = Path(standins.__file__).resolve().parent.parent / "assets"
    leaves, aux = tio.read_model_npz(root / f"{standins.STANDINS[name]}.npz")
    if k_plane is not None:
        aux["contact_k_plane"] = k_plane
    m = tio.model_from_numpy(leaves, aux, device="cpu", dtype=torch.float32)
    assert _digest(m) == DIGESTS[(name, k_plane)]
