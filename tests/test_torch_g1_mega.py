"""The G1-shaped fixture (`test_torch_g1_fixture`) on the extended mega path
with pyramidal rows and a plane-mesh group.

- The port's forward on the mega path (float32, on the CPU: the plain
  version of the mega kernel's extended pyramidal instance,
  `hopper_mega.mega_forward_plain`: the staged collision, then the fused
  constraint plain version with the generic 26-float slots and a float32
  solve) against the JAX package's `mega_ell` forward
  (`pallas_constraint._mega_batched` with
  `pallas_fk.collide_env_block_ext`, its plane-mesh group through
  `_mesh_group_slots`, and `_mega_ell_finish`'s blocked facet rows), run in
  interpret mode as tests/test_mega.py runs it, with its gathers in
  float32 (`test_torch_muscle_mega.reference_mode`) and its stacked arrays
  behind an optimization barrier (`test_torch_cyl_mega.one_key_chain`).
  Small fixture, 8 envs of `g1_states` (standing, and each self group in
  contact in envs 1-3). Tolerances are tests/test_mega.py's: qacc,
  qfrc_constraint and efc_force_contact within rel 5e-4 of the largest
  value; active slots equal, geom1 and geom2 exact on active slots, depths
  atol 1e-5; the per-slot includemargin and friction the groups' statics
  (rel 1e-6). Both forwards warm-start from the port's own forward of the
  same state, as a stepped env is (test_torch_mega.py).
- The float64 staged forward against the JAX package's XLA path, qacc and
  the constraint forces at rel 1e-7 (test_torch_forward.py's tolerance).
- The plan's extended tables: the plane-mesh group's pairs in its
  `MeshPlan`'s order, their geoms, bodies and invweights, and the hull
  tables the plane-only plan would carry.
"""

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
from loco_mujoco_tpu_torch.ops import forward as fwd
from loco_mujoco_tpu_torch.ops import hopper_mega as hm
from loco_mujoco_tpu_torch.ops import plan as tplan
from test_torch_cyl_mega import one_key_chain
from test_torch_forward import _staged
from test_torch_muscle_mega import reference_mode

E = 8


@pytest.fixture(scope="module")
def outputs():
    mp = pytest.MonkeyPatch()
    try:
        with jax.enable_x64(False):
            jm, tm, jd, td = g1_fix.g1_mega_states(mp, E)
            jplan = pc.get_plan(jm, jax.tree_util.tree_map(
                lambda x: x[0], jd).contact)
            assert jplan is not None and jplan.mega_ell, "the reference's"
            reference_mode(mp)
            one_key_chain(mp)
            ws = fwd.forward(tm, td).qacc
            td = td.replace(qacc_warmstart=ws)
            jd = jd.replace(qacc_warmstart=jnp.asarray(ws.numpy()))
            ref = jax.jit(jax.vmap(lambda d: jfwd.forward(jm, d)))(jd)
            ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        mp.undo()
    return tm, ref, fwd.forward(tm, td)


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def test_g1_mega_takes_the_ext_pyramidal_path(outputs):
    """The extended plan with pyramidal rows (the kernels' instance 2), its
    mesh group ranked (k < P), and every group in contact somewhere."""
    tm, ref, got = outputs
    plan = tm.plan
    assert plan.mega and plan.mega_ell and not plan.elliptic
    assert hm.ext_mode(plan) == 2 and plan.euler_dv
    active = (got.contact.dist < got.contact.includemargin).numpy()
    for g in tm.groups:
        assert active[:, g.offset:g.offset + g.k * g.slots].any(), g[:3]
    mesh = next(g for g in tm.groups if g.t2 == int(GeomType.MESH))
    assert mesh.k < len(mesh.pair_ids)


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact"])
def test_g1_mega_forward_matches_jax_mega_ell(outputs, field):
    tm, ref, got = outputs
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field == "efc_force_contact":
        w = min(g.shape[-1], r.shape[-1])
        assert not g[..., w:].any() and not r[..., w:].any()
        g, r = g[..., :w], r[..., :w]
    assert rel_err(g, r) < 5e-4


def test_g1_mega_contacts_match_jax(outputs):
    tm, ref, got = outputs
    active = ref.contact.dist < ref.contact.includemargin
    np.testing.assert_array_equal(
        (got.contact.dist < got.contact.includemargin).numpy(), active)
    for name in ("geom1", "geom2"):
        np.testing.assert_array_equal(
            getattr(got.contact, name).numpy()[active],
            getattr(ref.contact, name)[active])
    err = np.abs(got.contact.dist.numpy() - ref.contact.dist)[active].max()
    assert err <= 1e-5
    for name in ("includemargin", "friction"):
        np.testing.assert_allclose(getattr(got.contact, name).numpy(),
                                   getattr(ref.contact, name), rtol=1e-6)


def test_g1_staged_float64_matches_xla():
    """The staged forward in float64 (no plan: the port's collision, its
    plane-mesh group by the XLA port, make_constraint and the Newton
    solve) against the XLA path."""
    jm, tm = g1_fix.torch_model(full=False)
    qpos, qvel, ctrl = g1_fix.g1_states(tm, 4)
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


def test_g1_ext_plan_mesh_tables():
    """The extended plan's plane-mesh group: kind 8, its pairs (I_XPAIR,
    F_XPAIR) in its MeshPlan's order with the plane as geom 1, both
    bodies and the slot invweight, and the hull tables (F_MESH, I_MESH,
    F_VERT; NMESH, KMESH, OFFMESH) the plane-only plan builds from the
    same MeshPlan."""
    tm = tio.load_model_npz(g1_fix.ASSET, device="cpu")
    plan = tm.plan
    gi = next(i for i, g in enumerate(tm.groups) if g.t2 == int(GeomType.MESH))
    g, mk = tm.groups[gi], tm.mesh_kernel[gi]
    d = plan.ext[gi]
    assert (d["kind"], d["k"], d["slots"], d["offset"]) == (8, g.k, 3,
                                                            g.offset)
    floor = tm.names["geom"]["floor"]
    gb = np.asarray(tm.geom_bodyid)
    biw = np.asarray(tm.body_invweight0[:, 0], np.float32)
    assert [r for r in d["ints"]] == [[floor, 0, int(q), int(gb[q])]
                                      for q in mk.pg2]
    np.testing.assert_array_equal([r[22] for r in d["floats"]],
                                  biw[gb[mk.pg2]] + biw[0])
    ints, flts = plan.pack()
    H = tplan.H
    assert (ints[H["NMESH"]], ints[H["KMESH"]], ints[H["OFFMESH"]]) == (
        mk.P, g.k, g.offset)
    imesh = ints[ints[H["I_MESH"]]:][:5 * mk.P].reshape(-1, 5)
    np.testing.assert_array_equal(imesh[:, 1], mk.pg2)
    np.testing.assert_array_equal(imesh[:, 2:], mk.pair_i)
    fvert = flts[ints[H["F_VERT"]]:][:mk.flat.size]
    np.testing.assert_array_equal(fvert, mk.flat)
