"""Domain randomization of model leaves beyond joint damping: the Joints
section's stiffness, friction loss and armature, the Geoms section
(friction with the pairs' re-mix, mass and density) and the Inertial
section (mass, diaginertia, fullinertia), against the JAX package, on the
CPU.

1. The plan gate (`RowPlan.per_env`): for each leaf that varies per env,
   the port's plan keeps what the JAX package's `RowPlan` keeps when that
   leaf is traced (built inside a trace of the leaf): no plan, the row
   plan without the smooth stage, the generic contact pack, the damping
   rows, and no mega path; on the small humanoid (RK4) and the small H1
   with its carried weight (Euler).
2. `apply` against the JAX handler's `apply` on the same numpy draws, per
   env under vmap, on the small H1 carrying a weight whose inertial comes
   from its box at the default density (its shape constants carried, as
   the committed carry pair carries them): the scattered leaves exactly,
   the eigh-derived `body_inertia` and `body_iquat` and the geom-mass
   jobs' leaves within 1e-10; configs without shape constants or on a
   body with an explicit inertial raise, naming what is missing. The
   principal form of general inertia tensors: moments and the tensor
   rebuilt from the frame within 1e-10 of the JAX package's (LAPACK builds
   may pick other eigenvector signs, a half turn of the frame that leaves
   the tensor as it is).
3. The env with a randomization of Inertial (mass, diaginertia,
   fullinertia), Geoms friction and Joints armature and stiffness against
   the JAX env: tests/test_torch_variants.py, whose variant envs carry it.
4. float32 on the CPU, the kernels' plain versions: masses, inertias and
   armature per env keep the row plan without the smooth stage (the fused
   kernel's non-smooth layout, `fused_constraint_plain`, which reads each
   env's cinert and armature), friction loss per env drops the plan (the
   Newton solve), pair friction per env keeps the smooth plan with the
   generic 26-float pack; each forward's qacc within rel 2e-3 of the
   float64 staged path's on the same per-env model. The plane-mesh
   kernel's plain version gathers each active slot's pair parameters per
   env, as the reference's XLA path gives them, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.ops import pallas_constraint as jpc
from loco_mujoco_tpu.utils import domain_randomization as jdr
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.envs import standins
from loco_mujoco_tpu_torch.ops import forward as fwd
from loco_mujoco_tpu_torch.ops import hopper_fused
from loco_mujoco_tpu_torch.utils import domain_randomization as tdr
import test_torch_h1_fixture as h1fx
from test_torch_dr import jax_handler
from test_torch_env import rel_err
from test_torch_fixture import ASSET, torch_model
from test_torch_variants import as_torch as _torch
from test_torch_variants import draws

E = 4
# the carry fixture's randomization: every section
CARRY_CONF = {
    "Joints": {"knee_angle_r": {"stiffness": {"uniform_range": [1.0, 5.0]},
                                "armature": {"uniform_range_delta": 0.005},
                                "frictionloss": {"sigma": 0.2}}},
    "Inertial": {"pelvis": {"mass": {"uniform_range_delta": 1.0},
                            "diaginertia": {"uniform_range_delta": 0.005}},
                 "thigh_r": {"fullinertia": {"uniform_range_delta": 0.01}}},
    "Geoms": {"foot_r": {"friction": {"uniform_range": [0.5, 1.5]}},
              "weight": {"mass": {"uniform_range": [5.0, 20.0]}}},
}
DENSITY_CONF = {"Geoms": {"weight": {"density": {"sigma": 200.0}}},
                "Inertial": {"weight": {"fullinertia": {
                    "uniform_range_delta": 0.01}}}}


@pytest.fixture(scope="module")
def carry():
    """(JAX model, port model) of the small H1 with a weight at the
    default density, the port's with its shape constants."""
    jm, leaves, aux = h1fx.carry_model(False, "density")
    return jm, tio.model_from_numpy(leaves, aux, device="cpu",
                                    dtype=torch.float64)


# --------------------------------------------------------------------------
# 1. the plan gate
# --------------------------------------------------------------------------

GATE_LEAVES = ("dof_damping", "dof_frictionloss", "dof_armature",
               "jnt_stiffness", "body_mass", "body_inertia", "body_ipos",
               "body_iquat", "pair_friction", "geom_size", "body_pos",
               "mesh_vert", "actuator_gear", "dof_invweight0",
               "body_invweight0")


def _jax_flags(jm, leaf, dims):
    """The JAX RowPlan's flags with `leaf` traced (a trace, no compile)."""
    flags = {}

    def f(x):
        p = jpc.RowPlan(jm.replace(**{leaf: x}), np.asarray(dims), len(dims))
        flags.update(ok=bool(p.ok))
        if p.ok:
            flags.update(smooth=bool(p.smooth), uniform=bool(p.uniform),
                         mega=bool(p.mega), euler_dv=bool(p.euler_dv),
                         dyn=bool(getattr(p, "sm_dyn_damping", False)))
        return x

    jax.make_jaxpr(f)(jnp.asarray(getattr(jm, leaf)))
    return flags


def _port_flags(plan):
    if plan is None:
        return {"ok": False}
    return dict(ok=True, smooth=plan.smooth, uniform=plan.uniform,
                mega=plan.mega, euler_dv=plan.euler_dv,
                dyn=plan.sm_dyn_damping)


@pytest.mark.parametrize("robot", ["humanoid", "h1carry"])
def test_plan_gate_matches_jax(monkeypatch, carry, robot):
    if robot == "humanoid":
        jm, tm = torch_model(full=False)
    else:
        jm, tm = carry
    monkeypatch.setenv("LMT_MESH_VCAP", str(tm.mesh_vert.shape[1]))
    dims = [g.condim for g in tm.groups for _ in range(g.k * g.slots)]
    base = _port_flags(tm.plan)
    assert base["ok"]
    seen = set()
    for leaf in GATE_LEAVES:
        got = _port_flags(tm.plan.per_env({leaf}))
        ref = _jax_flags(jm, leaf, dims)
        assert got == ref, (leaf, got, ref)
        seen.add((got["ok"], got.get("smooth"), got.get("uniform"),
                  got.get("dyn")))
    # every kind of gate shows: none, non-smooth, generic pack, damping
    assert (False, None, None, None) in seen
    assert any(ok and not sm for ok, sm, _, _ in seen)
    assert any(ok and sm and not un for ok, sm, un, _ in seen)
    assert any(dyn for *_, dyn in seen)


# --------------------------------------------------------------------------
# 2. apply
# --------------------------------------------------------------------------


def _jax_apply(jm, jh, draws):
    j = {k: ([jnp.asarray(x) for x in v] if isinstance(v, list)
             else jnp.asarray(v)) for k, v in draws.items()}
    return jax.vmap(lambda s: jh.apply(jm, s))(j)


@pytest.mark.parametrize("conf", [CARRY_CONF, DENSITY_CONF],
                         ids=["every_section", "density"])
def test_apply_matches_jax(carry, conf):
    jm, tm = carry
    h, jh = tdr.DomainRandomizationHandler(tm, conf), jax_handler(jm, conf)
    assert set(h.merged) == set(jh.merged)
    for leaf in h.merged:
        for k in ("idx", "dist", "p1", "p2", "base"):
            np.testing.assert_array_equal(h.merged[leaf][k],
                                          jh.merged[leaf][k])
    assert len(h.fi_jobs) == len(jh.fi_jobs)
    assert len(h.gm_jobs) == len(jh.gm_jobs) == 1
    for a, b in zip(h.gm_jobs, jh.gm_jobs):
        for k in ("m0", "centers", "Ks", "vols"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-15)
        assert a["dists"] == b["dists"]
    assert h.n_params == jh.n_params
    d = draws(h, 3)
    got = h.apply(tm, _torch(d))
    ref = _jax_apply(jm, jh, d)
    assert set(got) == h.leaves
    exact = set(h.merged) | {"pair_friction"}
    for name, v in got.items():
        r = np.asarray(getattr(ref, name))
        assert v.shape == (E, *getattr(tm, name).shape), name
        if name in exact and name not in ("body_mass", "body_inertia"):
            np.testing.assert_array_equal(v.numpy(), r, err_msg=name)
        else:
            np.testing.assert_allclose(v.numpy(), r, rtol=0, atol=1e-10,
                                       err_msg=name)
    w = tm.names["body"]["weight"]
    assert not np.allclose(got["body_mass"][:, w].numpy(),
                           tm.body_mass[w].item())


def test_mass_needs_shape_constants(carry):
    """Without the shape constants a mass or density config raises naming
    them; on a body with an explicit inertial it raises as the JAX
    handler does."""
    jm, tm = carry
    conf = {"Geoms": {"weight": {"mass": {"sigma": 1.0}}}}
    with pytest.raises(ValueError, match="geom_shape"):
        tdr.DomainRandomizationHandler(tm.replace(geom_shape=None), conf)
    explicit = {"Geoms": {"pelvis": {"mass": {"sigma": 1.0}}}}
    with pytest.raises(ValueError, match="explicit"):
        jax_handler(jm, explicit)
    with pytest.raises(ValueError, match="geom_shape|explicit"):
        tdr.DomainRandomizationHandler(tm, explicit)


def test_principal_form_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(64, 3, 3))
    tens = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3)
    tens[:16] = np.stack([np.diag(rng.uniform(0.1, 1, 3)) for _ in range(16)])
    ev, q = tdr._principal(torch.as_tensor(tens))

    def ref_one(m):
        w, v = jnp.linalg.eigh(m)
        w, v = w[::-1], v[:, ::-1]
        v = v * jnp.sign(jnp.linalg.det(v))
        return w, jdr._mat_to_quat_np_like(v)

    rw, rq = jax.vmap(ref_one)(jnp.asarray(tens))
    np.testing.assert_allclose(ev.numpy(), np.asarray(rw), rtol=0,
                               atol=1e-10)

    def rebuilt(w, q):
        R = np.stack([tdr._quat_mat(x) for x in q])
        return np.einsum("eij,ej,ekj->eik", R, w, R)

    np.testing.assert_allclose(rebuilt(ev.numpy(), q.numpy()),
                               rebuilt(np.asarray(rw), np.asarray(rq)),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(rebuilt(ev.numpy(), q.numpy()), tens,
                               rtol=0, atol=1e-10)
    # diagonal tensors (the stand-ins' inertias): the same frames too
    np.testing.assert_allclose(q.numpy()[:16], np.asarray(rq)[:16], rtol=0,
                               atol=1e-10)


# --------------------------------------------------------------------------
# 4. float32: the plain versions of the kernels on the gated plans
# --------------------------------------------------------------------------


@pytest.mark.parametrize("conf, layout", [
    ({"Inertial": {"torso": {"mass": {"uniform_range_delta": 2.0},
                             "fullinertia": {"uniform_range_delta": 0.02}}},
      "Joints": {"knee_r": {"armature": {"uniform_range": [0.01, 0.1]}}}},
     "nonsmooth"),
    ({"Joints": {"knee_r": {"frictionloss": {"uniform_range": [0.2, 1.0]}}}},
     "newton"),
    ({"Geoms": {"foot_r": {"friction": {"uniform_range": [0.5, 1.5]}},
                "shin_l": {"friction": {"sigma": 0.2}}}}, "generic"),
], ids=["nonsmooth", "newton", "generic"])
def test_f32_gated_plans_step(monkeypatch, conf, layout):
    from loco_mujoco_tpu_torch.ops import solver

    tm = tio.load_model_npz(ASSET, device="cpu")
    env = standins.make_env(tm, dr=conf, n_substeps=2)
    plan = env.model_dr.plan
    if layout == "nonsmooth":
        assert plan is not None and not plan.smooth and not plan.mega
    elif layout == "generic":  # per-env pair friction: the 26-float pack
        assert plan.smooth and not plan.uniform and plan.pack_w == 26
    else:
        assert plan is None
    calls = {"fused": 0, "newton": 0}
    fused, solve = hopper_fused.fused_constraint_plain, solver.solve

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(hopper_fused, "fused_constraint_plain",
                        count("fused", fused))
    monkeypatch.setattr(solver, "solve", count("newton", solve))
    s = env.reset_batch(E, torch.Generator().manual_seed(2))
    model, data = env._apply_dr(s.data, s.env_id, s.dr)
    out = fwd.forward(model, data)
    fused_path = layout != "newton"
    assert calls["fused" if fused_path else "newton"] >= 1
    assert calls["newton" if fused_path else "fused"] == 0
    ref = fwd.forward(model.to(dtype=torch.float64).replace(plan=None),
                      data.to(dtype=torch.float64))
    assert rel_err(out.qacc.numpy(), ref.qacc.numpy()) < 2e-3
    s2 = env.step_batch(s, torch.zeros((E, env.action_dim)))
    assert torch.isfinite(s2.data.qpos).all()


def test_mesh_slots_take_each_envs_pair_friction():
    """float32, per-env pair friction (the Geoms section on hulls' bodies):
    the plane-mesh kernel's plain version gathers each active slot's
    friction, solref, solimp and margin by its pair, as the reference's
    XLA path (`collision._plane_mesh_xla`, each env's leaves) gives them."""
    from loco_mujoco_tpu_torch.ops import collision as coll
    from loco_mujoco_tpu_torch.ops import kinematics

    tm = tio.load_model_npz(ASSET, device="cpu")
    conf = {"Default": {"Geoms": {"friction": {"uniform_range": [0.3,
                                                                 1.5]}}}}
    env = standins.make_env(tm, dr=conf, n_substeps=1)
    s = env.reset_batch(8, torch.Generator().manual_seed(4))
    m, d = env._apply_dr(s.data, s.env_id, s.dr)
    assert "pair_friction" in m.varied
    qpos = d.qpos.clone()
    qpos[:, int(tm.jnt_qposadr[tm.names["joint"]["root_z"]])] -= 0.02
    d = kinematics.kinematics(m, d.replace(qpos=qpos))
    gi = next(i for i, p in enumerate(m.mesh_kernel) if p is not None)
    g = m.groups[gi]
    got = coll._plane_mesh_kernel(m, g, m.mesh_kernel[gi], d, plain=True)
    ref = coll._plane_mesh_xla(m, g, d)
    act = (got[0] < got[8][..., None])[..., 0]
    assert act.any()
    np.testing.assert_array_equal(act.numpy(),
                                  (ref[0] < ref[8][..., None])[..., 0].numpy())
    for i in range(3, 9):
        torch.testing.assert_close(got[i][act], ref[i][act], rtol=0, atol=0)
    # each env its own: the slots' friction differs between envs
    f = got[5][act][:, 0]
    assert len(torch.unique(f)) > 1
