"""H1 and Atlas with their arms (`h1_xml(arms=True)`, `atlas_xml(arms=True)`)
on the mega path, past the first compiled width, in float32 on the CPU.

The port's forward on the mega path (`forward.forward` of float32 data on
the CPU: the plain version of the wide mega kernels' plane-only instance,
`hopper_mega.mega_forward_plain`, i.e. the staged collision and the fused
kernel's plain version with the plan's blocked facet rows and 5-float
contact pack) and its `step_n` (`mega_step_n_plain`: H1 Euler, Atlas RK4)
on the small arms variants (H1's whole tree with the small geoms: nv 25;
Atlas's small legs with the back chain and the arms: nv 27), 8 envs of
`biped_states` (env 0's heel discs upright on the floor, env 1's on their
rim), against the JAX package's float32 forward and step on the same
states, its XLA path (ops/*.py, the numerical reference of the port,
ROADMAP): its forward compiled once (jit of the vmapped forward), its
step (`_euler` or `_rk4` after the forward, as `step` runs them) over that
compiled forward, inputs canonicalised so that it compiles once
(tests/test_torch_forward.py's RK4 reference; one jit of RK4's four
forwards at nv 27 takes minutes).
Tolerances are tests/test_mega.py's: qacc, qfrc_constraint and
efc_force_contact within rel 5e-4 of the largest value; active slots
equal, geom2 exact on active slots, depths atol 1e-5; over two substeps
the increments of qpos and qvel and the carried warm start within rel
5e-4 of their largest value (as tests/test_torch_megastep.py holds them).
Both start from the port's own converged forward as their warm start, as a
stepped env does (tests/test_torch_mega.py), so that float32 Newton
termination does not part them.

The reference's Pallas kernels are not run here at this width: in
interpret mode they unroll their loops over nv and the Cholesky's over
nv^3, and one compile of its mega kernel past nv 24 takes minutes on a
CPU; tests/test_torch_cyl_mega.py holds the same plain code against them
at nv 12, and the card holds the width-32 kernels against these plain
versions (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_atlas_fixture as atfx
import test_torch_h1_fixture as h1fx
from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import forward as fwd
from loco_mujoco_tpu_torch.ops import hopper_mega as hm
from test_torch_affine import _canon

E, N = 8, 2
FIXTURES = {"h1arms": h1fx, "atlasarms": atfx}


@pytest.fixture(scope="module", params=list(FIXTURES))
def outputs(request):
    """(name, port model, port start data, JAX forward, port forward, JAX
    step, port step) of the small arms variant."""
    fx = FIXTURES[request.param]
    _, tm = fx.torch_model(full=False, dtype=torch.float32, arms=True)
    qpos, qvel, ctrl = (np.asarray(x, np.float32)
                        for x in h1fx.biped_states(tm, E))
    t = torch.as_tensor
    td = tio.make_data(tm, E).replace(qpos=t(qpos), qvel=t(qvel),
                                      ctrl=t(ctrl))
    td = td.replace(qacc_warmstart=fwd.forward(tm, td).qacc)
    with jax.enable_x64(False):
        jm = fx.jax_model(False, dtype=jnp.float32, arms=True)
        d0 = jax_make_data(jm)
        jd = jax.vmap(lambda q, v, u, w: d0.replace(
            qpos=q, qvel=v, ctrl=u, qacc_warmstart=w))(
                qpos, qvel, ctrl, td.qacc_warmstart.numpy())

        forward0 = jfwd.forward
        jforward = jax.jit(jax.vmap(lambda d: forward0(jm, d)))
        ref = jforward(jd)
        ref_step = jd
        if tm.opt.integrator == 1:  # RK4: its stages' forwards compiled
            mp = pytest.MonkeyPatch()
            mp.setattr(jfwd, "forward",
                       lambda m, x: jforward(_canon(jd, x)))
            try:
                for _ in range(N):
                    ref_step = jfwd._rk4(jm, jforward(_canon(jd, ref_step)))
            finally:
                mp.undo()
        else:
            euler = jax.jit(jax.vmap(lambda d: jfwd._euler(jm, d)))
            for _ in range(N):
                ref_step = euler(jforward(_canon(jd, ref_step)))
        ref, ref_step = (jax.tree_util.tree_map(np.asarray, x)
                         for x in (ref, ref_step))
    return (request.param, tm, td, ref, fwd.forward(tm, td), ref_step,
            fwd.step_n(tm, td, N))


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def test_arms_take_the_wide_plane_only_path(outputs):
    """The small arms variants are planned at width 32 on the plane-only
    instance (their float32 forward and step_n on the CPU are that
    instance's plain versions), with a megastep (H1 Euler with euler_dv,
    Atlas RK4), and every group is in contact somewhere."""
    name, tm, _, _, got, _, step = outputs
    plan = tm.plan
    assert tm.nv > 24 and plan.nvm == 32
    assert plan.mega and not plan.mega_ell and hm.ext_mode(plan) == 0
    assert hm.forwards_per_step(tm) == (1 if name == "h1arms" else 4)
    assert step is not None
    active = (got.contact.dist < got.contact.includemargin).numpy()
    for g in tm.groups:
        assert active[:, g.offset:g.offset + g.k * g.slots].any(), g[:3]


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact"])
def test_arms_mega_forward_matches_jax(outputs, field):
    _, tm, _, ref, got, _, _ = outputs
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field == "efc_force_contact":
        w = min(g.shape[-1], r.shape[-1])
        assert not g[..., w:].any() and not r[..., w:].any()
        g, r = g[..., :w], r[..., :w]
    assert rel_err(g, r) < 5e-4


def test_arms_mega_contacts_match_jax(outputs):
    _, tm, _, ref, got, _, _ = outputs
    active = ref.contact.dist < ref.contact.includemargin
    np.testing.assert_array_equal(
        (got.contact.dist < got.contact.includemargin).numpy(), active)
    np.testing.assert_array_equal(got.contact.geom2.numpy()[active],
                                  ref.contact.geom2[active])
    err = np.abs(got.contact.dist.numpy() - ref.contact.dist)[active].max()
    assert err <= 1e-5


@pytest.mark.parametrize("field", ["qpos", "qvel", "qacc_warmstart"])
def test_arms_step_n_matches_jax(outputs, field):
    _, tm, td, _, _, ref, got = outputs
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field != "qacc_warmstart":  # both started from td's float32 state
        start = getattr(td, field).numpy()
        g, r = g - start, r - start
    assert rel_err(g, r) < 5e-4
    np.testing.assert_allclose(got.time.numpy(),
                               td.time.numpy() + N * float(tm.opt.timestep),
                               rtol=1e-6)
