"""G1 with its arms (`test_torch_g1_fixture.g1_xml(arms=True)`) on the
mega path, past the first compiled width, in float32 on the CPU.

The port's forward on the mega path (`forward.forward` of float32 data on
the CPU: the plain version of the wide mega kernel's extended pyramidal
instance, `hopper_mega.mega_forward_plain`, i.e. the staged collision and
the fused kernel's plain version `hopper_fused.fused_constraint_plain`
with the plan's blocked facet rows and 26-float contact pack) on the small
arms variant (the small legs and the 10 arm hinges: nv 25, past 24), 8
envs of `g1_states`, against the JAX package's float32 forward on the
same states, its XLA path (ops/*.py, the numerical reference of the port,
ROADMAP). Tolerances are tests/test_mega.py's: qacc, qfrc_constraint and
efc_force_contact within rel 5e-4 of the largest value; active slots
equal, geom1 and geom2 exact on active slots, depths atol 1e-5. Both
forwards warm-start from the port's own converged forward, as a stepped
env does (tests/test_torch_mega.py), so that float32 Newton termination
does not part them.

The reference's Pallas kernels are not run here at this width: in
interpret mode they unroll their loops over nv and the Cholesky's over
nv^3, and one compile of its mega kernel at nv 25 takes minutes on a CPU,
past the test suite's time budget; tests/test_torch_g1_mega.py,
tests/test_torch_g1_megastep.py and tests/test_torch_g1_fused.py hold the
same plain code against them at nv 15, and the card holds the width-32
kernels against these plain versions (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_g1_fixture as g1_fix
from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import forward as fwd
from loco_mujoco_tpu_torch.ops import hopper_mega as hm

E = 8


@pytest.fixture(scope="module")
def outputs():
    _, tm = g1_fix.torch_model(full=False, dtype=torch.float32, arms=True)
    qpos, qvel, ctrl = (np.asarray(x, np.float32)
                        for x in g1_fix.g1_states(tm, E))
    t = torch.as_tensor
    td = tio.make_data(tm, E).replace(qpos=t(qpos), qvel=t(qvel),
                                      ctrl=t(ctrl))
    td = td.replace(qacc_warmstart=fwd.forward(tm, td).qacc)
    with jax.enable_x64(False):
        jm = g1_fix.jax_model(False, dtype=jnp.float32, arms=True)
        d0 = jax_make_data(jm)
        jd = jax.vmap(lambda q, v, u, w: d0.replace(
            qpos=q, qvel=v, ctrl=u, qacc_warmstart=w))(
                qpos, qvel, ctrl, td.qacc_warmstart.numpy())
        ref = jax.jit(jax.vmap(lambda d: jfwd.forward(jm, d)))(jd)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    return tm, ref, fwd.forward(tm, td)


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def test_g1arms_takes_the_wide_ext_pyramidal_path(outputs):
    """The small arms variant is planned at width 32 on the extended
    pyramidal instance (its float32 forward on the CPU is that kernel's
    plain version), and every group is in contact somewhere."""
    tm, ref, got = outputs
    plan = tm.plan
    assert tm.nv == 25 and plan.nvm == 32
    assert plan.mega and plan.mega_ell and not plan.elliptic
    assert hm.ext_mode(plan) == 2 and plan.euler_dv
    active = (got.contact.dist < got.contact.includemargin).numpy()
    for g in tm.groups:
        assert active[:, g.offset:g.offset + g.k * g.slots].any(), g[:3]


@pytest.mark.parametrize("field", ["qacc", "qfrc_constraint",
                                   "efc_force_contact"])
def test_g1arms_mega_forward_matches_jax(outputs, field):
    tm, ref, got = outputs
    g, r = getattr(got, field).numpy(), getattr(ref, field)
    if field == "efc_force_contact":
        w = min(g.shape[-1], r.shape[-1])
        assert not g[..., w:].any() and not r[..., w:].any()
        g, r = g[..., :w], r[..., :w]
    assert rel_err(g, r) < 5e-4


def test_g1arms_mega_contacts_match_jax(outputs):
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
