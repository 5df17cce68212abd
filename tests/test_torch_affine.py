"""Affine gain and bias, integrator and filter activations: the port's
actuation, forward, Euler and RK4 steps against the JAX package's XLA
path, in float64 on the CPU.

Two models of `test_torch_a1_fixture.a1_xml`: A1's position mode at full
width (the committed stand-in's generator: 12 position servos, fixed gain
kp, affine bias (0, -kp, -kv), targets in the joint ranges, the force
limited) and the all-terms variant of the small size (affine gain and bias
with all six prms nonzero, a filter with actlimited, a FILTEREXACT, an
integrator, a servo and an affine gain without bias: 3 activations). 4
envs seeded with numpy (`a1_states`: standing, legs touching, tipped
over), the servos' targets from `servo_targets`, the activations uniform in
[-0.5, 0.8) and env 0's filter just under its upper limit at full control,
so that its first Euler step is clamped to actrange. Float64 data gets no
plan, in the port and the reference alike, so both run every stage
(`forward_staged`; the XLA stages and steps compiled once with jit + vmap).
Tolerances (PERF.md's float64 limits): the actuation fields and qacc rel
1e-7 of their largest value, qpos / qvel / act after 5 Euler substeps and
after one RK4 step rel 1e-6.

The reference gives INTEGRATOR act_dot = 0 (MuJoCo gives ctrl) and
integrates FILTEREXACT as FILTER (`ops/actuation.py:201-208`); the port
matches it, and these tests hold it to that.
"""

import jax
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.ops import collision as jcoll
from loco_mujoco_tpu.ops import constraint as jcon
from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.ops import kinematics as jkin
from loco_mujoco_tpu.ops import solver as jsolver
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.ops import forward
from test_torch_a1_fixture import a1_states, servo_targets, torch_model
from test_torch_fixture import export_model

E, SUBSTEPS = 4, 5
FIELDS = ("actuator_length", "actuator_velocity", "actuator_force",
          "act_dot", "qfrc_actuator")
FILTER_U = 1  # the all-terms variant's actlimited filter (FL thigh)
STATE = ("qpos", "qvel", "act", "ctrl", "qacc_warmstart", "time")


def _forward(jm, d):
    d = jfwd.fwd_position(jm, d)
    d = jfwd.fwd_acceleration(jm, jfwd.fwd_actuation(
        jm, jfwd.fwd_velocity(jm, d)))
    return jsolver.solve(jm, d, jcon.make_constraint(jm, d))


def _canon(template, d):
    """`template` (the collision pass's data) with d's state: every input
    of the compiled forward in one pytree and dtype, so that it compiles
    once."""
    return template.replace(**{f: getattr(d, f).astype(getattr(
        template, f).dtype) for f in STATE})


def _rk4_models(jm):
    """(JAX model, port model) with RK4 in place of Euler."""
    jr = jm.replace(opt=jm.opt.replace(integrator=1))
    leaves, aux = export_model(jr)
    return jr, tio.model_from_numpy(leaves, aux, device="cpu",
                                    dtype=torch.float64)


@pytest.fixture(scope="module", params=["position", "all_terms"])
def setup(request):
    mode = request.param
    jm, tm = torch_model(mode == "position", mode=mode)
    qpos, qvel, ctrl = a1_states(tm, E, seed=5)
    rng = np.random.default_rng(13)
    if mode == "position":
        ctrl = servo_targets(tm, E)
        act = np.zeros((E, 0))
    else:
        ctrl = rng.uniform(-1.0, 1.0, size=(E, tm.nu))
        act = rng.uniform(-0.5, 0.8, size=(E, tm.na))
        act[0, int(tm.actuator_actadr[FILTER_U])] = 0.799
        ctrl[0, FILTER_U] = 1.0
    d0 = jax_make_data(jm)
    # contact dims from one collision pass, as the env's reset gives them
    jd = jax.jit(jax.vmap(lambda q, v, u, a: jcoll.collision(
        jm, jkin.kinematics(jm, d0.replace(qpos=q, qvel=v, ctrl=u, act=a)))))(
        qpos, qvel, ctrl, act)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    td = tio.make_data(tm, E).replace(qpos=t(qpos), qvel=t(qvel),
                                      ctrl=t(ctrl), act=t(act))
    # the XLA forward, compiled once (jit, batched by vmap) and shared by
    # the Euler steps and the RK4 stages
    return mode, jm, tm, jd, td, jax.jit(lambda d: _forward(jm, d))


def rel_err(got, ref):
    """max |got - ref| over max |ref|; 0 for two empty arrays of one shape
    (act and act_dot without activations)."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if not ref.size:
        return 0.0
    return np.abs(got.numpy() - ref).max() / (np.abs(ref).max() + 1e-30)


@pytest.fixture(scope="module")
def forwards(setup):
    mode, jm, tm, jd, td, jforward = setup
    assert forward.mega_enabled(tm, td) is None  # float64: no plan
    return jax.vmap(jforward)(jd), forward.forward(tm, td)


def test_models_carry_the_terms(setup):
    """The position servos are fixed gain and affine bias; the all-terms
    variant has every admitted gain, bias and activation kind, and its
    float32 plan is non-smooth with no mega path (the reference's gate)."""
    mode, jm, tm, jd, td, _ = setup
    if mode == "position":
        assert set(tm.actuator_gaintype) == {0} and set(
            tm.actuator_biastype) == {1} and tm.na == 0
        np.testing.assert_array_equal(tm.actuator_ctrlrange.numpy(),
                                      np.asarray(jm.actuator_ctrlrange))
        return
    assert set(tm.actuator_gaintype) == {0, 1}
    assert set(tm.actuator_biastype) == {0, 1}
    assert set(tm.actuator_dyntype) == {0, 1, 2, 3} and tm.na == 3
    assert (tm.actuator_gainprm[0, :3] != 0).all()
    assert (tm.actuator_biasprm[0, :3] != 0).all()
    plan = tm.to(dtype=torch.float32).plan
    assert plan is not None and not plan.smooth and not plan.mega


@pytest.mark.parametrize("field", FIELDS)
def test_actuation_matches_xla(setup, forwards, field):
    ref, got = forwards
    assert rel_err(getattr(got, field), getattr(ref, field)) < 1e-7


def test_forward_qacc_matches_xla(setup, forwards):
    ref, got = forwards
    active = (got.efc_force_contact != 0).any(dim=-1)
    assert int(active.sum()) > E, "too few active contact slots"
    assert rel_err(got.qacc, ref.qacc) < 1e-7


@pytest.fixture(scope="module")
def euler_runs(setup):
    """5 Euler substeps of both (the reference's `_euler` after its
    forward); whether the first clamped env 0's filter."""
    mode, jm, tm, jd, td, jforward = setup
    euler = jax.jit(jax.vmap(lambda d: jfwd._euler(jm, d)))
    clamped = None
    template = jd
    for i in range(SUBSTEPS):
        jd = euler(jax.vmap(jforward)(_canon(template, jd)))
        td = forward.step(tm, td)
        if i == 0 and tm.na:
            adr = int(tm.actuator_actadr[FILTER_U])
            clamped = float(td.act[0, adr]) == float(
                tm.actuator_actrange[FILTER_U, 1])
    return jd, td, clamped


@pytest.mark.parametrize("field", ["qpos", "qvel", "act"])
def test_euler_substeps_match_xla(setup, euler_runs, field):
    jd, td, clamped = euler_runs
    assert clamped in ((True,) if setup[2].na else (None,))
    assert rel_err(getattr(td, field), getattr(jd, field)) < 1e-6
    np.testing.assert_allclose(td.time.numpy(), np.asarray(jd.time),
                               rtol=1e-12)


@pytest.fixture(scope="module")
def rk4_runs(setup, monkeypatch_module):
    """One RK4 step of both models with RK4 in place of Euler: the
    reference's `_rk4` (its tableau, act and warm start) over its compiled
    forward, which reads no integrator; with activations `step_n` has no
    megastep (it returns None)."""
    mode, jm, tm, jd, td, jforward = setup
    jr, tr = _rk4_models(jm)

    def rk4(d):
        monkeypatch_module.setattr(
            jfwd, "forward", lambda m, x: jforward(_canon(d, x)))
        return jfwd._rk4(jr, jforward(d))

    ref = jax.vmap(rk4)(jd)
    monkeypatch_module.undo()
    assert tr.na == 0 or forward.step_n(tr.to(dtype=torch.float32),
                                        td.to(dtype=torch.float32), 1) is None
    return ref, forward.step(tr, td), tr


@pytest.mark.parametrize("field", ["qpos", "qvel", "act"])
def test_rk4_step_matches_xla(setup, rk4_runs, field):
    ref, got, tr = rk4_runs
    assert rel_err(getattr(got, field), getattr(ref, field)) < 1e-6


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_nonsmooth_vec_takes_the_filter_models_qfrc_smooth(setup, forwards):
    """With activations the float32 plan is non-smooth: the staged path's
    stages (torch actuation with the filters) hand qfrc_smooth to the fused
    kernel's non-smooth layout unchanged (`hopper_fused.nonsmooth_vec`),
    and the float32 staged forward's qacc_smooth lies within rel 1e-4 of
    the XLA path's float64 one."""
    from loco_mujoco_tpu_torch.ops import hopper_fused as hf

    mode, jm, tm, jd, td, _ = setup
    if not tm.na:
        assert tm.to(dtype=torch.float32).plan.smooth
        return
    m32, d32 = tm.to(dtype=torch.float32), td.to(dtype=torch.float32)
    st = forward.stages(m32, d32)
    vec = hf.nonsmooth_vec(m32, st)
    nv, nb = m32.nv, m32.nbody
    lo = 2 * nv + 6 * nv + 3 + 10 * nb
    assert torch.equal(vec[:, lo:lo + nv], st.qfrc_smooth)
    ref, _ = forwards
    got = forward.forward(m32, d32).qacc_smooth.double()
    assert rel_err(got, ref.qacc_smooth) < 1e-4
