"""The port's env layer (`envs/base.LocoEnv`) against the JAX package's
`LocoEnv`, in float64 on the CPU.

Both envs are built from one compile of the small HumanoidTorque-shaped
fixture (RK4; the A1-shaped fixture's, Euler, in tests/test_torch_env_a1.py,
its position variant's in tests/test_torch_env_a1pos.py, the G1-shaped
fixture's, Euler, in tests/test_torch_env_g1.py, and the Talos-shaped
fixture's, Euler, in tests/test_torch_talos_env.py) from
`standins.env_parts`, what the card's env phase runs: the same
observation spec (every joint's position, then every joint's velocity; the
first two, the root's horizontal slides, dropped), the same synthetic
trajectory (seeded numpy sinusoids within the joint ranges, resampled from
its own dt to the control dt by both packages' cubic interpolation), the
target-velocity reward and the robots' fall predicates (the humanoid's
with the stand-in's root joints in the pelvis roles and, as the small
fixture has no abdomen, in the lumbar roles too). `init_step_no` makes
every reset deterministic and the horizon of 2 control steps makes the
auto-reset fire at the second step; the action stream is seeded numpy.
Over 3 control steps of 4 envs the obs, reward, absorbing and done
streams and the carried state (qpos, qvel) agree: float values within rel
1e-6 of their largest, the booleans exactly (float64 data: both take the
staged path, no kernel plan).

The JAX reset and step are compiled once (jit of the batched `reset` and
of the vmapped `step`); its float64 forward is the XLA path.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.datasets.trajectory import TrajectoryData as JTraj
from loco_mujoco_tpu.envs.base import LocoEnv as JEnv
from loco_mujoco_tpu.envs.observation import ObsIndex as JObs
from loco_mujoco_tpu.rewards.rewards import make_reward as jmake_reward
from loco_mujoco_tpu_torch.rewards.rewards import make_reward
import test_torch_a1_fixture as a1fx
import test_torch_fixture as hfx
import test_torch_g1_fixture as g1fx
import test_torch_h1_fixture as h1fx
import test_torch_talos_fixture as talosfx
from loco_mujoco_tpu.models.humanoids.talos import \
    _has_fallen_fn as talos_has_fallen_fn
from loco_mujoco_tpu.models.humanoids.unitree_g1 import \
    _has_fallen_fn as g1_has_fallen_fn
from loco_mujoco_tpu.models.humanoids.unitree_h1 import \
    _has_fallen_fn as h1_has_fallen_fn
from loco_mujoco_tpu_torch.core import io
from loco_mujoco_tpu_torch.envs import standins
from test_torch_fixture import ASSET

E, STEPS, HORIZON, SUBSTEPS = 4, 3, 2, 2


def build(robot, **budget):
    """(JAX env, port env) from `standins.env_parts` of the fixture;
    `budget` the envs' solver_iterations / ls_iterations."""
    fixture = {"humanoid": hfx, "a1": a1fx, "a1pos": a1fx, "g1": g1fx,
               "g1arms": g1fx, "h1arms": h1fx, "talos": talosfx}[robot]
    kw = ({"mode": "position"} if robot == "a1pos"
          else {"arms": True} if robot in ("g1arms", "h1arms") else {})
    jm, tm = fixture.torch_model(full=False, **kw)
    parts = standins.env_parts(tm, SUBSTEPS)
    idx = parts["fall"]
    if robot in ("g1", "g1arms", "h1arms", "talos"):
        # models/humanoids/unitree_g1.py:43-54, unitree_h1.py:44-54,
        # talos.py:47-66
        keys = [k for k, _, _ in parts["spec"]]
        j_fall = {"h1arms": h1_has_fallen_fn, "talos": talos_has_fallen_fn}.get(
            robot, g1_has_fallen_fn)({k: i - 2 for i, k in enumerate(keys)})
    elif robot == "humanoid":
        def j_fall(obs):  # models/humanoids/humanoid.py:196-205
            pi = jnp.pi
            o = [obs[i] for i in idx]
            return ((o[0] < -0.46) | (o[0] > 0.1) | (o[1] < -pi / 4.5)
                    | (o[1] > pi / 12) | (o[2] < -pi / 12) | (o[2] > pi / 8)
                    | (o[3] < -pi / 9) | (o[3] > pi / 9) | (o[4] < -pi / 4)
                    | (o[4] > pi / 10) | (o[5] < -pi / 10) | (o[5] > pi / 10)
                    | (o[6] < -pi / 4.5) | (o[6] > pi / 4.5))
    else:
        def j_fall(obs):  # models/quadrupeds/unitree_a1.py:134-138
            return ((obs[1] < -0.2793) | (obs[1] > 0.2793)
                    | (obs[2] < -0.192) | (obs[2] > 0.192) | (obs[0] < -0.24))
    kw = dict(horizon=HORIZON, n_substeps=SUBSTEPS, random_start=False,
              init_step_no=7, **budget)
    jenv = JEnv(jm, JObs(jm, parts["spec"]),
                reward_fn=jmake_reward(
                    "target_velocity",
                    {"target_velocity": standins.TARGET_VELOCITY},
                    {"x_vel_idx": parts["x_vel"]}),
                traj_data=JTraj(dtype=jnp.float64, **parts["traj"]),
                has_fallen=j_fall, dtype=jnp.float64, **kw)
    return jenv, standins.make_env(tm, **kw)


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def run_streams(robot):
    """(JAX env, port env, [(JAX state, port state)] at the reset and after
    each control step)."""
    jenv, tenv = build(robot)
    acts = np.random.default_rng(5).uniform(-0.3, 0.3,
                                            size=(STEPS, E, tenv.action_dim))
    js = jax.jit(lambda k: jenv.reset_batch(k, E))(jax.random.PRNGKey(0))
    ts = tenv.reset_batch(E, torch.Generator().manual_seed(0))
    out = [(js, ts)]
    jstep = jax.jit(jax.vmap(jenv.step))
    for a in acts:
        js = jstep(js, jnp.asarray(a))
        ts = tenv.step_batch(ts, torch.as_tensor(a))
        out.append((js, ts))
    return jenv, tenv, out


@pytest.fixture(scope="module")
def streams():
    return run_streams("humanoid")


def test_trajectory_matches_jax(streams):
    jenv, tenv, _ = streams
    assert tenv.traj.keys == jenv.traj.keys
    assert tenv.traj.flat.shape == jenv.traj.flat.shape
    assert rel_err(tenv.traj.flat.numpy(), jenv.traj.flat) < 1e-9


def test_env_layout_matches_jax(streams):
    jenv, tenv, _ = streams
    assert tenv.obs_dim == jenv.obs_dim and tenv.action_dim == jenv.action_dim
    np.testing.assert_array_equal(tenv.norm_act_mean.numpy(),
                                  np.asarray(jenv.norm_act_mean))
    np.testing.assert_array_equal(tenv.norm_act_delta.numpy(),
                                  np.asarray(jenv.norm_act_delta))
    assert tenv.obs_index.obs_idx_map == jenv.obs_index.obs_idx_map


@pytest.mark.parametrize("field", ["obs", "reward", "qpos", "qvel"])
def test_float_streams_match(streams, field):
    _, _, out = streams
    for k, (js, ts) in enumerate(out):
        if field in ("qpos", "qvel"):
            g, r = getattr(ts.data, field), getattr(js.data, field)
        else:
            g, r = getattr(ts, field), getattr(js, field)
        if field == "reward" and k == 0:
            continue  # zeros at reset
        assert rel_err(g.numpy(), r) < 1e-6, (field, k)


@pytest.mark.parametrize("field", ["absorbing", "done", "step_no",
                                   "traj_no", "subtraj_step"])
def test_discrete_streams_match(streams, field):
    _, _, out = streams
    for js, ts in out:
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)))


def test_auto_reset_fired(streams):
    """The horizon ends every episode at the second step: the merge puts
    the episode start back (step_no 0, the reset's state)."""
    _, _, out = streams
    (_, t0), (_, t2) = out[0], out[HORIZON]
    assert bool(t2.done.all())
    np.testing.assert_array_equal(t2.step_no.numpy(), 0)
    np.testing.assert_array_equal(t2.data.qpos.numpy(), t0.data.qpos.numpy())
    np.testing.assert_array_equal(t2.obs.numpy(), t0.obs.numpy())


def test_solver_budget_cut_as_jax():
    """The env cuts the model's Newton and line-search budgets to its own
    (base.py:98-109), as the JAX env does: in the options and in the row
    plan (with the damping rows' variant too); the model given is left as
    it is, and a step runs at the cut budget."""
    jenv, tenv = build("humanoid", solver_iterations=2, ls_iterations=1)
    jm, m = jenv.model, tenv.model
    assert (m.opt.iterations, m.opt.ls_iterations) == (
        jm.opt.iterations, jm.opt.ls_iterations) == (2, 1)
    assert (m.plan.iterations, m.plan.ls_iterations) == (2, 1)
    # a budget above the model's leaves it
    _, same = build("humanoid", solver_iterations=99, ls_iterations=99)
    full = same.model
    assert full.opt.iterations > 2 and full.plan is full.plan.with_budget(
        full.opt.iterations, full.opt.ls_iterations)
    assert full.plan.iterations == full.opt.iterations
    # the float32 stand-in on its plan's path, with per-env damping
    tm = io.load_model_npz(ASSET, device="cpu")
    env = standins.make_env(tm, dr=standins.damping_dr(tm), n_substeps=1,
                            solver_iterations=2, ls_iterations=1)
    assert tm.plan.iterations == tm.opt.iterations > 2
    dyn = env.model_dr.plan
    assert dyn.sm_dyn_damping and (dyn.iterations, dyn.ls_iterations) == (
        2, 1)
    st = env.step_batch(env.reset_batch(2, torch.Generator().manual_seed(0)),
                        torch.zeros((2, env.action_dim)))
    assert int(st.data.solver_niter.max()) <= 2


@pytest.mark.parametrize("kind, params", [
    ("no_reward", {}), ("x_pos", {}), ("x_vel", {"pos_idx": 3}),
    ("target_velocity", {"target_velocity": 1.25}),
    ("multi_target_velocity", {"target_velocities": [0.5, 1.0, 1.5]}),
    ("velocity_vector", {}),
    ("custom", {"reward_callback": "sum"}),
])
def test_rewards_match_jax(kind, params):
    """Every reward of `make_reward` on the same seeded batch (the JAX one
    vmapped per env), rel 1e-12 in float64."""
    rng = np.random.default_rng(9)
    E_, D = 6, 8
    s, ns = rng.normal(size=(E_, D)), rng.normal(size=(E_, D))
    a = rng.normal(size=(E_, 3))
    info = {"goal_angle": rng.uniform(-3, 3, E_),
            "goal_vel": rng.uniform(0, 2, E_),
            "env_id": rng.integers(0, 3, E_)}
    defaults = {"x_pos_idx": 0, "x_vel_idx": 2, "y_vel_idx": 5}
    jparams, tparams = dict(params), dict(params)
    if kind == "custom":
        jparams["reward_callback"] = lambda s_, a_, ns_: jnp.sum(ns_ * s_)
        tparams["reward_callback"] = lambda s_, a_, ns_: (ns_ * s_).sum(1)
    jfn = jmake_reward(kind, jparams, defaults)
    tfn = make_reward(kind, tparams, defaults)
    ref = jax.vmap(jfn)(s, a, ns, {k: jnp.asarray(v) for k, v in
                                   info.items()})
    t = torch.as_tensor
    got = tfn(t(s), t(a), t(ns), {k: t(v) for k, v in info.items()})
    assert got.shape == (E_,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-15)


def test_math_matches_jax():
    """utils/math: the numpy helpers are the JAX package's; the torch
    ones match its jax ones on a seeded batch."""
    from loco_mujoco_tpu.utils import math as jmath
    from loco_mujoco_tpu_torch.utils import math as tmath

    rng = np.random.default_rng(2)
    eul = rng.uniform(-1, 1, size=3)
    np.testing.assert_array_equal(tmath.euler_to_mat(eul),
                                  jmath.euler_to_mat(eul))
    np.testing.assert_array_equal(tmath.mat_to_euler(tmath.euler_to_mat(eul)),
                                  jmath.mat_to_euler(jmath.euler_to_mat(eul)))
    mats = np.stack([jmath.euler_to_mat(e) for e in rng.uniform(
        -3, 3, size=(5, 3))]).reshape(5, 9)
    np.testing.assert_allclose(
        tmath.mat2angle_xy_torch(torch.as_tensor(mats)).numpy(),
        np.asarray(jmath.mat2angle_xy_jax(jnp.asarray(mats))), rtol=1e-12)
    st = rng.normal(size=(5, 6))
    ang = rng.uniform(-3, 3, size=5)
    ref = jax.vmap(lambda x, g: jmath.rotate_obs(x, g, 1, 3, 4))(
        jnp.asarray(st), jnp.asarray(ang))
    got = tmath.rotate_obs(torch.as_tensor(st), torch.as_tensor(ang), 1, 3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
