"""Stacked model variants of the port (`io.stack_variants`, the env's
`model_variants`) against the JAX package's, in float64 on the CPU, with
the other sections of domain randomization on top.

The small torque fixture at two 4-ages scalings, 0.6 and 1.0
(`test_torch_fixture.jax_model(scaling=...)`, the law of the JAX package's
`_scale_spec`), both compiled by the JAX package's `put_model`:

1. Stacking: the port's stacked leaves equal, exactly, the JAX env's
   stacked `variants` leaves, and both name the same set of leaves that
   differ; every variant takes the base's Newton budget and
   stat_meaninertia; the stack has no row plan (the invweights vary: the
   reference's plan refuses traced row leaves) and one hull table per
   variant in its plane-mesh kernel plan; a varying leaf that no stage
   reads per env, or models of two structures, raise.
2. The env: the port's `LocoEnv(model_variants=[s0.6, s1.0])` and the
   JAX `LocoEnv(model_variants=...)`, both with a randomization of
   Inertial (every body's mass, diaginertia, fullinertia by the SVD rule),
   Geoms friction and Joints armature and stiffness (`ENV_CONF`), 4 envs,
   3 control steps of 2 substeps, the same seeded actions; each env's
   variant and draws are set on both states after the reset (envs 0 and 3
   the child, 1 and 2 the adult; the JAX state's samples, the port's
   per-env leaves from them on each env's variant), and the horizon of 3
   makes the last step's auto-reset draw a variant and draws of its own
   on each side, the variant held only to its support. obs, reward, qpos
   and qvel within rel 1e-6 of their largest (tests/test_torch_env.py's
   tolerance), the booleans and counters exactly. One JAX env serves both
   the variants and the randomization: its compile is the file's cost.
3. One staged forward per env, on the per-env Model (`LocoEnv._apply_dr`:
   `io.model_at` and the randomized leaves) at the second step's state,
   against the JAX forward of `_apply_dr(_model_at(env_id), dr)` (vmapped,
   jitted once): rel 1e-9 of the largest value of qacc, qacc_smooth,
   qfrc_constraint, the body frames, cinert, qM and the contact depths.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.core.io import make_data as jax_make_data
from loco_mujoco_tpu.datasets.trajectory import TrajectoryData as JTraj
from loco_mujoco_tpu.envs.base import LocoEnv as JEnv
from loco_mujoco_tpu.envs.observation import ObsIndex as JObs
from loco_mujoco_tpu.ops import forward as jfwd
from loco_mujoco_tpu.rewards.rewards import make_reward as jmake_reward
from loco_mujoco_tpu_torch.core import io
from loco_mujoco_tpu_torch.envs import standins
from loco_mujoco_tpu_torch.ops import forward as fwd
from test_torch_env import rel_err
from test_torch_fixture import export_model, jax_model

E, STEPS, HORIZON, SUBSTEPS = 4, 3, 3, 2
SCALINGS = (0.6, 1.0)
ENV_IDS = np.array([0, 1, 1, 0], np.int32)
# the envs' randomization on the small humanoid: Inertial, Geoms friction
# and Joints armature and stiffness
ENV_CONF = {
    "Default": {"Inertial": {"mass": {"uniform_range_delta": 0.3}}},
    "Inertial": {"shin_r": {"diaginertia": {"uniform_range_delta": 0.0005}},
                 "thigh_l": {"fullinertia": {"uniform_range_delta": 0.001}}},
    "Geoms": {"shin_r": {"friction": {"uniform_range": [0.6, 1.4]}},
              "shin_l": {"friction": {"sigma": 0.2}}},
    "Joints": {"knee_r": {"armature": {"uniform_range": [0.01, 0.05]},
                          "stiffness": {"uniform_range": [0.5, 3.0]}},
               "hip_y_l": {"stiffness": {"sigma": 1.0}}},
}


def draws(h, seed, n=E):
    """Draws of every entry of handler `h`'s sample, (n, ...) float64,
    numpy."""
    s = h.sample(torch.Generator().manual_seed(seed), n, dtype=torch.float64)
    return {k: ([x.numpy() for x in v] if isinstance(v, list)
                else v.numpy()) for k, v in s.items()}


def as_torch(d):
    return {k: ([torch.as_tensor(x) for x in v] if isinstance(v, list)
                else torch.as_tensor(v)) for k, v in d.items()}


def as_jax(d):
    return {k: ([jnp.asarray(x) for x in v] if isinstance(v, list)
                else jnp.asarray(v)) for k, v in d.items()}


def variant_pairs():
    """[(JAX model, port model)] of the small fixture at SCALINGS."""
    out = []
    for s in SCALINGS:
        jm = jax_model(full=False, scaling=s)
        leaves, aux = export_model(jm)
        out.append((jm, io.model_from_numpy(leaves, aux, device="cpu",
                                            dtype=torch.float64)))
    return out


def j_fall(idx):
    """The humanoid's fall predicate on one env's obs
    (models/humanoids/humanoid.py:196-205)."""
    def fall(obs):
        pi = jnp.pi
        o = [obs[i] for i in idx]
        return ((o[0] < -0.46) | (o[0] > 0.1) | (o[1] < -pi / 4.5)
                | (o[1] > pi / 12) | (o[2] < -pi / 12) | (o[2] > pi / 8)
                | (o[3] < -pi / 9) | (o[3] > pi / 9) | (o[4] < -pi / 4)
                | (o[4] > pi / 10) | (o[5] < -pi / 10) | (o[5] > pi / 10)
                | (o[6] < -pi / 4.5) | (o[6] > pi / 4.5))
    return fall


def build_envs(pairs, dr=None):
    """(JAX env, port env) over the variants `pairs`, the first the base
    (a single pair: no variants), with the randomization `dr` where
    given."""
    jm0, tm0 = pairs[0]
    parts = standins.env_parts(tm0, SUBSTEPS)
    opts = dict(horizon=HORIZON, n_substeps=SUBSTEPS, random_start=False,
                init_step_no=7)
    kw = {}
    if dr is not None:
        import yaml

        with tempfile.NamedTemporaryFile("w", suffix=".yaml",
                                         delete=False) as f:
            yaml.safe_dump(dr, f)
        kw["domain_randomization_config"] = f.name
    variants = [jm for jm, _ in pairs] if len(pairs) > 1 else None
    jenv = JEnv(jm0, JObs(jm0, parts["spec"]),
                reward_fn=jmake_reward(
                    "target_velocity",
                    {"target_velocity": standins.TARGET_VELOCITY},
                    {"x_vel_idx": parts["x_vel"]}),
                traj_data=JTraj(dtype=jnp.float64, **parts["traj"]),
                has_fallen=j_fall(parts["fall"]), dtype=jnp.float64,
                model_variants=variants, **opts, **kw)
    tenv = standins.make_env(
        tm0, dr=dr, model_variants=variants and [tm for _, tm in pairs],
        **opts)
    return jenv, tenv


def set_draws(jenv, tenv, seed=11):
    """A `run` hook: the same randomization draws on both states (the JAX
    state's samples; the port's per-env leaves from them, each on its
    env's variant)."""
    d = draws(tenv.domain_rand, seed)

    def hook(js, ts):
        leaves = tenv.domain_rand.apply(tenv._model_at(ts.env_id),
                                        as_torch(d))
        return js.replace(dr=as_jax(d)), ts.replace(dr=leaves)

    return hook


def run(jenv, tenv, set_state=None):
    """[(JAX state, port state)] at the reset (after `set_state(js, ts)`
    where given) and after each of STEPS control steps."""
    acts = np.random.default_rng(5).uniform(-0.3, 0.3,
                                            size=(STEPS, E, tenv.action_dim))
    js = jax.jit(lambda k: jenv.reset_batch(k, E))(jax.random.PRNGKey(0))
    ts = tenv.reset_batch(E, torch.Generator().manual_seed(0))
    # in the reset's dtype, so that the step compiles once
    js = js.replace(env_id=jnp.asarray(ENV_IDS, js.env_id.dtype))
    ts = ts.replace(env_id=torch.as_tensor(ENV_IDS))
    if set_state is not None:
        js, ts = set_state(js, ts)
    out = [(js, ts)]
    jstep = jax.jit(jax.vmap(jenv.step))
    for a in acts:
        js = jstep(js, jnp.asarray(a))
        ts = tenv.step_batch(ts, torch.as_tensor(a))
        out.append((js, ts))
    return out


def check_streams(out, n_variants):
    """The float streams within rel 1e-6 of their largest, the booleans
    and counters exactly; the last auto-reset's variant in its support."""
    for k, (js, ts) in enumerate(out):
        for field in ("obs", "reward", "qpos", "qvel"):
            if field == "reward" and k == 0:
                continue  # zeros at reset
            g = getattr(ts.data if field[0] == "q" else ts, field)
            r = getattr(js.data if field[0] == "q" else js, field)
            assert rel_err(g.numpy(), r) < 1e-6, (field, k)
        for field in ("absorbing", "done", "step_no", "traj_no",
                      "subtraj_step"):
            np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                          np.asarray(getattr(js, field)),
                                          err_msg=f"{field} {k}")
        env_id = ts.env_id.numpy()
        if k < HORIZON:
            np.testing.assert_array_equal(env_id, ENV_IDS)
            np.testing.assert_array_equal(np.asarray(js.env_id), ENV_IDS)
        else:  # each side's own auto-reset draw
            assert bool(ts.done.all())
            assert env_id.min() >= 0 and env_id.max() < n_variants


@pytest.fixture(scope="module")
def pairs():
    return variant_pairs()


@pytest.fixture(scope="module")
def envs(pairs):
    return build_envs(pairs, ENV_CONF)


@pytest.fixture(scope="module")
def streams(envs):
    return run(*envs, set_draws(*envs))


def test_stacked_leaves_equal_jax(pairs, envs):
    jenv, tenv = envs
    stacked, varied = io.stack_variants([tm for _, tm in pairs])
    leaves, _ = io.model_field_names()
    jvar = jenv.variants
    ref_varied = set()
    for n in leaves:
        ref = np.asarray(getattr(jvar.opt, n[4:]) if n.startswith("opt.")
                         else getattr(jvar, n))
        if not all(np.array_equal(ref[0], r) for r in ref[1:]):
            ref_varied.add(n)
        got = (getattr(stacked.opt, n[4:]) if n.startswith("opt.")
               else getattr(stacked, n)).numpy()
        np.testing.assert_array_equal(got if n in varied else got[None]
                                      .repeat(len(SCALINGS), 0), ref,
                                      err_msg=n)
    assert varied == ref_varied
    assert {"body_pos", "body_mass", "mesh_vert", "dof_invweight0",
            "actuator_gear"} <= varied
    # the env's stack: the base's budget and stat_meaninertia, no row
    # plan, one hull table per variant
    envs_stack = tenv.model_dr
    assert envs_stack.varied == varied and tenv.n_variants == 2
    assert envs_stack.plan is None and pairs[0][1].plan is not None
    assert envs_stack.stat_meaninertia == pairs[0][1].stat_meaninertia
    assert envs_stack.opt.iterations == jenv.model.opt.iterations
    assert envs_stack.mesh_kernel[1].K == 2


def test_model_from_numpy_stacks_variants(pairs):
    """`model_from_numpy` with the other variants' arrays gives the stack
    of the models built one by one."""
    (j06, t06), (j10, t10) = pairs
    l06, aux = export_model(j06)
    l10, _ = export_model(j10)
    m = io.model_from_numpy(l06, aux, device="cpu", dtype=torch.float64,
                            variants=[l10])
    ref, varied = io.stack_variants([t06, t10])
    assert m.varied == varied and m.body_mass.shape[0] == 2
    for n in varied:
        assert torch.equal(getattr(m, n), getattr(ref, n)), n


def test_stack_refuses(pairs):
    (_, t06), (_, t10) = pairs
    with pytest.raises(NotImplementedError, match="qpos0"):
        io.stack_variants([t06, t10.replace(qpos0=t10.qpos0 + 0.1)])
    with pytest.raises(ValueError, match="structure"):
        io.stack_variants([t06, t10.replace(
            jnt_limited=np.zeros_like(t10.jnt_limited))])
    with pytest.raises(ValueError, match="two or more"):
        io.stack_variants([t06])


def test_model_at_gathers_each_env(pairs, envs):
    _, tenv = envs
    ids = torch.as_tensor(ENV_IDS)
    m = io.model_at(tenv.model_dr, ids)
    for n in m.varied - {"mesh_vert"}:
        for e, v in enumerate(ENV_IDS):
            torch.testing.assert_close(getattr(m, n)[e],
                                       getattr(pairs[v][1], n), rtol=0,
                                       atol=0)
    assert m.mesh_vert.shape[0] == 2 and torch.equal(m.env_id, ids.long())


def test_variant_streams_match_jax(envs, streams):
    _, tenv = envs
    assert {"body_mass", "body_inertia", "body_iquat", "geom_friction",
            "pair_friction", "dof_armature", "jnt_stiffness"} <= \
        tenv.domain_rand.leaves
    check_streams(streams, len(SCALINGS))
    # the envs part: the same actions, other variants and draws
    _, ts = streams[2]
    assert not torch.allclose(ts.data.qvel[0], ts.data.qvel[3])
    assert not torch.allclose(ts.data.qvel[1], ts.data.qvel[2])


def test_per_env_forward_matches_jax(envs, streams):
    jenv, tenv = envs
    _, ts = streams[2]  # the second step's state (before any auto-reset)
    d = ts.data.replace(ctrl=torch.as_tensor(np.random.default_rng(8)
                                             .uniform(-0.3, 0.3, (
                                                 E, tenv.action_dim))))
    js = streams[2][0]
    model, d = tenv._apply_dr(d, ts.env_id, ts.dr)
    assert "body_mass" in model.varied and "mesh_vert" in model.varied
    got = fwd.forward(model, d)
    d0 = jax_make_data(jenv.model, dtype=jnp.float64)
    ref = jax.jit(jax.vmap(lambda i, dr, q, v, u: jfwd.forward(
        jenv._apply_dr(jenv._model_at(i), dr),
        d0.replace(qpos=q, qvel=v, ctrl=u))))(
        jnp.asarray(ENV_IDS), js.dr, jnp.asarray(d.qpos.numpy()),
        jnp.asarray(d.qvel.numpy()), jnp.asarray(d.ctrl.numpy()))
    for name in ("qacc", "qacc_smooth", "qfrc_constraint", "xpos", "xquat",
                 "geom_xpos", "cinert", "qM"):
        assert rel_err(getattr(got, name).numpy(),
                       getattr(ref, name)) < 1e-9, name
    act = np.asarray(ref.contact.dist) < np.asarray(ref.contact.includemargin)
    assert act.any()
    np.testing.assert_array_equal(
        (got.contact.dist < got.contact.includemargin).numpy(), act)
    assert rel_err(got.contact.dist.numpy()[act],
                   np.asarray(ref.contact.dist)[act]) < 1e-9
