"""Domain randomization of the port (`utils/domain_randomization.py`)
against the JAX package's handler, and the env layer with it, on the CPU.

1. The Joints section's schema, as tests/test_domain_rand.py holds it on
   the cases that need no reference YAML: a joint's own entry replaces the
   default, `exclude` filters the default, sigma 0 is no draw, and the
   distribution checks (one distribution, uniform_range ordered and
   non-negative, uniform_range_delta below the base value, known joint
   properties); the parsed plans (indices, distributions, parameters,
   bases) equal the JAX handler's on the same config.
2. `apply` against the JAX handler's `apply` on the same numpy draws, per
   env under vmap: the per-env leaves are equal exactly (a scatter of the
   same numbers).
3. `sample` from a `torch.Generator`: draws inside their distributions'
   supports, different per env, repeatable from the seed.
4. The env layer with damping randomization on the small humanoid in
   float32 (the plain versions on the CPU): each env's draws reach
   `Data.dof_damping`, the model's plan is the damping-row variant, and a
   control step runs and stays finite.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.utils.domain_randomization import (
    DomainRandomizationHandler as JHandler)
from loco_mujoco_tpu_torch.core import io as tio
from loco_mujoco_tpu_torch.envs import base
from loco_mujoco_tpu_torch.envs.observation import ObsIndex, ObservationType
from loco_mujoco_tpu_torch.utils import domain_randomization as tdr
from test_torch_fixture import ASSET, torch_model

CONF = {
    "Default": {"exclude": ["root_x", "root_z", "root_y", "root_rx",
                            "root_ry", "root_rz"],
                "Joints": {"damping": {"uniform_range_delta": 0.5}}},
    "Joints": {"knee_r": {"damping": {"uniform_range": [3.5, 4.5]}},
               "knee_l": {"damping": {"sigma": 0.0}},
               "hip_y_l": {"damping": {"sigma": 0.3}}},
}


def yaml_text(conf):
    import yaml

    return yaml.safe_dump(conf)


def jax_handler(jm, conf):
    with tempfile.NamedTemporaryFile("w", suffix=".yaml") as f:
        f.write(yaml_text(conf))
        f.flush()
        return JHandler(jm, f.name)


@pytest.fixture(scope="module")
def models():
    return torch_model(full=False)


def test_joint_schema_matches_jax(models):
    jm, tm = models
    h, jh = tdr.DomainRandomizationHandler(tm, CONF), jax_handler(jm, CONF)
    assert set(h.merged) == set(jh.merged) == {"dof_damping"}
    for k in ("idx", "dist", "p1", "p2", "base"):
        np.testing.assert_array_equal(h.merged["dof_damping"][k],
                                      jh.merged["dof_damping"][k])
    assert h.n_params == jh.n_params
    jid, dofadr = tm.names["joint"], tm.jnt_dofadr
    idx = list(h.merged["dof_damping"]["idx"])
    dof = lambda j: int(dofadr[jid[j]])  # noqa: E731
    # a joint's own entry replaces the default; exclude and sigma 0 draw
    # nothing
    assert h.merged["dof_damping"]["dist"][idx.index(dof("knee_r"))] == \
        tdr.UNIFORM
    assert h.merged["dof_damping"]["dist"][idx.index(dof("hip_y_l"))] == \
        tdr.GAUSS
    assert dof("knee_l") not in idx
    assert not any(dof(j) in idx for j in CONF["Default"]["exclude"])


@pytest.mark.parametrize("conf, match", [
    ({"Joints": {"knee_r": {"damping": {"sigma": 1, "uniform_range":
                                        [1, 2]}}}}, "exactly one"),
    ({"Joints": {"knee_r": {"damping": {"uniform_range": [2, 1]}}}},
     "high <= low"),
    ({"Joints": {"knee_r": {"damping": {"uniform_range": [-1, 1]}}}},
     "low < 0"),
    ({"Joints": {"knee_r": {"damping": {"uniform_range_delta": 10.0}}}},
     "exceeds the base"),
    ({"Joints": {"knee_r": {"stiff": {"sigma": 1.0}}}}, "not supported"),
])
def test_joint_schema_errors_match_jax(models, conf, match):
    jm, tm = models
    with pytest.raises(ValueError, match=match):
        tdr.DomainRandomizationHandler(tm, conf)
    with pytest.raises(ValueError, match=match):
        jax_handler(jm, conf)


def test_other_joint_leaves_match_jax(models):
    """stiffness, frictionloss and armature parse and apply as in the
    reference (their envs: tests/test_torch_dr_leaves.py)."""
    jm, tm = models
    conf = {"Joints": {"knee_r": {"stiffness": {"uniform_range": [3, 4]},
                                  "frictionloss": {"sigma": 0.1},
                                  "armature": {"uniform_range": [0.0, 0.1]}}}}
    h, jh = tdr.DomainRandomizationHandler(tm, conf), jax_handler(jm, conf)
    assert set(h.merged) == set(jh.merged)
    rng = np.random.default_rng(2)
    draws = {k: rng.uniform(0.1, 2.0, size=(3, len(v["idx"])))
             for k, v in h.merged.items()}
    got = h.apply(tm, {k: torch.as_tensor(v) for k, v in draws.items()})
    ref = jax.vmap(lambda s: jh.apply(jm, s))(
        {k: jnp.asarray(v) for k, v in draws.items()})
    for k in draws:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(getattr(ref, k)))


def test_apply_matches_jax_exactly(models):
    jm, tm = models
    h, jh = tdr.DomainRandomizationHandler(tm, CONF), jax_handler(jm, CONF)
    n = len(h.merged["dof_damping"]["idx"])
    draws = np.random.default_rng(4).uniform(0.0, 6.0, size=(5, n))
    got = h.apply(tm, {"dof_damping": torch.as_tensor(draws)})
    ref = jax.vmap(lambda s: jh.apply(jm, {"dof_damping": s}).dof_damping)(
        jnp.asarray(draws))
    assert got["dof_damping"].shape == (5, tm.nv)
    np.testing.assert_array_equal(got["dof_damping"].numpy(), np.asarray(ref))


def test_sample_supports_and_seed(models):
    _, tm = models
    h = tdr.DomainRandomizationHandler(tm, CONF)
    m = h.merged["dof_damping"]
    s = h.sample(torch.Generator().manual_seed(1), 4096,
                 dtype=torch.float64)["dof_damping"]
    again = h.sample(torch.Generator().manual_seed(1), 4096,
                     dtype=torch.float64)["dof_damping"]
    torch.testing.assert_close(s, again, rtol=0, atol=0)
    for i, (dist, p1, p2, b) in enumerate(zip(m["dist"], m["p1"], m["p2"],
                                              m["base"])):
        col = s[:, i].numpy()
        if dist == tdr.UNIFORM:
            assert col.min() >= p1 and col.max() <= p2
        elif dist == tdr.UNIFORM_DELTA:
            assert col.min() >= b - p1 and col.max() <= b + p1
        else:
            assert col.min() >= 0.0 and abs(col.mean() - b) < 4 * p1 / 64
        assert col.std() > 0


def _env(model, conf, n_substeps=2):
    names = sorted(model.names["joint"], key=model.names["joint"].get)
    spec = ([(f"q_{j}", j, ObservationType.JOINT_POS) for j in names]
            + [(f"dq_{j}", j, ObservationType.JOINT_VEL) for j in names])
    return base.LocoEnv(model, ObsIndex(model, spec), n_substeps=n_substeps,
                        domain_randomization_config=conf)


def test_env_carries_damping_to_the_kernels():
    """float32 on the CPU: the plain versions of the kernels; the damping
    rows' variant of the plan takes each env's draws from Data."""
    tm = tio.load_model_npz(ASSET, device="cpu")
    conf = {"Default": {"exclude": [j for j in tm.names["joint"]
                                    if j.startswith("root")],
                        "Joints": {"damping": {"uniform_range_delta": 1.0}}}}
    env = _env(tm, conf)
    assert env.model_dr.plan is tm.plan.dyn_damping()
    s = env.reset_batch(3, torch.Generator().manual_seed(0))
    d = s.dr["dof_damping"]
    assert d.shape == (3, tm.nv)
    torch.testing.assert_close(s.data.dof_damping, d, rtol=0, atol=0)
    assert not torch.equal(d[0], d[1])
    roots = [int(tm.jnt_dofadr[tm.names["joint"][j]])
             for j in conf["Default"]["exclude"]]
    assert torch.equal(d[:, roots], tm.dof_damping[roots].expand(3, -1))
    a = torch.zeros((3, env.action_dim))
    s2 = env.step_batch(s, a)
    assert torch.isfinite(s2.obs).all() and torch.isfinite(s2.data.qpos).all()
    torch.testing.assert_close(s2.data.dof_damping, d, rtol=0, atol=0)
