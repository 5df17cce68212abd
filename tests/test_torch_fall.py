"""The fall predicates of the port's env layer (`envs/base.py`) against
their JAX originals, and the stand-ins' choice of them
(`envs/standins.env_parts` / `standin_kind`), on the CPU.

Each biped predicate takes the obs indices of its joints: H1's and G1's the
pelvis's ty, tilt, list and rotation (models/humanoids/unitree_h1.py:44-56,
unitree_g1.py:43-54), Atlas's the same with a rotation limit of pi/10
and, where the model has them, the back's bky, bkx and bkz
(models/humanoids/atlas.py:41-61), Talos's the same pelvis terms and,
where it has them, the back's bky and bkz (models/humanoids/talos.py:47-66). Seeded obs (numpy, 4096 rows of 40
columns within +-0.5, past every limit) go through the JAX function
row by row (vmapped) and through the port's batched one: the booleans
agree exactly. A committed stand-in's env gets its own robot's predicate;
a model of no known kind raises instead of taking A1's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_mujoco_tpu.models.humanoids import atlas as j_atlas
from loco_mujoco_tpu.models.humanoids import talos as j_talos
from loco_mujoco_tpu.models.humanoids import unitree_g1 as j_g1
from loco_mujoco_tpu.models.humanoids import unitree_h1 as j_h1
from loco_mujoco_tpu_torch.core import io
from loco_mujoco_tpu_torch.envs import base, standins
from test_torch_fixture import ASSET as TORQUE_ASSET

ASSETS = TORQUE_ASSET.parent
PELVIS = ["q_pelvis_ty", "q_pelvis_tilt", "q_pelvis_list",
          "q_pelvis_rotation"]
BACK = ["q_back_bky", "q_back_bkx", "q_back_bkz"]
TALOS_BACK = ["q_back_bky", "q_back_bkz"]


def _obs(n=4096, width=40, seed=3):
    """Values within +-0.5 (past every limit above and below)."""
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=(n, width))


CASES = {
    "h1": (j_h1._has_fallen_fn, base.h1_has_fallen, PELVIS),
    "g1": (j_g1._has_fallen_fn, base.g1_has_fallen, PELVIS),
    "atlas": (j_atlas._has_fallen_fn, base.atlas_has_fallen, PELVIS + BACK),
    "atlas_no_back": (j_atlas._has_fallen_fn, base.atlas_has_fallen, PELVIS),
    "talos": (j_talos._has_fallen_fn, base.talos_has_fallen,
              PELVIS + TALOS_BACK),
    "talos_no_back": (j_talos._has_fallen_fn, base.talos_has_fallen, PELVIS),
}


@pytest.mark.parametrize("case", list(CASES))
def test_biped_predicate_matches_jax(case):
    j_fn, t_fn, keys = CASES[case]
    cols = np.random.default_rng(5).choice(40, size=len(keys), replace=False)
    ki = {k: int(c) for k, c in zip(keys, cols)}
    obs = _obs()
    ref = np.asarray(jax.vmap(j_fn(ki))(jnp.asarray(obs)))
    got = t_fn([ki[k] for k in keys])(torch.as_tensor(obs)).numpy()
    assert 0.01 < ref.mean() < 0.99  # both outcomes occur
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("asset,kind", [
    ("humanoid_torque_shape", "humanoid"), ("unitree_a1_shape", "a1"),
    ("unitree_h1_shape", "h1"), ("atlas_shape", "atlas"),
    ("unitree_g1_shape", "g1"), ("talos_shape", "talos"),
    ("unitree_g1_kp_shape", "g1")])
def test_standins_pick_their_own_predicate(asset, kind):
    """env_parts names the stand-in's robot; the bipeds' predicate indices
    are their pelvis joints' (and Atlas's back joints') obs positions."""
    m = io.load_model_npz(ASSETS / f"{asset}.npz", device="cpu")
    parts = standins.env_parts(m)
    assert parts["kind"] == kind
    keys = [k for k, _, _ in parts["spec"]]
    if kind in ("h1", "atlas", "g1", "talos"):
        want = PELVIS + {"atlas": BACK, "talos": TALOS_BACK}.get(kind, [])
        assert parts["fall"] == [keys.index(k) - 2 for k in want]
    env = standins.make_env(m)
    obs = torch.zeros((2, env.obs_dim), dtype=m.qpos0.dtype)
    assert not bool(env._has_fallen(obs).any())


def test_unknown_standin_raises():
    """A pelvis root without G1's, Atlas's or H1's telling joints (here
    H1's stand-in with back_bkz renamed) fits no robot: env_parts
    raises, and no model falls back to A1's predicate."""
    m = io.load_model_npz(ASSETS / "unitree_h1_shape.npz", device="cpu")
    names = dict(m.names)
    joints = dict(names["joint"])
    joints["waist_joint"] = joints.pop("back_bkz")
    names["joint"] = joints
    with pytest.raises(ValueError, match="cannot tell"):
        standins.env_parts(m.replace(names=names))
