"""LocoEnv: the batched environment layer.

Counterpart of `loco_mujoco_tpu/envs/base.py` (reference
`loco_mujoco/environments/base.py`). The JAX package writes `reset` and
`step` for one env and vmaps them; here every function takes the whole
batch, an `EnvState` whose tensors carry a leading env axis E, and runs on
the device of its tensors.

Correspondence with the reference semantics (base.py's own list):

- action normalization to [-1, 1] from the actuators' ctrlrange;
- n_substeps physics steps per control step: `forward.step_n`, one
  megastep launch per control step, or, where it returns None (outside the
  megastep envelope, `LMT_MEGASTEP=0`), n calls of `forward.step`;
- obs = the spec vector minus the global x/y entries;
- trajectory-based reset with recentred x/y; the reset runs one forward
  (the mega forward where the model's plan has `mega`);
- absorbing = the fall predicate of the obs; done = absorbing or the
  horizon reached;
- auto-reset: where done, the carried fields of a fresh episode start are
  swapped in by `torch.where` over the batch (base.py:459-496).

Stacked model variants (`model_variants`, base.py:117-135: K models of
one structure, the 4-ages scalings or the carried weights) are stacked by
`io.stack_variants`; each env's variant `env_id` is drawn at reset and at
auto-reset (uniform over the K, or 0 without `random_env_reset`), and
every step runs on the per-env Model of its batch (`io.model_at`, the
reference's `_model_at`). Domain randomization
(`domain_randomization_config`, a parsed dict, see
`utils.domain_randomization`) draws each env's values at reset and turns
them into per-env leaves there (on its variant's model), which the steps
put into the per-env Model (base.py:267-270), but for joint damping,
which rides as `Data.dof_damping` with the plan's per-env damping variant
(`RowPlan.dyn_damping`), so that the mega plans keep it. The leaves that
vary per env choose, once, where the env is built, which parts of the
row plan the steps keep (`RowPlan.per_env`, the reference's gates on
traced leaves), and a varying leaf that no stage reads per env raises
(`io.check_per_env`). Random draws (variants, trajectory samples,
randomization) come from the `torch.Generator` that the caller gives
`reset_batch` and that `EnvState.rng` carries.

Not ported: the foot-force window (`use_foot_forces`), which needs
per-substep contact forces (a later slice); the robots' observation and
reset hooks (the 4-ages env-id bits and per-variant trajectory ranges,
the carried weight's obs), with the SITE_ROT entries that only such a
hook may read (base.py:147-162); the switches that turn absorbing states
or the auto-reset off, and a start at step 0 of a random trajectory.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import io
from ..core.types import Data, Model
from ..ops import forward as fwd
from .observation import ObsIndex


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Dynamic state of a batch of E envs (base.py:38-54)."""

    data: Data
    obs: torch.Tensor  # (E, obs_dim)
    reward: torch.Tensor  # (E,)
    absorbing: torch.Tensor  # (E,) bool
    done: torch.Tensor  # (E,) bool: absorbing or horizon reached
    rng: torch.Generator  # the batch's draws (resets, randomization)
    step_no: torch.Tensor  # (E,) int32: steps since the episode start
    traj_no: torch.Tensor  # (E,) int32: trajectory used at the start
    subtraj_step: torch.Tensor  # (E,) int32
    goal: torch.Tensor  # (E, 2) [angle, speed] (zeros when unused)
    env_id: torch.Tensor  # (E,) int32: model variant id
    dr: dict  # {leaf: (E, n)} randomized draws ({} without randomization)

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


class LocoEnv:
    """Host-built environment over one model: the obs layout, the action
    normalization, the solver budget, the trajectory and the randomization
    are fixed at construction; `reset_batch` and `step_batch` run the
    batch."""

    def __init__(
        self,
        model: Model,
        obs_index: ObsIndex,
        *,
        horizon: int = 1000,
        n_substeps: int = 10,
        reward_fn: Callable = None,
        traj_data=None,
        random_start: bool = True,
        init_step_no: Optional[int] = None,
        use_foot_forces: bool = False,
        has_fallen: Callable = None,
        solver_iterations: int = 8,
        ls_iterations: int = 8,
        model_variants=None,
        random_env_reset: bool = True,
        domain_randomization_config: Optional[dict] = None,
    ):
        if use_foot_forces:
            raise NotImplementedError(
                "the foot-force window needs per-substep contact forces "
                "(a later slice)")
        if len(obs_index.site_idx):
            raise NotImplementedError(
                "SITE_ROT entries read site_xmat, which is stale on the "
                "fused step paths; only a robot's observation hook may read "
                "them (base.py:147-162), and those hooks are not ported")
        if traj_data is not None and not random_start and init_step_no is None:
            raise NotImplementedError(
                "without random starts, give init_step_no (a random "
                "trajectory's step 0 is not ported)")
        # the batched solver budget (base.py:98-109): the model's Newton
        # and line-search budgets cut to the env's, in its options and in
        # its row plan. A model whose budget kept it from a plan at load
        # (past 16 / 8) keeps none and runs the staged path without one.
        model = with_solver_budget(model, solver_iterations, ls_iterations)
        self.model = model
        # the variants (base.py:117-135): each takes this model's budgets
        # and stat_meaninertia (io.stack_variants)
        self.variants, self.n_variants = None, 1
        if model_variants:
            norm = [with_solver_budget(v, model.opt.iterations,
                                       model.opt.ls_iterations).replace(
                stat_meaninertia=model.stat_meaninertia)
                for v in model_variants]
            self.variants, _ = io.stack_variants(norm)
            self.n_variants = len(norm)
        self.random_env_reset = random_env_reset
        self.domain_rand = None
        # the model the steps start from: the stack of the variants or the
        # model, with the plan of the leaves that vary per env
        self.model_dr = model if self.variants is None else self.variants
        if domain_randomization_config is not None:
            from ..utils.domain_randomization import DomainRandomizationHandler

            self.domain_rand = DomainRandomizationHandler(
                model, domain_randomization_config)
            leaves = self.domain_rand.leaves
            io.check_per_env(leaves)
            plan = self.model_dr.plan
            if plan is not None:
                plan = plan.per_env(leaves)
            self.model_dr = self.model_dr.replace(plan=plan)
        self.obs_index = obs_index
        self.horizon = horizon
        self.n_substeps = n_substeps
        self.reward_fn = reward_fn or (lambda s, a, ns, i: torch.zeros(
            ns.shape[0], dtype=ns.dtype, device=ns.device))
        self.traj = traj_data
        self.random_start = random_start
        self.init_step_no = init_step_no
        self._has_fallen = has_fallen or (lambda obs: torch.zeros(
            obs.shape[0], dtype=torch.bool, device=obs.device))
        self.dtype = model.qpos0.dtype
        self.device = model.qpos0.device

        # action renormalization from ctrlrange (base.py:178-183)
        ctrl = model.actuator_ctrlrange
        self.norm_act_mean = (ctrl[:, 1] + ctrl[:, 0]) / 2.0
        self.norm_act_delta = (ctrl[:, 1] - ctrl[:, 0]) / 2.0
        self.action_dim = model.nu
        self.obs_dim = self.obs_index.size - 2

    def _build_obs(self, data: Data) -> torch.Tensor:
        """The spec vector minus the global x/y entries (base.py:241-248)."""
        return self.obs_index.build_obs(data).to(self.dtype)[:, 2:]

    def _model_at(self, env_id: torch.Tensor) -> Model:
        """The per-env Model of the variants of a batch (base.py:262-265),
        or the model, with the plan of the leaves that vary per env."""
        if self.variants is None:
            return self.model_dr
        return io.model_at(self.model_dr, env_id)

    def _apply_dr(self, data: Data, env_id: torch.Tensor, dr: dict) -> tuple:
        """(model, data) of a step: the per-env Model of the batch's
        variants with each env's randomized leaves in it (base.py:267-270),
        with the plan of the leaves that vary per env, and each env's joint
        damping in `Data.dof_damping` (with the plan's damping-row
        variant)."""
        if self.variants is None and not dr:
            return self.model, data
        model = self._model_at(env_id)
        leaves = {k: v for k, v in dr.items() if k != "dof_damping"}
        if leaves:
            model = model.replace(varied=model.varied | set(leaves),
                                  **leaves)
        if "dof_damping" in dr:
            data = data.replace(dof_damping=dr["dof_damping"])
        elif "dof_damping" in model.varied:  # variants' own damping
            data = data.replace(dof_damping=model.dof_damping)
        return model, data

    def _starts(self, generator: torch.Generator, n: int) -> dict:
        """What an episode start of n envs draws (base.py:272-358): the
        variant env_id, qpos and qvel (qpos0 and rest, then the trajectory
        sample), traj_no, subtraj_step and the randomized leaves `dr` (on
        each env's variant)."""
        dev = self.device
        i32 = lambda: torch.zeros(n, dtype=torch.int32, device=dev)  # noqa
        env_id = i32()
        if self.variants is not None and self.random_env_reset:
            env_id = torch.randint(0, self.n_variants, (n,),
                                   generator=generator, device=dev,
                                   dtype=torch.int32)
        dr = {}
        if self.domain_rand is not None and self.domain_rand.leaves:
            dr = self.domain_rand.apply(
                self._model_at(env_id), self.domain_rand.sample(
                    generator, n, dtype=self.dtype, device=dev))
        qpos = self.model.qpos0.expand(n, -1).clone()
        qvel = torch.zeros((n, self.model.nv), dtype=self.dtype, device=dev)
        traj_no, subtraj_step = i32(), i32()
        if self.traj is not None:
            if self.random_start:
                sample, traj_no, subtraj_step = self.traj.sample_reset(
                    generator, n)
            else:
                tl = self.traj.traj_len
                full = lambda v: torch.full((n,), int(v), device=dev)  # noqa
                sample, traj_no, subtraj_step = self.traj.sample_at(
                    full(self.init_step_no / tl), full(self.init_step_no % tl))
            qpos, qvel = self.obs_index.sample_to_qpos_qvel(qpos, qvel, sample)
        return dict(qpos=qpos, qvel=qvel, traj_no=traj_no,
                    subtraj_step=subtraj_step, dr=dr, env_id=env_id)

    def reset_batch(self, n_envs: int,
                    generator: torch.Generator) -> EnvState:
        """Episode starts of n_envs envs, each through one forward;
        `generator` (on the model's device, seeded by the caller) draws the
        trajectory samples and the randomization, and the state carries it
        for the auto-resets."""
        n = int(n_envs)
        st = self._starts(generator, n)
        model, data = self._apply_dr(
            io.make_data(self.model, n).replace(qpos=st["qpos"],
                                                qvel=st["qvel"]),
            st["env_id"], st["dr"])
        data = fwd.forward(model, data)
        dev = self.device
        i32 = torch.zeros(n, dtype=torch.int32, device=dev)
        return EnvState(
            data=data, obs=self._build_obs(data),
            reward=torch.zeros(n, dtype=self.dtype, device=dev),
            absorbing=torch.zeros(n, dtype=torch.bool, device=dev),
            done=torch.zeros(n, dtype=torch.bool, device=dev),
            rng=generator, step_no=i32, traj_no=st["traj_no"],
            subtraj_step=st["subtraj_step"],
            goal=torch.zeros((n, 2), dtype=self.dtype, device=dev),
            env_id=st["env_id"], dr=st["dr"])

    def step_batch(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """One control step of every env (n_substeps physics steps),
        auto-resetting (base.py:364-432)."""
        a = action.to(self.dtype) * self.norm_act_delta + self.norm_act_mean
        model, data = self._apply_dr(state.data.replace(ctrl=a),
                                     state.env_id, state.dr)
        out = fwd.step_n(model, data, self.n_substeps)
        if out is None:  # outside the megastep envelope: per substep
            out = data
            for _ in range(self.n_substeps):
                out = fwd.step(model, out)
        return self._finish_step(state, out, self._build_obs(out), action)

    def _finish_step(self, state: EnvState, data: Data, obs,
                     action) -> EnvState:
        """Reward, absorbing / done and the auto-reset merge
        (base.py:434-496)."""
        info = {"goal_angle": state.goal[:, 0], "goal_vel": state.goal[:, 1],
                "env_id": state.env_id}
        reward = self.reward_fn(state.obs, action, obs, info).to(self.dtype)
        absorbing = self._has_fallen(obs)
        step_no = state.step_no + 1
        done = absorbing | (step_no >= self.horizon)
        stepped = state.replace(data=data, obs=obs, reward=reward,
                                absorbing=absorbing, done=done,
                                step_no=step_no)
        # where done, a fresh episode's carried fields: qpos and qvel from
        # its start, act, ctrl, qacc, the warm start, the applied forces,
        # time, the step count and the goal back to their reset zeros, and
        # its bookkeeping, variant and randomized leaves; the derived Data
        # fields are recomputed by the next step's forward, so no Data is
        # built here
        fresh = self._starts(state.rng, obs.shape[0])

        def sel(f, s):
            m = done.reshape(-1, *([1] * (s.dim() - 1)))
            return torch.where(m, f, s)

        def zero(s):
            return s.masked_fill(done.reshape(-1, *([1] * (s.dim() - 1))), 0)

        sd = data
        dr = {k: sel(fresh["dr"][k], v) for k, v in state.dr.items()}
        merged = sd.replace(
            qpos=sel(fresh["qpos"], sd.qpos), qvel=sel(fresh["qvel"], sd.qvel),
            act=zero(sd.act), ctrl=zero(sd.ctrl), qacc=zero(sd.qacc),
            qacc_warmstart=zero(sd.qacc_warmstart),
            qfrc_applied=zero(sd.qfrc_applied),
            xfrc_applied=zero(sd.xfrc_applied), time=zero(sd.time),
            dof_damping=dr.get("dof_damping"))
        fresh_obs = self._build_obs(sd.replace(qpos=fresh["qpos"],
                                               qvel=fresh["qvel"]))
        return stepped.replace(
            data=merged, obs=sel(fresh_obs, obs),
            step_no=zero(step_no),
            traj_no=sel(fresh["traj_no"], state.traj_no),
            subtraj_step=sel(fresh["subtraj_step"], state.subtraj_step),
            goal=zero(state.goal),
            env_id=sel(fresh["env_id"], state.env_id), dr=dr)


def with_solver_budget(model: Model, iterations: int,
                       ls_iterations: int) -> Model:
    """`model` with its Newton and line-search budgets cut to at most
    `iterations` / `ls_iterations`, in its options and its row plan (the
    batched budget, base.py:98-109)."""
    it = min(model.opt.iterations, int(iterations))
    ls = min(model.opt.ls_iterations, int(ls_iterations))
    if (it, ls) == (model.opt.iterations, model.opt.ls_iterations):
        return model
    return model.replace(
        opt=model.opt.replace(iterations=it, ls_iterations=ls),
        plan=None if model.plan is None else model.plan.with_budget(it, ls))


# ---- fall predicates, as functions of the obs (E, obs_dim) ---------------


def _out(x, lo, hi):
    """x outside [lo, hi]."""
    return (x < lo) | (x > hi)


def humanoid_has_fallen(idx):
    """The humanoids' fall predicate (models/humanoids/humanoid.py:196-205,
    reference base_humanoid.py:129-180); `idx` the obs indices of the
    pelvis height, tilt, list and rotation and of the lumbar extension,
    bending and rotation, in that order."""
    idx = list(idx)
    pi = np.pi

    def has_fallen(obs):
        o = [obs[:, i] for i in idx]
        return (_out(o[0], -0.46, 0.1) | _out(o[1], -pi / 4.5, pi / 12)
                | _out(o[2], -pi / 12, pi / 8) | _out(o[3], -pi / 9, pi / 9)
                | _out(o[4], -pi / 4, pi / 10)
                | _out(o[5], -pi / 10, pi / 10)
                | _out(o[6], -pi / 4.5, pi / 4.5))

    return has_fallen


def _pelvis_has_fallen(obs, idx, rot):
    """The bipeds' pelvis terms: ty, tilt, list and rotation (the last
    within +-rot)."""
    pi = np.pi
    o = [obs[:, i] for i in idx[:4]]
    return (_out(o[0], -0.3, 0.1) | _out(o[1], -pi / 4.5, pi / 12)
            | _out(o[2], -pi / 12, pi / 8) | _out(o[3], -rot, rot))


def h1_has_fallen(idx):
    """UnitreeH1's fall predicate (models/humanoids/unitree_h1.py:44-56);
    `idx` the obs indices of pelvis_ty, pelvis_tilt, pelvis_list and
    pelvis_rotation."""
    idx = list(idx)
    return lambda obs: _pelvis_has_fallen(obs, idx, np.pi / 8)


def g1_has_fallen(idx):
    """UnitreeG1's fall predicate (models/humanoids/unitree_g1.py:43-54):
    H1's terms and limits; `idx` as `h1_has_fallen`'s."""
    return h1_has_fallen(idx)


def atlas_has_fallen(idx):
    """Atlas's fall predicate (models/humanoids/atlas.py:41-61): the pelvis
    terms with a rotation limit of pi/10, and, where `idx` goes on past
    the pelvis's four with the obs indices of back_bky, back_bkx and
    back_bkz, the back's extension, bending and rotation."""
    idx = list(idx)
    pi = np.pi

    def has_fallen(obs):
        cond = _pelvis_has_fallen(obs, idx, pi / 10)
        if len(idx) > 4:
            b = [obs[:, i] for i in idx[4:7]]
            cond = (cond | _out(b[0], -pi / 4, pi / 10)
                    | _out(b[1], -pi / 10, pi / 10)
                    | _out(b[2], -pi / 4.5, pi / 4.5))
        return cond

    return has_fallen


def talos_has_fallen(idx):
    """Talos's fall predicate (models/humanoids/talos.py:47-66): the pelvis
    terms with a rotation limit of pi/10, and, where `idx` goes on past
    the pelvis's four with the obs indices of back_bky and back_bkz, the
    back's extension within (-pi/4, pi/10) and rotation within +-pi/10."""
    idx = list(idx)
    pi = np.pi

    def has_fallen(obs):
        cond = _pelvis_has_fallen(obs, idx, pi / 10)
        if len(idx) > 4:
            b = [obs[:, i] for i in idx[4:6]]
            cond = (cond | _out(b[0], -pi / 4, pi / 10)
                    | _out(b[1], -pi / 10, pi / 10))
        return cond

    return has_fallen


def quadruped_has_fallen(obs):
    """UnitreeA1's fall predicate (models/quadrupeds/unitree_a1.py:134-138):
    obs 0, 1, 2 are the trunk height, list and tilt."""
    return ((obs[:, 1] < -0.2793) | (obs[:, 1] > 0.2793)
            | (obs[:, 2] < -0.192) | (obs[:, 2] > 0.192)
            | (obs[:, 0] < -0.24))
