"""Forward dynamics, the Euler and RK4 integrators and the n-step control
step.

Counterpart of `loco_mujoco_tpu/ops/forward.py`. `forward` takes the mega
path, the whole forward as one Hopper kernel (`hopper_mega.mega_forward`),
when the model's row plan (`ops/plan.py`) has `mega` (plane-only
collision, or with `mega_ell` the extended collision, elliptic or
pyramidal), the data is float32 and `LMT_MEGA` is not "0" (forward.py:202-210);
otherwise it runs the staged
path, `forward_staged`: the stages as separate functions over a leading env
axis E, with the Hopper kernels of the plane-mesh collision
(`hopper_collision`). With a plan (float32 data of a model inside the row
envelope), the constraint stage is the fused kernel
(`hopper_fused.fused_constraint`, forward.py:179-192), and the reference's
stage gates (forward.py:55-123) apply: a smooth plan rebuilds the smooth
stage in the kernel from the FK outputs, so only kinematics and collision
run before it; a non-smooth plan (tendons, activations) runs com_pos, the
tendons, collision, the velocity, passive, rne and actuation stages, and
acceleration writes qfrc_smooth only (the kernel builds M from cinert and
solves qacc_smooth); crb is skipped under RK4 or `euler_dv`, and factor_m
with any plan. Without a plan every stage runs, then `make_constraint` and
the standalone Newton kernel (`hopper_newton.solve`, reading the rows
env-major in place). `step_n` runs n physics steps as one megastep kernel
launch, or returns None outside that envelope (and under `LMT_MEGASTEP=0`
or `LMT_MEGA=0`), as forward.py:325-341 does.

Every function runs on the device of its tensors. `plain=True` replaces the
kernels by their plain PyTorch versions on any device: the reference the
kernels are held to on the card.
"""

from __future__ import annotations

import os

import torch

from ..core.types import Data, DisableBit, IntegratorType, Model
from . import actuation as act_mod
from . import collision as coll_mod
from . import constraint as con_mod
from . import inertia, kinematics, linalg, passive, solver, tendon, velocity
from . import math as m3
from . import plan as plan_mod
from .plan import maybe_plan
from .support import dof_body_mask, static_tensor


def fwd_position(model: Model, data: Data, plain: bool = False) -> Data:
    data = kinematics.kinematics(model, data)
    data = tendon.tendon(model, kinematics.com_pos(model, data))
    data = inertia.crb(model, data)
    data = coll_mod.collision(model, data, plain)
    return inertia.factor_m(model, data)


def fwd_velocity(model: Model, data: Data) -> Data:
    data = tendon.tendon_vel(model, data)
    data = velocity.com_vel(model, data)
    data = passive.passive(model, data)
    return velocity.rne(model, data)


def fwd_actuation(model: Model, data: Data) -> Data:
    return act_mod.actuation(model, data)


def _xfrc_projection(model: Model, data: Data) -> torch.Tensor:
    """mj_xfrcAccumulate: body wrenches projected through cdof."""
    force, torque = data.xfrc_applied[..., :3], data.xfrc_applied[..., 3:]
    offset = data.xipos - data.subtree_com[:, model.body_rootid]
    t_eff = torque + m3.cross(offset, force)
    mask = static_tensor(model, "dof_body_mask",
                         lambda: dof_body_mask(model)).T  # (nv, nbody)
    tm, fm = mask @ t_eff, mask @ force  # (E, nv, 3)
    return torch.sum(data.cdof[..., :3] * tm + data.cdof[..., 3:] * fm, dim=-1)


def qfrc_smooth(model: Model, data: Data) -> torch.Tensor:
    """passive - bias + actuator + applied + projected xfrc."""
    return (data.qfrc_passive - data.qfrc_bias + data.qfrc_actuator
            + data.qfrc_applied) + _xfrc_projection(model, data)


def fwd_acceleration(model: Model, data: Data) -> Data:
    qfrc = qfrc_smooth(model, data)
    return data.replace(qfrc_smooth=qfrc,
                        qacc_smooth=inertia.solve_m(model, data, qfrc))


def fwd_constraint(model: Model, data: Data, plain: bool = False) -> Data:
    """The constraint stage: the fused kernel with a plan (`data` then
    needs only the FK outputs and the contacts), else make_constraint and
    the Newton solve (euler_dv None: Euler then solves it from qM)."""
    if maybe_plan(model, data) is None:
        efc = con_mod.make_constraint(model, data)
        return solver.solve(model, data, efc, plain).replace(euler_dv=None)
    from . import hopper_fused

    if plain:
        return hopper_fused.fused_constraint_plain(
            model, data, solve64=model.plan.elliptic)
    return hopper_fused.fused_constraint(model, data)


def needs_qm(model: Model, plan) -> bool:
    """Euler reads qM for its implicit damping: the plan has no `euler_dv`
    (per-env damping, `plan.dyn_damping()`) and EULERDAMP is on. The
    reference keeps crb upstream of its kernels then (forward.py:72-77)."""
    return (model.opt.integrator == int(IntegratorType.EULER)
            and not model.opt.disableflags & DisableBit.EULERDAMP
            and not plan.euler_dv)


def stages(model: Model, data: Data, plain: bool = False,
           ranked: bool = False) -> Data:
    """The stages before the constraint stage, with the reference's stage
    gates (see the module note). With a plan, crb runs only where Euler
    reads qM (`needs_qm`): the port's plans set `euler_dv` unless
    EULERDAMP is disabled or the damping is per env. `ranked`: the
    collision's slots in the mega kernels' order (`collision.collision`),
    for the mega plain version."""
    plan = maybe_plan(model, data)
    if plan is None:
        data = fwd_position(model, data, plain)
        return fwd_acceleration(model, fwd_actuation(
            model, fwd_velocity(model, data)))
    data = kinematics.kinematics(model, data)
    if plan.smooth:
        if needs_qm(model, plan):
            data = inertia.crb(model, kinematics.com_pos(model, data))
        return coll_mod.collision(model, data, plain, ranked)
    data = tendon.tendon(model, kinematics.com_pos(model, data))
    if needs_qm(model, plan):
        data = inertia.crb(model, data)
    data = coll_mod.collision(model, data, plain, ranked)
    data = fwd_actuation(model, fwd_velocity(model, data))
    return data.replace(qfrc_smooth=qfrc_smooth(model, data))


def forward_staged(model: Model, data: Data, plain: bool = False) -> Data:
    """mj_forward, staged, with the reference's stage gates (see the module
    note)."""
    return fwd_constraint(model, stages(model, data, plain), plain)


def mega_enabled(model: Model, data: Data):
    """The row plan when `forward` takes the mega path, else None."""
    if os.environ.get("LMT_MEGA", "1") == "0":
        return None
    plan = maybe_plan(model, data)
    return plan if plan is not None and plan.mega else None


def forward(model: Model, data: Data, plain: bool = False) -> Data:
    """mj_forward: the mega path where it applies (see the module note),
    else the staged path. On the mega path the position- and
    velocity-stage fields of Data stay stale (hopper_mega), but for qM
    where Euler reads it (`needs_qm`): crb runs upstream of the kernel."""
    plan = mega_enabled(model, data)
    if plan is not None:
        from . import hopper_mega

        if needs_qm(model, plan):
            data = inertia.crb(model, kinematics.com_pos(
                model, kinematics.kinematics(model, data)))

        if plain:
            return hopper_mega.mega_forward_plain(model, data)
        return hopper_mega.mega_forward(model, data)
    return forward_staged(model, data, plain)


def rk4(model: Model, data: Data, stage_forward) -> Data:
    """mj_RungeKutta with the fixed RK4 tableau; `data` holds the stage-1
    forward and `stage_forward(d, i)` runs the forward of stage i = 1..3."""
    dt = model.opt.timestep
    a = [0.5, 0.5, 1.0]
    b = [1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6]
    d0 = data
    qpos0, qvel0, act0 = d0.qpos, d0.qvel, d0.act
    derivs = [(d0.qvel, d0.qacc, d0.act_dot)]
    # mj_step copies qacc -> qacc_warmstart right after the first forward,
    # so the stage 2-4 solves warm-start from the stage-1 acceleration
    d = d0.replace(qacc_warmstart=d0.qacc)
    for i in range(3):
        d = d.replace(qpos=qpos0 + dt * a[i] * derivs[i][0],
                      qvel=qvel0 + dt * a[i] * derivs[i][1],
                      act=act0 + dt * a[i] * derivs[i][2] if model.na
                      else act0)
        d = stage_forward(d, i + 1)
        derivs.append((d.qvel, d.qacc, d.act_dot))
    qpos = qpos0 + dt * sum(b[i] * derivs[i][0] for i in range(4))
    qvel = qvel0 + dt * sum(b[i] * derivs[i][1] for i in range(4))
    act = _advance_act(model, act0, sum(b[i] * derivs[i][2]
                                        for i in range(4))) if model.na \
        else act0
    # the returned Data's derived fields (contacts, forces, qacc) are the
    # stage-4 forward's, as after mj_RungeKutta
    return d.replace(qpos=qpos, qvel=qvel, act=act, time=d0.time + dt,
                     qacc_warmstart=d0.qacc)


def _advance_act(model: Model, act: torch.Tensor,
                 act_dot: torch.Tensor) -> torch.Tensor:
    """act + dt act_dot, clamped per act slot to the actrange of its
    actuator where that is limited (forward.py:219-237)."""
    if model.na == 0:
        return act
    act = act + model.opt.timestep * act_dot
    lo, hi = (static_tensor(model, f"act_{i}", lambda i=i: plan_mod.act_bounds(
        model.na, model.actuator_actadr, model.actuator_actlimited,
        model.actuator_actrange.cpu().numpy())[i]) for i in (0, 1))
    return torch.minimum(torch.maximum(act, lo), hi)


def damping_dv(model: Model, data: Data) -> torch.Tensor:
    """Euler's implicit-damping velocity change from qM (forward.py:255-
    259): (qM + dt diag(damping))^-1 (qM qacc), with each env's damping
    where `Data.dof_damping` holds it."""
    if data.dof_damping is not None:
        damp = torch.diag_embed(data.dof_damping)
    elif "dof_damping" in model.varied:
        damp = torch.diag_embed(model.dof_damping)
    else:
        damp = torch.diag(model.dof_damping)
    mh = data.qM + model.opt.timestep * damp
    return linalg.spd_solve(mh, inertia.mul_m(model, data, data.qacc))


def euler(model: Model, data: Data) -> Data:
    """mj_Euler after a forward (forward.py:240-266): semi-implicit, with
    implicit joint damping qvel += dt (M + dt diag(damping))^-1 (M qacc),
    taken from the kernels' euler_dv where a plan computed it, else solved
    from qM; with EULERDAMP disabled, qvel += dt qacc."""
    dt = model.opt.timestep
    act = _advance_act(model, data.act, data.act_dot)
    if model.opt.disableflags & DisableBit.EULERDAMP:
        qvel = data.qvel + dt * data.qacc
    elif data.euler_dv is not None:
        qvel = data.qvel + dt * data.euler_dv
    else:
        qvel = data.qvel + dt * damping_dv(model, data)
    qpos = data.qpos + dt * qvel  # nq == nv: hinge and slide joints
    return data.replace(qpos=qpos, qvel=qvel, act=act, time=data.time + dt,
                        qacc_warmstart=data.qacc)


def step(model: Model, data: Data, plain: bool = False) -> Data:
    """One physics step: forward dynamics, then RK4 or Euler (mj_step)."""
    integrator = model.opt.integrator
    if integrator == int(IntegratorType.RK4):
        def fwd(d, i):
            return forward(model, d, plain)

        return rk4(model, fwd(data, 0), fwd)
    if integrator == int(IntegratorType.EULER):
        return euler(model, forward(model, data, plain))
    raise NotImplementedError("Euler and RK4 are the integrators ported")


def step_n(model: Model, data: Data, n_steps: int) -> Data | None:
    """n_steps physics steps as one megastep kernel launch
    (`hopper_mega.mega_step_n`), or None outside its envelope: the caller
    then runs `step` n times. Derived Data fields stay stale."""
    if os.environ.get("LMT_MEGASTEP", "1") == "0":
        return None
    if mega_enabled(model, data) is None:
        return None
    from . import hopper_mega

    return hopper_mega.mega_step_n(model, data, n_steps)
