"""Actuation: transmission, activation dynamics, gain/bias force production.

Counterpart of `loco_mujoco_tpu/ops/actuation.py` (`:35-273`) for the
actuators core/io admits: joint-transmission actuators with fixed or
affine gain (gainprm[0] + gainprm[1] length + gainprm[2] velocity), no or
affine bias (the same in biasprm; a position servo is fixed gain kp and
bias (0, -kp, -kv)) and no activation or one integrator or filter
activation (act_dot = (ctrl - act) / dynprm[0] for FILTER and FILTEREXACT,
0 for INTEGRATOR, as the reference has it, `:201-208`; the force then reads
act), and tendon-transmission muscles (MuJoCo's mju_muscleGain /
mju_muscleBias / mju_muscleDynamics: piecewise quadratic FLV surfaces, one
activation each). Mixed actuator types in one model are combined with
static masks, every formula evaluated for every actuator, as the reference
does, in its order of operations. Gear, gain and bias parameters, length
ranges and acc0 are each env's where they vary per env (`Model.varied`,
leading axis E): every read of them indexes their last axes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import (BiasType, Data, DisableBit, DynType, GainType,
                          Model, TrnType)
from .support import static_tensor


def _muscle_lnorm(length, lengthrange, prm):
    """Normalized muscle length L in optimum-length units, and l0."""
    r0, r1 = prm[..., 0], prm[..., 1]
    l0 = (lengthrange[..., 1] - lengthrange[..., 0]) / torch.clamp(r1 - r0,
                                                                  min=1e-15)
    return r0 + (length - lengthrange[..., 0]) / torch.clamp(l0, min=1e-15), l0


def _bump(length, lmin, mid, lmax):
    """MuJoCo's skewed bump function (mju_muscleGain helper)."""
    left = 0.5 * (lmin + mid)
    right = 0.5 * (mid + lmax)
    out = torch.zeros_like(length)
    x = (length - lmin) / torch.clamp(left - lmin, min=1e-15)
    out = torch.where((length > lmin) & (length <= left), 0.5 * x * x, out)
    x = (mid - length) / torch.clamp(mid - left, min=1e-15)
    out = torch.where((length > left) & (length <= mid), 1.0 - 0.5 * x * x,
                      out)
    x = (length - mid) / torch.clamp(right - mid, min=1e-15)
    out = torch.where((length > mid) & (length <= right), 1.0 - 0.5 * x * x,
                      out)
    x = (lmax - length) / torch.clamp(lmax - right, min=1e-15)
    return torch.where((length > right) & (length < lmax), 0.5 * x * x, out)


def _peak_force(prm, acc0):
    """prm[2], or scale / acc0 where it is negative (force = -1)."""
    return torch.where(prm[..., 2] < 0,
                       prm[..., 3] / torch.clamp(acc0, min=1e-15), prm[..., 2])


def muscle_gain(length, vel, lengthrange, acc0, prm):
    """mju_muscleGain: -force * FL(L) * FV(V)."""
    lmin, lmax = prm[..., 4], prm[..., 5]
    vmax, fvmax = prm[..., 6], prm[..., 8]
    ln, l0 = _muscle_lnorm(length, lengthrange, prm)
    v = vel / torch.clamp(l0 * vmax, min=1e-15)
    fl = _bump(ln, lmin, torch.ones_like(ln), lmax)
    y = fvmax - 1.0
    fv = torch.where(
        v <= -1.0, torch.zeros_like(v),
        torch.where(v <= 0.0, (v + 1.0) * (v + 1.0),
                    torch.where(v <= y, fvmax - (y - v) * (y - v)
                                / torch.clamp(y, min=1e-15), fvmax)))
    return -_peak_force(prm, acc0) * fl * fv


def muscle_bias(length, lengthrange, acc0, prm):
    """mju_muscleBias: passive force -force * FP(L)."""
    lmax, fpmax = prm[..., 5], prm[..., 7]
    ln, _ = _muscle_lnorm(length, lengthrange, prm)
    b = 0.5 * (1.0 + lmax)
    x_mid = (ln - 1.0) / torch.clamp(b - 1.0, min=1e-15)
    x_hi = (ln - b) / torch.clamp(b - 1.0, min=1e-15)
    fp = torch.where(ln <= 1.0, torch.zeros_like(ln),
                     torch.where(ln <= b, 0.5 * fpmax * x_mid * x_mid,
                                 fpmax * (0.5 + x_hi)))
    return -_peak_force(prm, acc0) * fp


def muscle_dynamics(ctrl, act, prm):
    """mju_muscleDynamics with tausmooth = 0 (the suite's setting)."""
    ctrl = torch.clamp(ctrl, 0.0, 1.0)
    act_c = torch.clamp(act, 0.0, 1.0)
    tau_act = prm[..., 0] * (0.5 + 1.5 * act_c)
    tau_deact = prm[..., 1] / (0.5 + 1.5 * act_c)
    tau = torch.where(ctrl > act, tau_act, tau_deact)
    return (ctrl - act) / torch.clamp(tau, min=1e-15)


def _tables(model: Model):
    """(joint select (nu, nv), tendon select (nu, max(ntendon, 1)), act
    scatter (na, nu)) static 0/1 tables."""
    nu, nv = model.nu, model.nv
    joint_sel = np.zeros((nu, nv))
    tendon_rows = np.zeros((nu, max(model.ntendon, 1)))
    scatter = np.zeros((model.na, nu))
    for u in range(nu):
        t, tid = int(model.actuator_trntype[u]), int(model.actuator_trnid[u, 0])
        if t in (int(TrnType.JOINT), int(TrnType.JOINTINPARENT)):
            joint_sel[u, int(model.jnt_dofadr[tid])] = 1.0
        else:  # TENDON (core/io admits no other transmission)
            tendon_rows[u, tid] = 1.0
        if model.actuator_actadr[u] >= 0:
            scatter[int(model.actuator_actadr[u]), u] = 1.0
    return joint_sel, tendon_rows, scatter


def _moment(model: Model, data: Data) -> torch.Tensor:
    """Dense actuator moment matrix (E, nu, nv)."""
    joint_sel, tendon_rows, _ = (
        static_tensor(model, f"actuator_{n}", lambda i=i: _tables(model)[i])
        for i, n in enumerate(("joint_sel", "tendon_rows", "scatter")))
    gear0 = model.actuator_gear[..., 0, None]
    moment = (joint_sel * gear0).expand(data.qvel.shape[0], -1, -1)
    if model.ntendon:
        moment = moment + (tendon_rows @ data.ten_J) * gear0
    return moment


def _mask(values, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values), device=dev)


def actuation(model: Model, data: Data) -> Data:
    """Transmission lengths/velocities, act_dot, forces, qfrc_actuator."""
    if model.nu == 0:
        return data.replace(qfrc_actuator=torch.zeros_like(data.qvel))
    dev = data.qpos.device
    gear0 = model.actuator_gear[..., 0]
    trn = model.actuator_trntype
    is_joint = _mask(np.isin(trn, [int(TrnType.JOINT),
                                   int(TrnType.JOINTINPARENT)]), dev)
    jnt_q = model.jnt_qposadr[np.clip(model.actuator_trnid[:, 0], 0,
                                      model.njnt - 1)]
    length = data.qpos[:, jnt_q] * gear0
    if model.ntendon:
        tid = np.where(trn == int(TrnType.TENDON), model.actuator_trnid[:, 0],
                       0)
        length = torch.where(is_joint, length, data.ten_length[:, tid] * gear0)
    moment = _moment(model, data)
    velocity = torch.einsum("euv,ev->eu", moment, data.qvel)

    ctrl = data.ctrl
    if not (model.opt.disableflags & DisableBit.CLAMPCTRL):
        lo, hi = (model.actuator_ctrlrange[..., 0],
                  model.actuator_ctrlrange[..., 1])
        ctrl = torch.where(_mask(model.actuator_ctrllimited.astype(bool), dev),
                           torch.minimum(torch.maximum(ctrl, lo), hi), ctrl)

    dyn = model.actuator_dyntype
    if model.na:
        scatter = static_tensor(model, "actuator_scatter",
                                lambda: _tables(model)[2])
        act_u = data.act[:, np.where(model.actuator_actadr >= 0,
                                     model.actuator_actadr, 0)]
        dyn_muscle = _mask(dyn == int(DynType.MUSCLE), dev)
        dyn_filter = _mask(np.isin(dyn, [int(DynType.FILTER),
                                         int(DynType.FILTEREXACT)]), dev)
        tau = torch.clamp(model.actuator_dynprm[..., 0], min=1e-15)
        act_dot_u = torch.where(
            dyn_muscle, muscle_dynamics(ctrl, act_u, model.actuator_dynprm),
            torch.where(dyn_filter, (ctrl - act_u) / tau,
                        torch.zeros_like(ctrl)))
        act_dot = act_dot_u @ scatter.T
        force_input = torch.where(_mask(dyn != int(DynType.NONE), dev),
                                  act_u, ctrl)
    else:
        act_dot = torch.zeros_like(data.act)
        force_input = ctrl

    gp, bp = model.actuator_gainprm, model.actuator_biasprm
    gt, bt = model.actuator_gaintype, model.actuator_biastype
    gain = gp[..., 0].expand_as(ctrl)
    bias = torch.zeros_like(ctrl)
    if np.any(gt == int(GainType.AFFINE)):
        gain = torch.where(_mask(gt == int(GainType.AFFINE), dev),
                           gp[..., 0] + gp[..., 1] * length
                           + gp[..., 2] * velocity,
                           gain)
    if np.any(bt == int(BiasType.AFFINE)):
        bias = torch.where(_mask(bt == int(BiasType.AFFINE), dev),
                           bp[..., 0] + bp[..., 1] * length
                           + bp[..., 2] * velocity,
                           bias)
    if np.any(gt == int(GainType.MUSCLE)):
        gain = torch.where(
            _mask(gt == int(GainType.MUSCLE), dev),
            muscle_gain(length, velocity, model.actuator_lengthrange,
                        model.actuator_acc0, gp), gain)
    if np.any(bt == int(BiasType.MUSCLE)):
        bias = torch.where(
            _mask(bt == int(BiasType.MUSCLE), dev),
            muscle_bias(length, model.actuator_lengthrange,
                        model.actuator_acc0, bp), bias)
    force = gain * force_input + bias
    lo, hi = (model.actuator_forcerange[..., 0],
              model.actuator_forcerange[..., 1])
    force = torch.where(
        _mask(model.actuator_forcelimited.astype(bool), dev),
        torch.minimum(torch.maximum(force, lo), hi), force)
    if model.opt.disableflags & DisableBit.ACTUATION:
        force = torch.zeros_like(force)
        act_dot = torch.zeros_like(act_dot)
    return data.replace(
        actuator_length=length, actuator_velocity=velocity,
        actuator_force=force, act_dot=act_dot,
        qfrc_actuator=torch.einsum("euv,eu->ev", moment, force))
