"""Newton constraint solver: the batched fast path.

Counterpart of `loco_mujoco_tpu/ops/solver.py`'s fast path (solver.py:217-
383), the one the env layer's budget selects (iterations <= 16,
ls_iterations <= 8): warm-start select, a fixed budget of Newton steps with
an unrolled safeguarded-secant line search, per-env MuJoCo termination, the
float32 floor of the tolerance, and the elliptic cones' zones and Hessian
terms (`:102-215`, `:278-300`). The reference's line-search floors,
ls_atol and ls_step_tol, belong to its convergent path, which the batched
budget never takes. The solve itself runs in `hopper_newton` (the Hopper
kernel on the card, its plain version on the CPU; elliptic rows have no
standalone kernel, as in the reference); this module sets it up and writes
the solution back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import Data, Model
from . import hopper_newton as hn
from .constraint import Efc


def newton_inputs(model: Model, data: Data, efc: Efc):
    """(operands, options) of the Newton solve of the rows `efc`."""
    opt = model.opt
    if not (opt.iterations <= 16 and opt.ls_iterations <= 8):
        raise NotImplementedError(
            "only the batched fast path (iterations <= 16, ls_iterations <= 8)"
            " is ported")
    counts = hn.row_class_counts(efc.is_bilateral, efc.is_fl)
    if counts is None:
        raise NotImplementedError("constraint rows out of the staged order")
    dt = data.qpos.dtype
    # MuJoCo's default tolerances are out of reach in float32
    tol = max(opt.tolerance, 1e-6 if dt == torch.float32 else 0.0)
    operands = (efc.J, data.qM, efc.aref, efc.D, efc.R, efc.floss,
                efc.active.to(dt), data.qacc_smooth, data.qacc_warmstart)
    options = dict(ne=counts[0], nfl=counts[1], iterations=opt.iterations,
                   ls_iterations=opt.ls_iterations,
                   scale=model.stat_meaninertia * max(1, model.nv), tol=tol,
                   ell=hn.ell_tables(efc.ell_start, efc.ell_dim, efc.con_mu,
                                     efc.J.shape[1], efc.J.device))
    return operands, options


def solve(model: Model, data: Data, efc: Efc, plain: bool = False) -> Data:
    """qacc and constraint forces of the rows `efc`. plain=True runs the
    kernel's plain version on any device (the reference it is held to)."""
    if efc.J.shape[1] == 0:
        zero = torch.zeros_like(data.solver_niter)
        return data.replace(qacc=data.qacc_smooth,
                            qfrc_constraint=torch.zeros_like(data.qfrc_smooth),
                            solver_niter=zero, solver_taken=zero,
                            solver_ls=torch.zeros_like(data.solver_ls))
    operands, options = newton_inputs(model, data, efc)
    fn = hn.newton_plain if plain else hn.solve
    x, force, niter, taken = fn(*operands, **options)
    return _finish(data, efc, x, force).replace(
        solver_niter=niter, solver_taken=taken,
        solver_ls=torch.zeros_like(data.solver_ls))


def _finish(data: Data, efc: Efc, x, force) -> Data:
    """qacc, qfrc_constraint = J'f, and the per-contact force rows."""
    Jm = efc.J * efc.active[..., None].to(efc.J.dtype)
    qfrc = torch.einsum("erv,er->ev", Jm, force)
    nc = len(efc.con_efcadr)
    maxd = data.efc_force_contact.shape[2]
    rowidx = np.zeros((nc, maxd), dtype=np.int64)
    rowmsk = np.zeros((nc, maxd), dtype=bool)
    for c in range(nc):
        adr, dim = int(efc.con_efcadr[c]), int(efc.con_dim[c])
        if adr < 0:
            continue
        nrow = dim if efc.type[adr] in (5, 7) else 2 * (dim - 1)
        nrow = min(nrow, maxd)
        rowidx[c, :nrow] = adr + np.arange(nrow)
        rowmsk[c, :nrow] = True
    dev = force.device
    fc = force[:, torch.as_tensor(rowidx, device=dev)]
    fc = torch.where(torch.as_tensor(rowmsk, device=dev), fc,
                     torch.zeros_like(fc))
    return data.replace(qacc=x, qfrc_constraint=qfrc, efc_force_contact=fc)
