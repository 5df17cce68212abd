"""The batched Newton constraint solve on the card.

Counterpart of `loco_mujoco_tpu/ops/pallas_newton.py` (`solve_core` with
`chol_solve_spd`, reached through `_make_kernel` / `_solve_batched` /
`get_solver`); the kernel is `csrc/newton.cu`, one warp per env on the
warp solve the mega and fused kernels run (`csrc/warp_core.cuh`). It runs
`solver.solve`'s fast path for rows in the static class order equality,
friction loss, then one-sided rows (limits and pyramidal contact facets):
the cost-based warm-start select, `iterations` Newton steps (Hessian
M + J'diag(w)J, Cholesky, a safeguarded-secant line search of
`ls_iterations` steps) and MuJoCo's per-env termination.

`solve` takes env-major operands, J (E, nefc, nv), M (E, nv, nv), rows
(E, nefc), vectors (E, nv), like `_solve_batched`, and returns qacc
(E, nv), the row forces (E, nefc), the iterations each env ran (E,) and
which of them took their step (bit i of an int32 per env, (E,)); its
`record`, a dict, receives the line search's decisions (`ls`, (E,
LS_WORDS)) and each step's Hessian decisions of the rows (`rows`, (E,
iterations, row_words)), which the kernel records too. On a CUDA tensor
it launches the kernel (float32 only) on the operands as they are, each
env's state in a shared region laid out by `plan.solve_launch`, or
raises; the kernel is compiled at two nv widths (`kernels.NV_WIDTHS`, 24
and 32, a library each); a larger nv raises. On a CPU tensor it runs the
plain version, `newton_plain`, a port of the XLA fast path
(solver.py:217-383) in PyTorch, which is also the float64 path.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels, linalg
from .kernels import FLOAT, INT, PTR
from .plan import solve_launch

MINVAL = 1e-15
LS_WORDS = 4  # line-search decision words (csrc/newton_core.cuh kLsWords)

_SIGNATURES = {
    "lmt_newton_solve": [PTR] * 16 + [INT] * 9 + [FLOAT, FLOAT, PTR],
    "lmt_newton_occupancy": [INT, INT, PTR],
}


def row_class_counts(is_bilateral, is_fl):
    """(ne, nfl) of the static row program, or None unless the rows are the
    contiguous (equality, friction loss, rest) blocks the solve relies on."""
    eq = np.asarray(is_bilateral, dtype=bool)
    fl = np.asarray(is_fl, dtype=bool)
    ne, nfl = int(eq.sum()), int(fl.sum())
    if not (np.all(eq[:ne]) and not np.any(eq[ne:])):
        return None
    if not (np.all(fl[ne:ne + nfl]) and not np.any(fl[:ne])
            and not np.any(fl[ne + nfl:])):
        return None
    return ne, nfl


def _row_classes(nefc, ne, nfl, device):
    rows = torch.arange(nefc, device=device)
    return rows < ne, (rows >= ne) & (rows < ne + nfl)


def _quantities(jar, D, R, floss, on, is_eq, is_fl, ell=None, hess=None):
    """Per-row force and Hessian weight, the total row cost (E,), the cone
    zones' data for the Hessian (`cone_terms`, with `ell`, the elliptic
    contacts of `ell_tables`) and the rows' Hessian decisions (E, nefc)
    bool (`row_bits`' meaning). `hess`, such decisions of another solve,
    replaces this one's: a friction-loss row's quadratic zone, a one-sided
    row's sign and an elliptic contact's zone."""
    zero = torch.zeros((), dtype=jar.dtype, device=jar.device)
    rf = R * floss
    in_quad = jar.abs() <= rf
    neg = jar < 0
    if hess is not None:
        in_quad, neg = hess, hess
    if ell is not None:  # elliptic rows take no one-sided term
        neg = neg & ~ell[3]
    f = torch.where(is_eq, -D * jar, torch.where(
        is_fl, torch.minimum(torch.maximum(-D * jar, -floss), floss),
        torch.where(neg, -D * jar, zero)))
    w = torch.where(is_eq, D, torch.where(
        is_fl, torch.where(in_quad, D, zero), torch.where(neg, D, zero)))
    quad = 0.5 * D * jar * jar
    c = torch.where(is_eq, quad, torch.where(
        is_fl, torch.where(in_quad, quad, floss * jar.abs() - 0.5 * rf * floss),
        torch.where(neg, quad, zero)))
    f, w = torch.where(on, f, zero), torch.where(on, w, zero)
    cost = torch.where(on, c, zero).sum(-1)
    bits = on & (is_eq | torch.where(is_fl, in_quad, neg))
    if ell is None:
        return f, w, cost, None, bits
    zones = None if hess is None else (hess[:, ell[0][:, 0]],
                                       hess[:, ell[0][:, 1]])
    fe, we, ce, cone, (mid, bottom) = _cone_zones(jar, D, on, ell, zones)
    flat = ell[0].reshape(-1)
    f = f.index_add(1, flat, fe.reshape(f.shape[0], -1))
    w = w.index_add(1, flat, we.reshape(w.shape[0], -1))
    bits = bits.clone()
    bits[:, ell[0][:, 0]] = mid
    bits[:, ell[0][:, 1]] = bottom
    return f, w, cost + ce, cone, bits


def row_words(nefc: int) -> int:
    """int32 words of one solve step's row decisions (`row_bits`)."""
    return (nefc + 31) // 32


def row_bits(bits):
    """(E, nefc) bool Hessian decisions of one Newton step as (E,
    row_words) int32: bit r % 32 of word r // 32 is row r's. A scalar
    row's bit is set where it took its Hessian weight (an equality row
    always, a friction-loss row in its quadratic zone, a limit or
    pyramidal facet below zero); an elliptic contact's first row's bit is
    set in the middle zone and its second row's in the sticking zone. The
    kernels record the same bits (`csrc/warp_core.cuh` `newton`)."""
    E, n = bits.shape
    pad = torch.zeros((E, 32 * row_words(n)), dtype=torch.int64,
                      device=bits.device)
    pad[:, :n] = bits.to(torch.int64)
    w = (pad.reshape(E, -1, 32) << torch.arange(
        32, device=bits.device)).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def unpack_row_bits(words, nefc: int):
    """`row_bits`' inverse: (E, row_words) int32 -> (E, nefc) bool."""
    sh = torch.arange(32, device=words.device, dtype=torch.int32)
    b = (words[..., None] >> sh) & 1
    return b.reshape(words.shape[0], -1)[:, :nefc] == 1


def ell_tables(ell_start, ell_dim, con_mu, nrows, device):
    """(idx (n, maxdim), msk (n, maxdim) in con_mu's dtype, mu (E, n),
    is_ell (nrows,) bool) of the elliptic contacts of a row layout
    (`_ell_tables`): their rows, the normal row first; None without."""
    n = len(ell_start)
    if n == 0:
        return None
    maxd = int(max(ell_dim))
    idx = np.zeros((n, maxd), np.int64)
    msk = np.zeros((n, maxd), bool)
    for c in range(n):
        idx[c, :ell_dim[c]] = ell_start[c] + np.arange(ell_dim[c])
        msk[c, :ell_dim[c]] = True
    is_ell = np.zeros(nrows, bool)
    is_ell[idx[msk]] = True
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(msk, dtype=con_mu.dtype, device=device), con_mu,
            torch.as_tensor(is_ell, device=device))


def _cone_zones(jar, D, on, ell, zones=None):
    """The elliptic cone of each contact (solver._quantities, :102-161) in
    cone-scaled coordinates u_i = jar_i sqrt(D_i / D_n): separating (no
    force), sticking (quadratic in every row) or the middle zone (cost
    0.5 D_n / (1 + mu^2) (n - mu t)^2). Returns per-contact row forces and
    weights (E, n, maxdim), the cost (E,), the middle zone's Hessian
    data (g, w_gn, jt_scale, wdir, c2; _cone_hessian_terms :173-215) and
    the zones (middle, sticking) (E, n) bool; `zones`, another solve's,
    replaces them."""
    idx, msk, mu, _ = ell
    jar_c, d_c = jar[:, idx], D[:, idx]
    dn = d_c[..., 0]
    scale = torch.sqrt(d_c / torch.clamp(dn[..., None], min=MINVAL))
    u = jar_c * scale * msk
    n = u[..., 0]
    t = torch.sqrt(torch.sum(u[..., 1:] ** 2, dim=-1))
    t_safe = torch.clamp(t, min=MINVAL)
    con_on = on[:, idx[:, 0]]
    top = n >= mu * t
    bottom = (mu * n + t <= 0) & con_on
    mid = ~(top | bottom) & con_on
    if zones is not None:
        mid, bottom = zones[0] & con_on, zones[1] & con_on
    zero = torch.zeros((), dtype=jar.dtype, device=jar.device)
    f_bot = -d_c * jar_c * msk
    c_bot = 0.5 * torch.sum(d_c * jar_c * jar_c * msk, dim=-1)
    nmt = n - mu * t
    dm = dn / (1.0 + mu * mu)
    c_mid = 0.5 * dm * nmt * nmt
    wdir = torch.cat([torch.zeros_like(n)[..., None],
                      u[..., 1:] / t_safe[..., None]], dim=-1) * msk
    g = torch.cat([torch.ones_like(n)[..., None],
                   -mu[..., None] * u[..., 1:] / t_safe[..., None]],
                  dim=-1) * scale
    f_mid = (-dm * nmt)[..., None] * g * msk
    force = torch.where(mid[..., None], f_mid,
                        torch.where(bottom[..., None], f_bot, zero))
    cost = torch.where(mid, c_mid, torch.where(bottom, c_bot, zero)).sum(-1)
    w = torch.where(bottom[..., None], d_c * msk, zero)
    jt_scale = torch.cat([torch.zeros_like(n)[..., None], scale[..., 1:]],
                         dim=-1) * msk
    cone = (g * msk, torch.where(mid, dm, zero), jt_scale, wdir,
            torch.where(mid, dm * mu * (mu * t - n) / t_safe, zero))
    return force, w, cost, cone, (mid, bottom)


def cone_hessian(Jm, idx, cone):
    """The middle zone's Hessian terms of the elliptic contacts
    (solver.newton_direction :278-300): sum over contacts of
    w_gn Jg Jg' + c2 (sum_k Jt_k Jt_k' - Jq Jq'), Jg = sum_k g_k J_k,
    Jt_k = jt_scale_k J_k, Jq = sum_k wdir_k Jt_k. The curvature term is
    summed in Lagrange's form, sum_{k<l} v_kl v_kl' + (1 - |wdir|^2)
    sum_k Jt_k Jt_k' with v_kl = wdir_l Jt_k - wdir_k Jt_l: the same matrix
    (positive semidefinite), without the difference of two terms that grow
    as 1/t near the cone's apex and cancel in float32."""
    g, w_gn, jt_scale, wdir, c2 = cone
    Jc = Jm[:, idx]  # (E, n, maxdim, nv)
    Jg = torch.einsum("eck,eckv->ecv", g, Jc)
    H = torch.einsum("ec,ecv,ecw->evw", w_gn, Jg, Jg)
    Jt = Jc * jt_scale[..., None]
    rest = c2 * (1.0 - torch.sum(wdir * wdir, dim=-1))
    H = H + torch.einsum("ec,eckv,eckw->evw", rest, Jt, Jt)
    maxd = Jt.shape[2]
    for k in range(1, maxd):
        for l_ in range(k + 1, maxd):
            v = (wdir[..., l_, None] * Jt[:, :, k]
                 - wdir[..., k, None] * Jt[:, :, l_])
            H = H + torch.einsum("ec,ecv,ecw->evw", c2, v, v)
    return H


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def newton_cost(J, M, aref, D, R, floss, active, asm, x, *, ne, nfl,
                ell=None):
    """The objective the solve minimises, at x (E, nv): the constraint rows'
    cost plus 0.5 (x - asm)' M (x - asm)."""
    on = active > 0
    is_eq, is_fl = _row_classes(J.shape[1], ne, nfl, J.device)
    jar = _mv(J * on[..., None].to(J.dtype), x) - aref
    d = x - asm
    c = _quantities(jar, D, R, floss, on, is_eq, is_fl, ell)[2]
    return c + 0.5 * (d * _mv(M, d)).sum(-1)


def newton_plain(J, M, aref, D, R, floss, active, asm, ws, *, ne, nfl,
                 iterations, ls_iterations, scale, tol, replay=None,
                 ell=None, record=None):
    """Plain version of the kernel: the XLA fast path, batched over E.
    Returns qacc, forces, the Newton steps each env ran and its discrete
    decisions as an int32 per env: bit i, step i lowered the cost and was
    taken; bit 31, x started at the warm start.

    `replay` = (iters, taken) of another solve makes env e start where
    bit 31 of taken[e] says, run exactly iters[e] steps and take step i
    iff bit i is set, whatever its own cost tests say: the two solves then
    make the same discrete decisions and can be compared step for step;
    (iters, taken, ls), ls (E, LS_WORDS) int32, also replays the line
    search's sign tests (bit it * ls_iterations + j: phi' < 0 at trial j of
    step it); (iters, taken, ls, rows), rows (E, iterations, row_words)
    int32, also each step's Hessian decisions of every row (`row_bits`):
    the float32 tests of a row's sign, a friction-loss row's zone and an
    elliptic contact's zone, which two summation orders can decide apart
    where a row sits at its threshold.

    `record`, a dict, receives this solve's line-search and row decisions
    (`ls` (E, LS_WORDS), `rows` (E, iterations, row_words) int32, zero
    past each env's last step), the ones a kernel records (the replayed
    ones where `replay` gives them), and `own_rows`, the row decisions its
    own tests make at each step's x: where rows are replayed, the rows at
    which `own_rows` and `rows` differ are the replayed decisions the
    plain version would not have made.

    `ell` (`ell_tables`): the elliptic contacts' rows and cone
    coefficients; their rows take the cone zones' forces, weights and
    Hessian terms (solver.py:102-215, :278-300)."""
    E, nefc, nv = J.shape
    dt, dev = J.dtype, J.device
    on = active > 0
    Jm = J * on[..., None].to(dt)
    is_eq, is_fl = _row_classes(nefc, ne, nfl, dev)

    def quantities(jar):
        return _quantities(jar, D, R, floss, on, is_eq, is_fl, ell)

    def dot(a, b):
        return (a * b).sum(-1)

    def cost_at(x):
        return newton_cost(J, M, aref, D, R, floss, active, asm, x, ne=ne,
                           nfl=nfl, ell=ell)

    def falsi(lo, dlo, hi, dhi):
        denom = dhi - dlo
        a = torch.where(denom > MINVAL,
                        lo - dlo * (hi - lo) / torch.where(denom > MINVAL,
                                                           denom, 1.0),
                        0.5 * (lo + hi))
        return torch.minimum(torch.maximum(a, lo), hi)

    c_ws, c_sm = cost_at(ws), cost_at(asm)
    use_ws = c_ws < c_sm if replay is None else replay[1] < 0  # bit 31
    x = torch.where(use_ws[:, None], ws, asm)
    cost = torch.where(use_ws, c_ws, c_sm)
    done = (torch.zeros(E, dtype=torch.bool, device=dev) if replay is None
            else replay[0] <= 0)
    iters = torch.zeros(E, dtype=torch.int32, device=dev)
    taken = torch.where(use_ws, -2 ** 31, 0).to(torch.int32)
    eye = torch.eye(nv, dtype=dt, device=dev) * 1e-12
    rw = row_words(nefc)
    rows_rec = torch.zeros((E, iterations, rw), dtype=torch.int32,
                           device=dev)
    own_rec = torch.zeros_like(rows_rec)
    ls_rec = torch.zeros((E, LS_WORDS), dtype=torch.int64, device=dev)
    for it in range(iterations):
        running = ~done
        iters += running.to(torch.int32)
        jar = _mv(Jm, x) - aref
        hess = None
        if replay is not None and len(replay) > 3:
            hess = unpack_row_bits(replay[3][:, it], nefc)
        f, w, _, cone, bits = _quantities(jar, D, R, floss, on, is_eq, is_fl,
                                          ell, hess)
        own = (bits if hess is None or record is None
               else _quantities(jar, D, R, floss, on, is_eq, is_fl, ell)[4])
        rows_rec[:, it] = torch.where(running[:, None], row_bits(bits), 0)
        own_rec[:, it] = torch.where(running[:, None], row_bits(own), 0)
        mx = _mv(M, x - asm)
        grad = mx - _mv(Jm.transpose(1, 2), f)
        H = M + Jm.transpose(1, 2) @ (Jm * w[..., None])
        if cone is not None:
            H = H + cone_hessian(Jm, ell[0], cone)
        H = H + eye
        dx = -linalg.cho_solve(linalg.cholesky(H), grad)
        jv = _mv(Jm, dx)
        mdx = _mv(M, dx)
        g0, h0 = dot(dx, mx), dot(dx, mdx)
        lo = torch.zeros_like(g0)
        dlo = g0 - dot(f, jv)
        hi = torch.zeros_like(g0)
        dhi = torch.ones_like(g0)
        has_hi = torch.zeros_like(done)
        a = torch.ones_like(g0)
        for _ls in range(ls_iterations):
            fa = quantities(jar + a[:, None] * jv)[0]
            d = g0 + a * h0 - dot(fa, jv)
            neg = d < 0
            bit = it * ls_iterations + _ls
            if replay is not None and len(replay) > 2:
                neg = (replay[2][:, bit // 32] >> (bit % 32)) & 1 == 1
            if bit < 32 * LS_WORDS:
                ls_rec[:, bit // 32] |= (neg & running).to(
                    torch.int64) << (bit % 32)
            lo, dlo = torch.where(neg, a, lo), torch.where(neg, d, dlo)
            hi, dhi = torch.where(neg, hi, a), torch.where(neg, dhi, d)
            has_hi = has_hi | ~neg
            a = torch.where(has_hi, falsi(lo, dlo, hi, dhi), a * 2.0)
        alpha = torch.where(has_hi, falsi(lo, dlo, hi, dhi), lo)
        x_new = x + alpha[:, None] * dx
        c_new = quantities(jar + alpha[:, None] * jv)[2]
        new_cost = c_new + 0.5 * dot(x_new - asm, mx + alpha[:, None] * mdx)
        newly = ((cost - new_cost) / scale < tol) | (
            torch.linalg.norm(grad, dim=-1) / scale < tol)
        if replay is None:
            upd = ~done & (new_cost < cost)
        else:
            upd = ~done & ((replay[1] >> it) & 1 == 1)
        taken |= upd.to(torch.int32) << it
        x = torch.where(upd[:, None], x_new, x)
        cost = torch.where(upd, new_cost, cost)
        done = done | (newly if replay is None else iters >= replay[0])
    # the returned forces are D times J x - aref, a difference of nearly
    # equal terms on stiff rows: it is taken in float64 and rounded once
    # (as the kernels do)
    f = quantities((_mv(Jm.double(), x.double()) - aref.double()).to(dt))[0]
    if record is not None:
        record["ls"] = torch.where(ls_rec >= 2 ** 31, ls_rec - 2 ** 32,
                                   ls_rec).to(torch.int32)
        record["rows"] = rows_rec
        record["own_rows"] = own_rec
    return x, f, iters, taken


def library(nv: int):
    """The compiled Newton kernel of the narrowest width that holds nv;
    raises past the widest."""
    width = kernels.nv_width(nv)
    if width is None:
        raise NotImplementedError(
            f"the Newton kernel is compiled at nv widths "
            f"{kernels.NV_WIDTHS}: nv {nv} > {kernels.NV_WIDTHS[-1]} has "
            f"no compiled width")
    return kernels.library("newton", _SIGNATURES,
                           kernels.width_defines(width))


def occupancy(nv: int, nefc: int, ne: int, nfl: int) -> int:
    """Resident warps (envs) per SM of the kernel at this launch, from the
    CUDA runtime (needs the card)."""
    launch = solve_launch(nv, nefc, ne, nfl)
    out = (ctypes.c_int * 1)()
    kernels.check(library(nv).lmt_newton_occupancy(
        launch.env_floats, launch.envs_per_block, ctypes.addressof(out)),
        "newton occupancy")
    return out[0]


def solve(J, M, aref, D, R, floss, active, asm, ws, *, ne, nfl, iterations,
          ls_iterations, scale, tol, ell=None, record=None):
    """Batched Newton solve (see the module note). `active` is the rows'
    0/1 flag in J's dtype; `floss` holds the friction-loss bounds of the
    friction rows (the kernel reads rows ne..ne+nfl only). Elliptic rows
    (`ell`) have no kernel here: the reference keeps its XLA solve for them
    (solver.py:263), so a CUDA tensor with `ell` raises. `record`: as in
    `newton_plain` (the kernel fills `ls` and `rows`)."""
    if not J.is_cuda:
        return newton_plain(J, M, aref, D, R, floss, active, asm, ws, ne=ne,
                            nfl=nfl, iterations=iterations,
                            ls_iterations=ls_iterations, scale=scale, tol=tol,
                            ell=ell, record=record)
    if ell is not None:
        raise NotImplementedError(
            "the standalone Newton kernel has no elliptic cone zones; an "
            "elliptic model runs the fused or mega kernels (a row plan)")
    E, nefc, nv = J.shape
    lib = library(nv)
    for name, t, shape in (("J", J, (E, nefc, nv)), ("M", M, (E, nv, nv)),
                           ("aref", aref, (E, nefc)), ("D", D, (E, nefc)),
                           ("R", R, (E, nefc)), ("floss", floss, (E, nefc)),
                           ("active", active, (E, nefc)),
                           ("qacc_smooth", asm, (E, nv)),
                           ("qacc_warmstart", ws, (E, nv))):
        kernels.require(t, name, shape)
    launch = solve_launch(nv, nefc, ne, nfl)
    dev = J.device
    x = torch.empty((E, nv), dtype=torch.float32, device=dev)
    f = torch.empty((E, nefc), dtype=torch.float32, device=dev)
    iters = torch.empty(E, dtype=torch.int32, device=dev)
    taken = torch.empty(E, dtype=torch.int32, device=dev)
    ls = torch.empty((E, LS_WORDS), dtype=torch.int32, device=dev)
    rows = torch.empty((E, iterations, row_words(nefc)), dtype=torch.int32,
                       device=dev)
    shm = launch.tensor(dev)
    p = kernels.ptr
    rc = lib.lmt_newton_solve(
        p(J), p(M), p(aref), p(D), p(R), p(floss), p(active), p(asm), p(ws),
        p(x), p(f), p(iters), p(taken), p(ls), p(rows), p(shm), E, nv, nefc,
        ne, nfl, iterations, ls_iterations, launch.env_floats,
        launch.envs_per_block, float(scale), float(tol), kernels.stream())
    kernels.check(rc, "newton")
    kernels.LAUNCHES["newton"] += 1
    if record is not None:
        record["ls"], record["rows"] = ls, rows
    return x, f, iters, taken
