#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

Run from the repository root: `python3 chip_smoke.py`. It

1. prints the card and its power limit (nvidia-smi);
2. builds the Hopper kernels from `loco_mujoco_tpu_torch/csrc/*.cu`;
3. holds each kernel of the staged path against its plain PyTorch version
   on the card, on the inputs that path gives it at full width (4096 envs
   of the committed HumanoidTorque-shaped model: nv = 19, 75 plane-mesh
   pairs);
4. drives the staged path (`LMT_MEGA=0`, the earlier slice's path) for 2
   control steps of 10 RK4 substeps, with every launch counter set to 0
   just before and read just after, and checks the counts; then compares
   one staged forward with the all-plain forward;
5. drives the main path, as `bench.py` does: one forward at reset (the
   mega forward kernel) and `forward.step_n` for 20 control steps of 10
   RK4 substeps (one megastep kernel launch each), counters again zeroed
   just before and read just after, and checks the state, the contacts
   and that exactly these launches were made;
6. holds the mega forward kernel and the megastep kernel (one control
   step) to their plain versions replaying the kernels' Newton decisions,
   on all 4096 envs;
7. times each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, beside the least time the card
   could take (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s,
   the H100 SXM data-sheet peaks at 700 W);
8. prints one JSON line of kernels and, last, one JSON line with `"ok"`.

It exits non-zero, printing no result, when no CUDA device is present or
the port is missing. Every float32 matmul and convolution runs in full
float32: TF32 is switched off, as the JAX package scopes its physics to
exact float32 (`_exact_f32`, loco_mujoco_tpu/ops/forward.py) because the
constraint Hessian can go indefinite at lower precision.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

N_ENVS = 4096
CONTROL_STEPS = 20  # the main path
STAGED_STEPS = 2  # the staged path, cut from 20 to keep the run short
SUBSTEPS = 10  # RK4 substeps per control step; 4 forwards each
TIE = 1e-5  # a slot this close to its margin is a float32 tie
SEED = 0
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BIG = 1e10


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps=10):
    """Mean CUDA-event time of `fn()` over `reps` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _select_flops(torch, plan, a, b, dist):
    """Operations the select does on these inputs: the extent bound for
    every (pair, env), V height evaluations where the bound reaches the
    margin, and D neighbour tests where the support depth does."""
    dev = a.device
    mg = plan.tensors(dev).pair_f
    V = torch.as_tensor(plan.pair_i[:, 1], device=dev)[:, None]
    D = torch.as_tensor(plan.pair_i[:, 2], device=dev)[:, None]
    lb = b - 1e-6
    for i in range(3):
        lb = lb + torch.minimum(a[:, i] * mg[:, 2 + i, None],
                                a[:, i] * mg[:, 5 + i, None])
    near = lb < mg[:, 0:1]
    man = near & (dist[:, 0] < mg[:, 0:1])
    return int((13 + near * (V * 7) + man * (D * 20)).sum())


def _active_close(got, ref, active, atol, what):
    err = float((got - ref).abs()[active].max()) if bool(active.any()) else 0.0
    if not err <= atol:
        raise AssertionError(f"{what}: max abs error {err} > {atol}")
    return err


@contextlib.contextmanager
def _staged_path():
    """The staged path: the mega path off (`LMT_MEGA=0`)."""
    old = os.environ.get("LMT_MEGA")
    os.environ["LMT_MEGA"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["LMT_MEGA"]
        else:
            os.environ["LMT_MEGA"] = old


def _margin_gap(d):
    """Per env, the smallest |dist - margin| over the contact slots."""
    return (d.contact.dist - d.contact.includemargin).abs().min(dim=1).values


def _tie_envs(torch, held, gap, E, what):
    """Envs where the comparison does not hold are excluded only where a
    slot lies within TIE of its margin (a float32 tie flips the active
    set), and only up to 0.5% of the envs. Returns their count."""
    out = ~held
    n = int(out.sum())
    if n and not bool((gap[out] < TIE).all()):
        raise AssertionError(f"{what}: {int((out & (gap >= TIE)).sum())} "
                             f"envs differ with no slot within {TIE} of "
                             f"its margin")
    if n > 0.005 * E:
        raise AssertionError(f"{what}: {n} tie envs, more than 0.5%")
    return n


def _forward_flops(torch, model, d, iters):
    """Float operations of one mega forward per env (multiply-add = 2),
    reckoned from csrc/mega.cu on this state: `d` is the staged forward's
    Data at the same state (contacts, geom poses), `iters` the Newton
    steps each env ran. The data-dependent parts are counted from the
    data: the near plane-mesh pairs' height maps, the selected pairs'
    neighbour walks, the active constraint rows and the Newton
    iterations; the rest is per-env arithmetic of fixed size."""
    from loco_mujoco_tpu_torch.ops import collision as coll

    plan = model.mega
    nv, nb = model.nv, model.nbody
    mesh = next(g for g in plan.groups if g["kind"] == "mesh")
    mk = mesh["mesh"]
    dev = d.qpos.device
    a, b, _, _ = coll.mesh_kernel_inputs(mk, d)  # (E, P, 3), (E, P)
    pf = torch.as_tensor(mk.pair_f, device=dev)
    lb = b - 1e-6
    for i in range(3):
        lb = lb + torch.minimum(a[..., i] * pf[:, 2 + i],
                                a[..., i] * pf[:, 5 + i])
    V = torch.as_tensor(mk.pair_i[:, 1], device=dev, dtype=torch.float64)
    D = float(mk.pair_i[:, 2].max())
    near = ((lb < pf[:, 0]).double() * V).sum(dim=1) * 7  # height maps
    act = d.contact.dist < d.contact.includemargin  # (E, ncon)
    o = mesh["offset"]
    sel = act[:, o:o + 3 * mesh["k"]:3].sum(dim=1).double()  # slot 0s
    n_con = act.sum(dim=1).double()
    lim = torch.zeros_like(n_con)
    for r in plan.lim:
        x = d.qpos[:, r["q"]]
        lim += (torch.minimum(x - r["lo"], r["hi"] - x)
                < r["margin"]).double()
    A = plan.ne + plan.nfl + lim + 4 * n_con  # active rows
    fixed = (nb * 300 + model.njnt * 160 + nv * 36 + 6 * nv * (nv + 1)
             + 2 * nv ** 3 / 3 + nb * nv * 18 + nv * nv * 6 + nb * 130
             + 20 * nv + 360 * len(next((g["pairs"] for g in plan.groups
                                         if g["kind"] == "box"), []))
             + 121 * mk.P + mesh["k"] * mk.P)
    rows = (plan.ne + plan.nfl) * (4 * nv + 40) + lim * (2 * nv + 40) \
        + n_con * (43 * nv + 60) + sel * (23 * D + 166)
    ls = plan.ls_iterations
    per_iter = (4 * nv * nv + nv * nv / 2 + 2 * nv ** 3 / 3 + 4 * nv * nv
                + 12 * nv + A * (6 * nv + nv * (nv + 1) + 14 + 8 * ls + 8))
    newton = (2 * (A * (2 * nv + 6) + 2 * nv * nv + 4 * nv)
              + iters.double() * per_iter + A * (4 * nv + 6))
    return fixed + near + rows + newton


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the GPU", file=sys.stderr)
        return 2
    from loco_mujoco_tpu_torch.core import io
    from loco_mujoco_tpu_torch.ops import collision as coll
    from loco_mujoco_tpu_torch.ops import constraint as con
    from loco_mujoco_tpu_torch.ops import forward as fwd
    from loco_mujoco_tpu_torch.ops import hopper_collision as hc
    from loco_mujoco_tpu_torch.ops import hopper_layout as lay
    from loco_mujoco_tpu_torch.ops import hopper_mega as hm
    from loco_mujoco_tpu_torch.ops import hopper_newton as hn
    from loco_mujoco_tpu_torch.ops import kernels, solver

    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")
    print(f"nvidia-smi: {card}")

    # ---- build -------------------------------------------------------------
    build_s = kernels.build_all()
    print(f"kernel build: {build_s:.1f} s ({', '.join(kernels.SOURCES)})")
    for name in kernels.SOURCES:
        log = (kernels.build_dir() / f"{name}.ptxas")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

    # ---- model and state ---------------------------------------------------
    root = Path(__file__).resolve().parent
    model = io.load_model_npz(
        root / "loco_mujoco_tpu_torch/assets/humanoid_torque_shape.npz",
        device=dev, dtype=torch.float32)
    mesh_groups = [i for i, g in enumerate(model.groups)
                   if coll.is_plane_mesh(g)]
    assert mesh_groups and all(model.mesh_kernel[i] is not None
                               for i in mesh_groups), "mesh group off kernel"
    assert model.mega is not None, "the model has no mega plan"
    plan = model.mesh_kernel[mesh_groups[0]]
    print(f"model: nv={model.nv}, groups "
          f"{[(g.t2, g.k, len(g.pair_ids)) for g in model.groups]}, "
          f"ncon={model.ncon}; mesh group on the kernels: {plan.P} pairs, "
          f"k={plan.k}, {len(plan.buckets)} vertex buckets; mega plan "
          f"{model.mega.nrows} rows")

    rng = np.random.default_rng(SEED)
    E = N_ENVS
    qpos = model.qpos0.cpu().numpy()[None] + rng.normal(
        scale=0.02, size=(E, model.nq))
    z = int(model.jnt_qposadr[model.names["joint"]["root_z"]])
    qpos[:, z] -= rng.uniform(0.005, 0.02, size=E)  # feet and hulls touch
    data = io.make_data(model, E).replace(
        qpos=torch.as_tensor(qpos, dtype=torch.float32, device=dev))
    ctrls = rng.uniform(-0.3, 0.3, size=(CONTROL_STEPS, E, model.nu))

    def ctrl(c):
        return torch.as_tensor(ctrls[c], dtype=torch.float32, device=dev)

    # ---- each kernel against its plain version, at full width --------------
    d_pos = fwd.fwd_position(model, data, plain=True)
    a, b, gxp, gxm = coll.mesh_kernel_inputs(plan, d_pos)
    a_t, b_t = lay.moveaxis0_last_plain(a), lay.moveaxis0_last_plain(b)
    gxp_t, gxm_t = lay.moveaxis0_last_plain(gxp), lay.moveaxis0_last_plain(gxm)

    errs = {}
    for role, fn, x in (("moveaxis0_last", lay.moveaxis0_last, a),
                        ("moveaxis_last0", lay.moveaxis_last0, a_t),
                        ("to_grouped", lay.to_grouped, a.reshape(E, -1)),
                        ("from_grouped", lay.from_grouped, a_t.reshape(-1, E))):
        ref = (lay.moveaxis_last0_plain(x) if role == "moveaxis_last0"
               else lay.moveaxis0_last_plain(x))
        assert torch.equal(fn(x), ref), f"{role} not bit-exact"
        errs[role] = 0.0

    dist_k, vsel_k = hc.plane_mesh_select(plan, a_t, b_t)
    dist_p, vsel_p = hc.select_plain(plan, a_t, b_t)
    margin = torch.as_tensor(plan.pair_f[:, 0], device=dev)[:, None, None]
    act_p = dist_p < margin
    assert torch.equal(dist_k < margin, act_p), "select: active mask differs"
    e_sel = _active_close(dist_k, dist_p, act_p, 1e-6, "select dist")
    act9 = act_p.repeat_interleave(3, dim=1)
    e_sel = max(e_sel, _active_close(vsel_k, vsel_p, act9, 1e-5, "select vsel"))
    errs["plane_mesh_select"] = e_sel

    out_k = hc.group_topk(plan, dist_p, vsel_p, gxp_t, gxm_t)
    out_p = hc.group_topk_plain(plan, dist_p, vsel_p, gxp_t, gxm_t)
    act_s = out_p[0] < BIG / 2  # active slot rows (k, 3, E)
    assert torch.equal(out_k[0] < BIG / 2, act_s), "top-K: active differs"
    slot_on = act_s[:, 0:1]  # pair selected with key < 0
    geo = slot_on.expand(-1, 2, -1)
    assert torch.equal(out_k[3][:, :2][geo], out_p[3][:, :2][geo]), "geom ids"
    e_top = _active_close(out_k[0], out_p[0], act_s, 1e-6, "top-K dist")
    e_top = max(e_top, _active_close(
        out_k[1], out_p[1], act_s.repeat_interleave(3, dim=1), 1e-5,
        "top-K pos"))
    e_top = max(e_top, _active_close(
        out_k[2], out_p[2], slot_on.expand(-1, 9, -1), 1e-6, "top-K frame"))
    errs["group_topk"] = e_top
    n_active = int(act_s.sum())
    print(f"kernel checks: relayout bit-exact; select active slots "
          f"{int(act_p.sum())}, max err {e_sel:.3g}; top-K active slots "
          f"{n_active}, max err {e_top:.3g}")

    d_acc = fwd.fwd_acceleration(model, fwd.fwd_actuation(
        model, fwd.fwd_velocity(model, d_pos)))
    efc = con.make_constraint(model, d_acc)
    operands, options = solver.newton_inputs(model, d_acc, efc)
    # The float32 termination test compares a cost improvement with a floor
    # of 1e-6 * scale, below the rounding of costs that reach 1e5 in deep
    # contact, so two float32 orders of summation can stop an env one Newton
    # step apart. The plain version therefore replays the kernel's discrete
    # decisions (`replay`: warm start, iteration count, steps taken), and
    # the two are held step for step on every env: qacc and row forces
    # within rel 5e-4 of their largest value.
    x_k, f_k, it_k, tk_k = hn.solve(*operands, **options)
    x_p, f_p, _, _ = hn.newton_plain(*operands, **options,
                                     replay=(it_k, tk_k))
    it_own, tk_own = hn.newton_plain(*operands, **options)[2:]
    e_x = float((x_k - x_p).abs().max())
    e_f = float((f_k - f_p).abs().max())
    sx = float(x_p.abs().max()) + 1e-9
    sf = float(f_p.abs().max()) + 1e-9
    print(f"newton: nefc={efc.J.shape[1]}; kernel iterations mean "
          f"{float(it_k.float().mean()):.2f}, decisions replayed by the plain "
          f"version; "
          f"all {E} envs: qacc err {e_x:.3g} (rel {e_x / sx:.3g}), force err "
          f"{e_f:.3g} (rel {e_f / sf:.3g}); the plain version's own "
          f"decisions agree in "
          f"{int(((it_own == it_k) & (tk_own == tk_k)).sum())}/{E} envs")
    assert e_x / sx < 5e-4 and e_f / sf < 5e-4, (e_x, sx, e_f, sf)
    errs["newton"] = e_x

    # ---- the staged path (the earlier slice's) --------------------------
    with _staged_path():
        kernels.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = data
        for c in range(STAGED_STEPS):
            d = d.replace(ctrl=ctrl(c))
            for _ in range(SUBSTEPS):
                d = fwd.step(model, d)
        torch.cuda.synchronize()
        wall_staged = time.perf_counter() - t0
        staged_launches = dict(kernels.LAUNCHES)
        forwards = 4 * SUBSTEPS * STAGED_STEPS
        nfl = options["nfl"]
        per_fwd = {"newton": 1, "to_grouped": 8 + (1 if nfl else 0),
                   "from_grouped": 2,
                   "plane_mesh_select": len(mesh_groups),
                   "group_topk": len(mesh_groups),
                   "moveaxis0_last": 4 * len(mesh_groups),
                   "moveaxis_last0": 4 * len(mesh_groups)}
        assert staged_launches == {k: n * forwards
                                   for k, n in per_fwd.items()}, \
            staged_launches
        assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
        n_con = int((d.contact.dist < d.contact.includemargin).sum())
        assert n_con > 0, "no active contacts"
        staged_rate = E * STAGED_STEPS / wall_staged
        print(f"staged path (LMT_MEGA=0): {STAGED_STEPS} control steps x "
              f"{SUBSTEPS} RK4 substeps, {E} envs in {wall_staged:.2f} s = "
              f"{staged_rate:.0f} env-steps/s ({card}); active contacts "
              f"{n_con}; launches per control step "
              f"{ {k: v // STAGED_STEPS for k, v in sorted(staged_launches.items())} }")

        # one staged forward against the all-plain forward
        f_kern = fwd.forward(model, d)
        f_plain = fwd.forward(model, d, plain=True)
        same = (f_kern.solver_niter == f_plain.solver_niter) & torch.all(
            (f_kern.contact.dist < f_kern.contact.includemargin)
            == (f_plain.contact.dist < f_plain.contact.includemargin), dim=1)
        diff = (f_kern.qacc - f_plain.qacc).abs()
        # the all-plain forward runs its own termination (see the Newton
        # check above): compare the envs that stop at the same count, at
        # least 30%
        assert same.float().mean() >= 0.3, int(same.sum())
        e_fwd = float(diff[same].max())
        s_fwd = float(f_plain.qacc.abs().max()) + 1e-9
        assert e_fwd / s_fwd < 5e-4, (e_fwd, s_fwd)
        print(f"staged forward vs all-plain forward: {int(same.sum())}/{E} "
              f"envs with the same contact set and Newton iterations, there "
              f"qacc max err {e_fwd:.3g} (rel {e_fwd / s_fwd:.3g}); all envs "
              f"{float(diff.max()):.3g}")
    d_staged = d

    # ---- the main path: reset forward, then step_n per control step -----
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = fwd.forward(model, data)  # the env reset's forward
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for c in range(CONTROL_STEPS):
        d = fwd.step_n(model, d.replace(ctrl=ctrl(c)), SUBSTEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    assert launches == {"mega_forward": 1, "megastep": CONTROL_STEPS}, \
        launches
    assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
    assert torch.allclose(d.time, data.time + CONTROL_STEPS * SUBSTEPS
                          * model.opt.timestep)
    f_end = fwd.forward(model, d)
    n_con = int((f_end.contact.dist < f_end.contact.includemargin).sum())
    assert n_con > 0, "no active contacts"
    env_steps = E * CONTROL_STEPS / wall
    print(f"main path: reset forward {1e3 * (t1 - t0):.2f} ms, then "
          f"{CONTROL_STEPS} control steps x {SUBSTEPS} RK4 substeps, {E} envs "
          f"in {wall:.3f} s = {env_steps:.0f} env-steps/s ({card}); active "
          f"contacts at the end {n_con} ({n_con / E:.2f} per env); launches "
          f"{launches}")

    # ---- the mega forward against its plain version ---------------------
    # From the main path's end state S. The plain version replays the
    # kernel's Newton decisions (see the Newton check above); envs whose
    # active contact set differs may be float32 ties only (_tie_envs).
    S = d
    k = fwd.forward(model, S)
    r = hm.mega_forward_plain(model, S, replay=(k.solver_niter,
                                                k.solver_taken))
    act_k = k.contact.dist < k.contact.includemargin
    act_r = r.contact.dist < r.contact.includemargin
    same = torch.all(act_k == act_r, dim=1)
    gap = torch.minimum(_margin_gap(k), _margin_gap(r))
    ties_fwd = _tie_envs(torch, same, gap, E, "mega forward")
    e_mega = 0.0
    msg = []
    for name in ("qacc", "qfrc_constraint", "efc_force_contact"):
        got, ref = getattr(k, name)[same], getattr(r, name)[same]
        err, scl = float((got - ref).abs().max()), float(ref.abs().max())
        assert err <= 5e-4 * scl, (name, err, scl)
        msg.append(f"{name} rel {err / (scl + 1e-9):.3g}")
        if name == "qacc":
            e_mega = err
    on = act_r & same[:, None]
    assert torch.equal(k.contact.geom2[on], r.contact.geom2[on]), "geom2"
    e_dist = _active_close(k.contact.dist, r.contact.dist, on, 1e-5,
                           "mega dist")
    errs["mega_forward"] = e_mega
    print(f"mega forward vs plain (replayed decisions): {int(act_r.sum())} "
          f"active slots, {ties_fwd} tie envs excluded; " + ", ".join(msg)
          + f"; dist max err {e_dist:.3g}; iterations mean "
          f"{float(k.solver_niter.float().mean()):.2f}")

    # ---- one control step of the megastep against its plain version ----
    dec = torch.zeros((E, 4 * SUBSTEPS, 2), dtype=torch.int32, device=dev)
    S1 = S.replace(ctrl=ctrl(0))
    ks = hm.mega_step_n(model, S1, SUBSTEPS, decisions=dec)
    gaps, step_flops = [], []

    def observe(o):
        gaps.append(_margin_gap(o))
        step_flops.append(_forward_flops(
            torch, model, o, dec[:, len(step_flops), 0]))

    rs = hm.mega_step_n_plain(model, S1, SUBSTEPS, replay=dec,
                              on_forward=observe)
    held = torch.ones(E, dtype=torch.bool, device=dev)
    step_errs = {}
    for name in ("qpos", "qvel"):
        got, ref = getattr(ks, name), getattr(rs, name)
        err = (got - ref).abs().max(dim=1).values
        scl = float(ref.abs().max()) + 1e-9
        held &= err <= 5e-4 * scl
        step_errs[name] = (err, scl)
    ties_step = _tie_envs(torch, held, torch.stack(gaps).min(dim=0).values,
                          E, "megastep")
    # the error over the envs held to the tolerance (all but the ties)
    errs["megastep"] = max(float(e[held].max()) for e, _ in step_errs.values())
    msg = [f"{name} rel {float(e[held].max()) / scl:.3g} (all envs "
           f"{float(e.max()) / scl:.3g})"
           for name, (e, scl) in step_errs.items()]
    print(f"megastep (1 control step, {4 * SUBSTEPS} forwards) vs plain "
          f"(replayed decisions): {ties_step} tie envs excluded; "
          + ", ".join(msg) + f"; iterations mean "
          f"{float(dec[..., 0].float().mean()):.2f}")

    # ---- timings -----------------------------------------------------------
    # the staged path's kernels at the staged path's end state
    d = d_staged
    d_pos = fwd.fwd_position(model, d)
    a, b, gxp, gxm = coll.mesh_kernel_inputs(plan, d_pos)
    a_t, b_t = lay.moveaxis0_last(a), lay.moveaxis0_last(b)
    gxp_t, gxm_t = lay.moveaxis0_last(gxp), lay.moveaxis0_last(gxm)
    dist, vsel = hc.plane_mesh_select(plan, a_t, b_t)
    topk_out = hc.group_topk(plan, dist, vsel, gxp_t, gxm_t)
    d_acc = fwd.fwd_acceleration(model, fwd.fwd_actuation(
        model, fwd.fwd_velocity(model, d_pos)))
    efc = con.make_constraint(model, d_acc)
    operands, options = solver.newton_inputs(model, d_acc, efc)
    x, force, iters, _ = hn.solve(*operands, **options)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    rows = []

    path_launches = {**staged_launches, **launches}

    def row(name, source, replaces, ms, plain_ms, nbytes_, flops,
            library_ms=None):
        t, by = _bound(nbytes_, flops)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"loco_mujoco_tpu_torch/csrc/{source}",
            "replaces": f"loco_mujoco_tpu/ops/{replaces}",
            "launches": path_launches.get(name, 0),
            "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": t, "bound_by": by,
            "library_ms": library_ms})

    # relayouts: one forward's calls of each role, summed
    E_, nefc, nv = operands[0].shape
    grouped_in = [t.reshape(E_, -1).contiguous() for t in operands]
    if nfl:
        ne = options["ne"]
        grouped_in[5] = operands[5][:, ne:ne + nfl].contiguous()
    else:
        grouped_in.pop(5)
    roles = {
        "moveaxis0_last": ("pallas_layout.py:43",
                           [a.reshape(E_, -1), b, gxp.reshape(E_, -1),
                            gxm.reshape(E_, -1)]),
        "moveaxis_last0": ("pallas_layout.py:43",
                           [t.reshape(-1, E_) for t in topk_out]),
        "to_grouped": ("pallas_layout.py:112", grouped_in),
        "from_grouped": ("pallas_layout.py:153",
                         [lay.to_grouped(x), lay.to_grouped(force)]),
    }
    fns = {"moveaxis0_last": lay.moveaxis0_last,
           "moveaxis_last0": lay.moveaxis_last0,
           "to_grouped": lay.to_grouped, "from_grouped": lay.from_grouped}
    for role, (replaces, ts) in roles.items():
        ts = [t.contiguous() for t in ts]
        ms = _time_ms(torch, lambda: [fns[role](t) for t in ts])
        plain = _time_ms(torch, lambda: [lay.transpose_plain(t) for t in ts])
        lib = _time_ms(torch, lambda: [t.t().contiguous() for t in ts])
        row(role, "layout.cu", replaces, ms, plain, 2 * nbytes(*ts), 0, lib)

    ms = _time_ms(torch, lambda: hc.plane_mesh_select(plan, a_t, b_t))
    plain = _time_ms(torch, lambda: hc.select_plain(plan, a_t, b_t))
    pt = plan.tensors(dev)
    row("plane_mesh_select", "plane_mesh.cu", "pallas_collision.py:230", ms,
        plain, nbytes(a_t, b_t, pt.flat, pt.pair_i, pt.pair_f, dist, vsel),
        _select_flops(torch, plan, a_t, b_t, dist))

    ms = _time_ms(torch, lambda: hc.group_topk(plan, dist, vsel, gxp_t, gxm_t))
    plain = _time_ms(
        torch, lambda: hc.group_topk_plain(plan, dist, vsel, gxp_t, gxm_t))
    slots_on = int((topk_out[0][:, 0] < BIG / 2).sum())
    row("group_topk", "plane_mesh.cu", "pallas_collision.py:556", ms, plain,
        nbytes(dist, vsel, gxp_t, gxm_t, pt.tbl16, pt.pg_local32, *topk_out),
        2 * plan.k * plan.P * E + 90 * slots_on)

    ms = _time_ms(torch, lambda: hn.solve(*operands, **options))
    plain = _time_ms(torch, lambda: hn.newton_plain(*operands, **options),
                     reps=3)
    n_act = operands[6].sum(dim=1).double()  # active rows per env
    ls = options["ls_iterations"]
    per_iter = (4 * nefc * nv + 6 * nv * nv + n_act * (2 * nv + nv * (nv + 1))
                + 2 * nv ** 3 / 3 + (8 * ls + 8) * nefc)
    flops = float((2 * (2 * nefc * nv + 2 * nv * nv + 8 * nefc)
                   + iters.double() * per_iter + 2 * nefc * nv).sum())
    row("newton", "newton.cu", "pallas_newton.py:755", ms, plain,
        nbytes(*operands, x, force, iters), flops)
    print(f"newton iterations at the timed state: mean "
          f"{float(iters.float().mean()):.2f}, max {int(iters.max())}")

    # the mega path's kernels at the main path's end state S
    pt = model.mega.tables(dev)
    ins = (S.qpos, S.qvel, S.ctrl, S.qfrc_applied, S.xfrc_applied,
           S.qacc_warmstart)
    k = fwd.forward(model, S)
    out_bytes = nbytes(k.qacc, k.qacc_smooth, k.qfrc_constraint,
                       k.contact.dist, k.solver_niter, k.solver_taken) \
        + E * model.ncon * (4 + 4 * 4)  # cgid, cforce
    flops = float(_forward_flops(torch, model, fwd.forward_staged(
        model, S, plain=True), k.solver_niter).sum())
    ms = _time_ms(torch, lambda: hm.mega_forward(model, S))
    plain = _time_ms(torch, lambda: hm.mega_forward_plain(model, S), reps=3)
    row("mega_forward", "mega.cu", "pallas_constraint.py:2335", ms, plain,
        nbytes(*pt, *ins) + out_bytes, flops)
    ms = _time_ms(torch, lambda: hm.mega_step_n(model, S1, SUBSTEPS), reps=3)
    plain = _time_ms(torch, lambda: hm.mega_step_n_plain(model, S1, SUBSTEPS),
                     reps=1)
    row("megastep", "mega.cu", "pallas_constraint.py:2800", ms, plain,
        nbytes(*pt, *ins) + 3 * nbytes(S.qvel),
        float(torch.stack(step_flops).sum()))

    for r in rows:
        print(f"  {r['name']:18s} {r['ms']:9.4f} ms  plain {r['plain_ms']:9.4f}"
              f" ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"launches {r['launches']}")
    print(f"main path {env_steps:.0f} env-steps/s, staged path "
          f"{staged_rate:.0f} env-steps/s; card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
