#!/usr/bin/env python3
"""Time the relayouts of the staged step's call sites on one GPU and split
each call's host time by part; with `--staged`, also the staged path's
Newton and fused kernels and its rates; with `--mesh`, its plane-mesh
call site.

    python3 tools/layout_host.py [--root DIR] [--calls 1000] [--envs 4096]
                                 [--staged STEPS] [--mesh]

At `chip_smoke.py`'s `wide` configuration (the HumanoidTorque-shaped
model with 34 plane-mesh slots: 456 rows, no plan, so its staged step runs
the plane-mesh and Newton kernels) and a seeded state dropped 5-20 mm
(`dropped`),
it builds the arrays each call site relays in one forward: the plane-mesh
group's four select and top-K operands (`moveaxis0_last`) and four top-K
results (`moveaxis_last0`), the Newton solve's operands (`to_grouped`)
and its two results (`from_grouped`): the one-thread kernels relayed those
around their launches; the plane-mesh kernel reads the geom poses in
place and writes its slots env-major, and the warp-per-env Newton kernel
reads its operands env-major, so no path launches a relayout now, and
they are timed on the arrays they would relay. For each call site it
prints one
JSON line: the wrapper's time over the site's arrays, the launch alone
(the launcher on outputs made beforehand, enqueued behind a sleep of the
stream, so that the events time the card only), one `x.t().contiguous()`
per array and the bound (each array read and written once over 3.35
TB/s), in ms (CUDA events, the mean of 100 runs after a warm-up; every
output is checked against `x.t()`), and the host split: `--calls` calls
of the wrapper timed with `time.perf_counter` and no synchronize in the
loop,
then each part of the wrapper alone over as many calls, in microseconds
per call of the site (`rest` is the wrapper's time less its timed parts),
on the site's arrays cut to 128 envs (`host_arrays`: the same calls with
too little device work to fill the card's queue).

`--staged STEPS` also prints, on lines of their own:

- `kernel: newton`: the Newton kernel (`hopper_newton.solve`, with
  whatever relayouts the checkout runs around it) on the staged rows of
  `wide` and of G1 with its arms at 20 plane-mesh slots (455 rows at nv
  29, no plan: the second compiled width), at the dropped state, ms per
  call (CUDA events, the mean of 10 calls after a warm-up);
- `staged`: STEPS control steps (10 substeps each) of the staged path
  (`LMT_MEGA=0`, `forward.step`) from the dropped state, after one
  untimed control step, each control step timed on its own
  (`staged_rate`): env-steps/s of each, their median, least and most, and
  the launches per control step, in the committed model's `rk4`
  configuration (the fused kernel and the plane-mesh kernels, with
  whatever relayouts the checkout runs around them), in `wide` (the Newton kernel besides), A1 (the fused
  kernel's elliptic layout) and G1 with its arms (width 32);
- `kernel: fused`: the fused kernel (`hopper_fused.fused_constraint`) at
  the end state of each staged run with a row plan, on its own inputs
  (FK outputs and the staged collision's slots), ms per call as above.

`--mesh` also prints, on a line of its own per configuration, the
plane-mesh call site of one forward (`collision._plane_mesh_kernel` on
the kernel-gated group, `mesh_site`) at the position stage of the staged
path's state after two control steps from the dropped state, in `rk4` and
in G1: ms per call (CUDA events, the mean of 100 calls after a warm-up,
the host's enqueue included, as the staged forward meets it), its launches
and the kernels, copies and pageable copies one call runs
(torch.profiler): a checkout before the one plane-mesh kernel runs its
whole chain there (the inputs, two relayouts, the select and the top-K),
a later one the one launch.

`--root DIR` times the port of another checkout (an archive of a parent
commit, to put both in one call: parent, change, change, parent). A
checkout with the list forms (`hopper_layout.moveaxis0_last_many` ...)
relays a site's arrays in one launch, an older one an array per launch;
the split follows that checkout's own wrapper either way. `chip_smoke.py`
imports `site_arrays`, `wrapper`, `split`, `host_arrays` and `site_times`
for its layout phase. Prints the card's name and power limit and one JSON
line per measurement.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

ROLES = ("moveaxis0_last", "moveaxis_last0", "to_grouped", "from_grouped")
HBM_BYTES_PER_S = 3.35e12


def site_arrays(lay, coll, hc, hn, plan, d_pos, operands, options) -> dict:
    """{role: the arrays its call site relays in one forward}: the
    plane-mesh group `plan`'s four select and top-K operands and four
    results at the position stage `d_pos`, and the Newton solve's operands
    (`solver.newton_inputs`) and results, env-major or env-last as the
    call sites of a checkout that relays them pass them
    (`collision._plane_mesh_kernel` before its one kernel read the poses
    in place, `hopper_newton.solve` before its kernel read its operands
    env-major); a checkout with the one plane-mesh kernel gives the
    arrays of the same shapes from its slots."""
    import torch

    gxp, gxm = d_pos.geom_xpos, d_pos.geom_xmat
    E = gxp.shape[0]
    if hasattr(hc, "mesh_slots"):
        t = plan.tensors(gxp.device)
        a, b = hc.plane_in_mesh_frame(gxp, gxm, t.pg1, t.pg2)
        used = torch.unique(torch.cat([t.pg1, t.pg2]))
        ds, pos, fr, g1, g2, fric, sref, simp, marg = hc.mesh_slots(
            plan, gxp, gxm)
        meta = torch.cat([g1[..., None].to(ds.dtype),
                          g2[..., None].to(ds.dtype), fric, sref, simp,
                          marg[..., None]], dim=-1)
        topk = [x.reshape(E, plan.k, -1).permute(1, 2, 0).contiguous()
                for x in (ds, pos, fr, meta)]
        mesh_in = [a, b, gxp[:, used], gxm[:, used].reshape(E, -1, 9)]
    else:
        mesh_in = list(coll.mesh_kernel_inputs(plan, d_pos))
        a_t, b_t, gxp_t, gxm_t = (lay.moveaxis0_last_plain(t)
                                  for t in mesh_in)
        dist, vsel = hc.plane_mesh_select(plan, a_t, b_t)
        topk = list(hc.group_topk(plan, dist, vsel, gxp_t, gxm_t))
    ne, nfl = options["ne"], options["nfl"]
    grouped = [t.reshape(E, -1) for i, t in enumerate(operands) if i != 5]
    if nfl:
        grouped.append(operands[5][:, ne:ne + nfl].contiguous())
    x, f, _, _ = hn.solve(*operands, **options)
    return {"moveaxis0_last": mesh_in, "moveaxis_last0": topk,
            "to_grouped": grouped,
            "from_grouped": [x.t().contiguous(), f.t().contiguous()]}


def _dims(role, x):
    """(R, C, output shape) of x's relayout: (R, C) -> (C, R)."""
    s = tuple(x.shape)
    if role in ("moveaxis0_last", "to_grouped"):
        return s[0], math.prod(s[1:]), (*s[1:], s[0])
    return math.prod(s[:-1]), s[-1], (s[-1], *s[:-1])


def _grouped(lay) -> bool:
    """The checkout relays a list in one launch (`launch`), or one array
    per launch (`_t2d`)."""
    return hasattr(lay, "launch")


def wrapper(lay, role):
    """The call site's relayout of a list of arrays."""
    if _grouped(lay):
        many = getattr(lay, f"{role}_many")
        return lambda xs: many(*xs)
    one = getattr(lay, role)
    return lambda xs: [one(x) for x in xs]


def _launch_alone(torch, lay, kernels, role, xs):
    """(launch, outputs): the launcher over xs into outputs made
    beforehand, pointers and the stream taken once."""
    dims = [_dims(role, x) for x in xs]
    lib = kernels.library("layout", lay._SIGNATURES)
    s = kernels.stream()
    if _grouped(lay):
        ys = lay.outputs(xs[0], dims)
        args = []
        for x, y, (R, C, _) in zip(xs, ys, dims):
            args += (x.data_ptr(), y.data_ptr(), R, C)
        packed, n = struct.pack(f"{len(args)}q", *args), len(xs)
        return (lambda: lib.lmt_transpose_many(packed, n, s)), ys
    ys = [torch.empty(shape, dtype=x.dtype, device=x.device)
          for x, (_, _, shape) in zip(xs, dims)]
    args = [(kernels.ptr(x), kernels.ptr(y), R, C)
            for x, y, (R, C, _) in zip(xs, ys, dims)]
    return (lambda: [lib.lmt_transpose2d(*a, s) for a in args]), ys


def _time_ms(torch, fn, reps=100, queued=False):
    """Mean CUDA-event ms of fn over `reps` calls after a warm-up. With
    `queued` the calls are enqueued behind a sleep of the stream, so the
    events time the card alone: a launch of a few microseconds is
    otherwise timed at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(1 << 26)  # ~40 ms, past the loop's host time
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def site_times(torch, lay, kernels, role, xs) -> dict:
    """ms of the call site's relayout of xs: the wrapper, the launch
    alone, the plain version (`transpose_plain` of each array), one
    `x.t().contiguous()` per array (the library call) and the bound; the
    outputs checked."""
    fn = wrapper(lay, role)
    for x, y in zip(xs, fn(xs)):
        R, C, shape = _dims(role, x)
        assert torch.equal(y, x.reshape(R, C).t().reshape(shape)), role
    alone, ys = _launch_alone(torch, lay, kernels, role, xs)
    out = {"wrapper_ms": _time_ms(torch, lambda: fn(xs)),
           "launch_alone_ms": _time_ms(torch, alone, queued=True)}
    for x, y in zip(xs, ys):
        R, C, shape = _dims(role, x)
        assert torch.equal(y, x.reshape(R, C).t().reshape(shape)), role
    mats = [x.reshape(_dims(role, x)[:2]) for x in xs]
    out["plain_ms"] = _time_ms(torch, lambda: [lay.transpose_plain(m)
                                               for m in mats])
    out["library_ms"] = _time_ms(torch, lambda: [m.t().contiguous()
                                                 for m in mats])
    nbytes = sum(x.numel() * x.element_size() for x in xs)
    out["bound_ms"] = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    return out


def _us(torch, fn, calls):
    """Host microseconds per call of fn over `calls` calls, with no
    synchronize in the loop."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def host_arrays(role, xs, envs=128) -> list:
    """The site's arrays cut to their first `envs` envs (contiguous
    copies): the same calls, shapes but for E, and checks, with so little
    device work that a loop of them never waits for the card."""
    first = role in ("moveaxis0_last", "to_grouped")
    return [(x[:envs] if first else x[..., :envs]).contiguous() for x in xs]


def split(torch, lay, kernels, role, xs, calls=1000) -> dict:
    """Host microseconds per call of the site's wrapper (`total`) and of
    its parts: the operand checks, the output allocation, the stream
    lookup, the library lookup, the pointers (and, for a list, their
    packing), the ctypes call with its launch, the launch count, and the
    rest (shapes, views and reshapes, results). An older checkout's site
    makes one wrapper call per array: its parts are summed over them.
    Pass `host_arrays` of the site's arrays: at full width the card's
    queue fills within the loop, and the host then waits for it."""
    fn = wrapper(lay, role)
    dims = [_dims(role, x) for x in xs]
    dev = xs[0].device
    alone, ys = _launch_alone(torch, lay, kernels, role, xs)
    counts = kernels.LAUNCHES.copy()
    if _grouped(lay):
        parts = {
            "checks": lambda: lay.check(role, xs),
            "allocation": lambda: lay.outputs(xs[0], dims),
            "pointers": lambda: struct.pack(f"{4 * len(xs)}q", *(
                v for x, y, (R, C, _) in zip(xs, ys, dims)
                for v in (x.data_ptr(), y.data_ptr(), R, C))),
        }
    else:
        mats = [(x, x.reshape(R, C), (R, C), (C, R))
                for x, (R, C, _) in zip(xs, dims)]
        parts = {
            "checks": lambda: [kernels.require(m, role, rc)
                               for _, m, rc, _ in mats],
            "allocation": lambda: [torch.empty(cr, dtype=x.dtype, device=dev)
                                   for x, _, _, cr in mats],
            "pointers": lambda: [(kernels.ptr(x), kernels.ptr(y))
                                 for x, y in zip(xs, ys)],
        }
    per = 1 if _grouped(lay) else len(xs)  # wrapper calls per site

    def count():
        for _ in range(per):
            kernels.LAUNCHES[role] += 1

    parts.update({
        "stream": lambda: [kernels.stream() for _ in range(per)],
        "library": lambda: [kernels.library("layout", lay._SIGNATURES)
                            for _ in range(per)],
        "ctypes call": alone,
        "count": count,
    })
    out = {"total": _us(torch, lambda: fn(xs), calls)}
    for name, part in parts.items():
        out[name] = _us(torch, part, calls)
    out["rest"] = out["total"] - sum(v for k, v in out.items()
                                     if k != "total")
    kernels.LAUNCHES.clear()
    kernels.LAUNCHES.update(counts)
    return out


def staged_rate(torch, fwd, kernels, m, d, steps, substeps=10):
    """(env-steps/s of each of `steps` control steps, launches per control
    step, the end state) of the staged path from d, after one untimed
    control step; each control step is timed on its own (synchronized at
    both ends)."""
    os.environ["LMT_MEGA"] = "0"
    rates = []
    try:
        for _ in range(substeps):
            d = fwd.step(m, d)
        torch.cuda.synchronize()
        kernels.LAUNCHES.clear()
        for _ in range(steps):
            t0 = time.perf_counter()
            for _ in range(substeps):
                d = fwd.step(m, d)
            torch.cuda.synchronize()
            rates.append(d.qpos.shape[0] / (time.perf_counter() - t0))
    finally:
        del os.environ["LMT_MEGA"]
    assert torch.isfinite(d.qvel).all()
    counts = {k: v // steps for k, v in sorted(kernels.LAUNCHES.items())}
    return rates, counts, d


def device_ops(torch, fn):
    """(kernels, copies and fills, copies from pageable host memory) that
    one call of `fn` runs on the card, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(1 for n in names if n.startswith(("Memcpy", "Memset")))
    return (len(names) - copies, copies,
            sum(1 for n in names if "Pageable" in n))


def mesh_times(torch, hc, kernels, plan, gxp, gxm, env_id=None) -> dict:
    """ms of the plane-mesh kernel on the poses gxp, gxm (and, for a plan
    of K > 1 variants' hull tables, each env's variant env_id, int32):
    the wrapper (`hopper_collision.mesh_slots`), the launch alone (the
    launcher on outputs made beforehand, enqueued behind a sleep of the
    stream, so that the events time the card only) and the plain version
    (one run)."""
    E, G = gxp.shape[0], gxp.shape[1]
    t = plan.tensors(gxp.device)
    out = [torch.empty((E, plan.k, n), dtype=torch.float32,
                       device=gxp.device) for n in (3, 9, 9, hc.META)]
    ids = torch.empty((E, plan.k, 2), dtype=torch.int64, device=gxp.device)
    lib = kernels.library("plane_mesh", hc._SIGNATURES)
    vid = None if env_id is None or plan.K == 1 else env_id.data_ptr()
    args = ([x.data_ptr() for x in (gxp, gxm, t.flat, t.pair_k, t.pair_f,
                                    t.tbl16)] + [vid]
            + [x.data_ptr() for x in (*out[:3], ids, out[3])])
    s = kernels.stream()

    def alone():
        return lib.lmt_mesh_slots(*args, None, plan.P, plan.k, E, G,
                                  plan.table_floats, s)

    assert alone() == 0
    return {"wrapper_ms": _time_ms(torch, lambda: hc.mesh_slots(
                plan, gxp, gxm, env_id=env_id)),
            "launch_alone_ms": _time_ms(torch, alone, queued=True),
            "plain_ms": _time_ms(torch, lambda: hc.mesh_slots_plain(
                plan, gxp, gxm, env_id=env_id), reps=1)}


def mesh_site(torch, coll, kernels, m, d_pos) -> dict:
    """The plane-mesh call site of one forward (`_plane_mesh_kernel` on the
    model's kernel-gated group, as the checkout runs it) at the position
    stage d_pos: ms per call, launches per call, and the kernels, copies
    and pageable copies of one call."""
    gi = next(i for i, p in enumerate(m.mesh_kernel) if p is not None)
    g, plan = m.groups[gi], m.mesh_kernel[gi]

    def call():
        return coll._plane_mesh_kernel(m, g, plan, d_pos, plain=False)

    kernels.LAUNCHES.clear()
    call()
    launches = dict(kernels.LAUNCHES)
    ops = device_ops(torch, call)
    return {"ms": _time_ms(torch, call), "launches": launches,
            "kernels": ops[0], "copies": ops[1], "pageable": ops[2]}


def dropped(io, m, envs, dev):
    """A seeded state (numpy, seed 0) of `envs` envs: qpos0 with noise of
    0.02, the root lowered 5-20 mm, at rest."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    qpos = m.qpos0.cpu().numpy()[None] + rng.normal(scale=0.02,
                                                    size=(envs, m.nq))
    z = next(n for n in m.names["joint"] if n.endswith("tz") or n == "root_z")
    a = int(m.jnt_qposadr[m.names["joint"][z]])
    qpos[:, a] = float(m.qpos0[a]) - rng.uniform(0.005, 0.02, size=envs)
    return io.make_data(m, envs).replace(
        qpos=torch.as_tensor(qpos, dtype=torch.float32, device=dev))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--staged", type=int, default=0)
    ap.add_argument("--mesh", action="store_true")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from loco_mujoco_tpu_torch.core import io
    from loco_mujoco_tpu_torch.ops import collision as coll
    from loco_mujoco_tpu_torch.ops import constraint as con
    from loco_mujoco_tpu_torch.ops import forward as fwd
    from loco_mujoco_tpu_torch.ops import hopper_collision as hc
    from loco_mujoco_tpu_torch.ops import hopper_fused as hf
    from loco_mujoco_tpu_torch.ops import hopper_layout as lay
    from loco_mujoco_tpu_torch.ops import hopper_newton as hn
    from loco_mujoco_tpu_torch.ops import kernels, kinematics, solver

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}; port from {root}")
    kernels.build_all(["layout", "plane_mesh", "newton"]
                      + (["fused"] if args.staged or args.mesh else []))
    dev = torch.device("cuda")
    E = args.envs

    def load(stem, change=None):
        leaves, aux = io.read_model_npz(
            root / f"loco_mujoco_tpu_torch/assets/{stem}.npz")
        aux.update(change or {})
        return io.model_from_numpy(leaves, aux, device=dev,
                                   dtype=torch.float32)

    def emit(**kw):
        print(json.dumps(dict(kw, card=card)), flush=True)

    def solve_inputs(m):
        d_pos = fwd.fwd_position(m, dropped(io, m, E, dev))
        d_acc = fwd.fwd_acceleration(m, fwd.fwd_actuation(
            m, fwd.fwd_velocity(m, d_pos)))
        return d_pos, solver.newton_inputs(m, d_acc,
                                           con.make_constraint(m, d_acc))

    # chip_smoke.CONFIGS["wide"]
    m = load("humanoid_torque_shape", {"contact_k_plane": 34})
    assert m.plan is None, "the wide configuration has a plan"
    d_pos, (operands, options) = solve_inputs(m)
    plan = next(p for p in m.mesh_kernel if p is not None)
    sites = site_arrays(lay, coll, hc, hn, plan, d_pos, operands, options)
    for role in ROLES:
        xs = [t.contiguous() for t in sites[role]]
        emit(site=role, arrays=len(xs),
             launches=1 if _grouped(lay) else len(xs),
             **site_times(torch, lay, kernels, role, xs),
             host_us=split(torch, lay, kernels, role, host_arrays(role, xs),
                           args.calls),
             calls=args.calls)
    if args.mesh:
        for name, model in (("rk4", load("humanoid_torque_shape")),
                            ("g1", load("unitree_g1_shape"))):
            d = staged_rate(torch, fwd, kernels, model,
                            dropped(io, model, E, dev), 1)[2]
            emit(mesh=name, envs=E, **mesh_site(
                torch, coll, kernels, model, fwd.fwd_position(model, d)))
    if not args.staged:
        return 0
    g1w = load("unitree_g1_arms_shape", {"contact_k_plane": 20})
    for name, mw, (ops, opts) in (
            ("wide", m, (operands, options)),
            ("g1arms_wide", g1w, solve_inputs(g1w)[1])):
        kernels.LAUNCHES.clear()
        it = hn.solve(*ops, **opts)[2]
        launches = dict(kernels.LAUNCHES)
        emit(kernel="newton", config=name, rows=int(ops[0].shape[1]),
             nv=int(mw.nv), ms=_time_ms(torch, lambda: hn.solve(*ops, **opts),
                                        reps=10),
             iterations_mean=float(it.float().mean()), launches=launches)
    for name, model in (("rk4", load("humanoid_torque_shape")),
                        ("wide", m), ("a1", load("unitree_a1_shape")),
                        ("g1arms", load("unitree_g1_arms_shape"))):
        rates, counts, d = staged_rate(torch, fwd, kernels, model,
                                       dropped(io, model, E, dev),
                                       args.staged)
        emit(staged=name, steps=args.staged,
             env_steps_per_s=statistics.median(rates),
             least=min(rates), most=max(rates), each=rates,
             launches_per_control_step=counts)
        if model.plan is None:
            continue
        d_in = coll.collision(model, kinematics.kinematics(model, d))
        k = hf.fused_constraint(model, d_in)
        emit(kernel="fused", config=name, rows=int(model.plan.nrows),
             nv=int(model.nv), pack_w=int(model.plan.pack_w),
             ms=_time_ms(torch, lambda: hf.fused_constraint(model, d_in),
                         reps=10),
             iterations_mean=float(k.solver_niter.float().mean()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
