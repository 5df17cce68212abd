#!/usr/bin/env python3
"""Where the time of the PyTorch port's physics step goes, on one GPU.

    python3 tools/profile_torch_step.py [--envs 4096] [--steps 1]
                                        [--path megastep|staged]
                                        [--integrator rk4|euler|muscle|a1]

Loads the committed HumanoidTorque-shaped model on the card (`--integrator
euler`: its Euler configuration, the same arrays with `opt.integrator` set
to Euler; `muscle`: the committed HumanoidMuscle-shaped model, Euler,
muscle ctrls in [0, 1]; `a1`: the committed UnitreeA1-shaped model,
Euler, elliptic cones, its motor ctrls in half the ctrlrange, the
smoke's A1 draws), makes the same seeded state as `chip_smoke.py`,
runs one warm-up control step (10 substeps), then traces `--steps` control
steps with `torch.profiler`: `--path megastep` (the main path) runs each
control step as one `forward.step_n`, `--path staged` runs 10
`forward.step` calls with the mega path off (`LMT_MEGA=0`: the fused
constraint kernel). Each forward
stage is wrapped in a `record_function` range (here, by wrapping the stage
functions; the package itself carries no instrumentation), and every kernel
the card ran is attributed to the innermost range that launched it.
Prints the wall time per control step, the device's busy time and idle
share, device time per stage and per kernel name, kernels per forward, and
one JSON line with the same numbers, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from loco_mujoco_tpu_torch.core import io  # noqa: E402
from loco_mujoco_tpu_torch.ops import (  # noqa: E402
    actuation, collision, constraint, forward, hopper_fused, hopper_mega,
    hopper_newton, inertia, kernels, kinematics, passive, solver, tendon,
    velocity)

SUBSTEPS = 10

# (module, function) of every stage; ranges nest (collision > plane-mesh)
STAGES = [
    (kinematics, "kinematics"), (kinematics, "com_pos"), (tendon, "tendon"),
    (tendon, "tendon_vel"), (inertia, "crb"),
    (collision, "collision"), (collision, "_analytic_group"),
    (collision, "_plane_mesh_kernel"), (inertia, "factor_m"),
    (velocity, "com_vel"), (passive, "passive"), (velocity, "rne"),
    (actuation, "actuation"), (inertia, "solve_m"),
    (constraint, "make_constraint"), (solver, "solve"),
    (hopper_newton, "solve"), (hopper_fused, "fused_constraint"),
    (hopper_mega, "mega_step_n"),
]


def _wrap(mod, name):
    fn = getattr(mod, name)
    label = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"

    def wrapped(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)

    setattr(mod, name, wrapped)


def _attribute(trace):
    """Device time per innermost annotation and per kernel name."""
    events = trace["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation" and "dur" in e]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    kern = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    ranges.sort()
    starts = [r[0] for r in ranges]
    by_stage = collections.Counter()
    by_name = collections.Counter()
    for k in kern:
        by_name[k["name"][:60]] += k["dur"]
        ts = launch_ts.get(k.get("args", {}).get("correlation"))
        label, width = "other (RK4 combine, Data updates)", float("inf")
        if ts is not None:
            i = bisect.bisect_right(starts, ts)
            for s, e, n in ranges[max(0, i - 64):i]:
                if s <= ts <= e and e - s < width:
                    label, width = n, e - s
        by_stage[label] += k["dur"]
    iv = sorted((k["ts"], k["ts"] + k["dur"]) for k in kern)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return by_stage, by_name, busy, len(kern)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--path", choices=("megastep", "staged"),
                    default="megastep")
    ap.add_argument("--integrator", choices=("rk4", "euler", "muscle", "a1"),
                    default="rk4")
    args = ap.parse_args()
    if args.path == "staged":
        os.environ["LMT_MEGA"] = "0"
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kernels.build_all()
    dev = torch.device("cuda")
    muscle, a1 = args.integrator == "muscle", args.integrator == "a1"
    leaves, aux = io.read_model_npz(
        ROOT / "loco_mujoco_tpu_torch/assets" / (
            "humanoid_muscle_shape.npz" if muscle else
            "unitree_a1_shape.npz" if a1 else "humanoid_torque_shape.npz"))
    if args.integrator == "euler":
        aux["opt.integrator"] = 0
    model = io.model_from_numpy(leaves, aux, device=dev)
    rng = np.random.default_rng(1 if a1 else 0)  # chip_smoke.py's draws
    E = args.envs
    qpos = model.qpos0.cpu().numpy()[None] + rng.normal(scale=0.02,
                                                        size=(E, model.nq))
    if a1:
        z = int(model.jnt_qposadr[model.names["joint"]["trunk_tz"]])
        qpos[:, z] = float(model.qpos0[z]) - rng.uniform(0.005, 0.02, size=E)
        ctrl = rng.uniform(-0.5, 0.5, size=(E, model.nu))  # A1_CTRL
    else:
        z = int(model.jnt_qposadr[model.names["joint"]["root_z"]])
        qpos[:, z] -= rng.uniform(0.005, 0.02, size=E)
        ctrl = (rng.uniform(0.0, 1.0, size=(E, model.nu)) if muscle else
                rng.uniform(-0.3, 0.3, size=(E, model.nu)))
    d = io.make_data(model, E).replace(
        qpos=torch.as_tensor(qpos, dtype=torch.float32, device=dev),
        ctrl=torch.as_tensor(ctrl, dtype=torch.float32, device=dev))
    for mod, name in STAGES:
        _wrap(mod, name)

    def control_step(d):
        if args.path == "megastep":
            return forward.step_n(model, d, SUBSTEPS)
        for _ in range(SUBSTEPS):
            d = forward.step(model, d)
        return d

    d = control_step(d)  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            d = control_step(d)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6  # us
    path = kernels.build_dir() / "profile_torch_step.json"
    prof.export_chrome_trace(str(path))
    by_stage, by_name, busy, nkern = _attribute(json.loads(path.read_text()))
    forwards = hopper_mega.forwards_per_step(model) * SUBSTEPS * args.steps
    per_step = 1e-3 / args.steps
    print(f"card: {card}; {E} envs, {args.steps} control step(s) of "
          f"{SUBSTEPS} {args.integrator} substeps traced, {args.path} path")
    print(f"wall {wall * per_step:.2f} ms/control step, device busy "
          f"{busy * per_step:.2f} ms, idle share {1 - busy / wall:.3f}; "
          f"{nkern / forwards:.0f} kernels per forward")
    print("device time per stage (ms per control step):")
    for k, v in by_stage.most_common():
        print(f"  {k:40s} {v * per_step:9.3f}")
    print("device time per kernel (ms per control step):")
    for k, v in by_name.most_common(15):
        print(f"  {k:60s} {v * per_step:9.3f}")
    print(json.dumps({
        "card": card, "envs": E, "path": args.path,
        "integrator": args.integrator,
        "wall_ms_per_control_step": wall * per_step,
        "device_busy_ms": busy * per_step, "idle_share": 1 - busy / wall,
        "kernels_per_forward": nkern / forwards,
        "stage_ms": {k: v * per_step for k, v in by_stage.items()},
        "top_kernels_ms": {k: v * per_step
                           for k, v in by_name.most_common(15)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
