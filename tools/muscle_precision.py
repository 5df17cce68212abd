#!/usr/bin/env python3
"""The muscle stage's float32 error against float64, on chip_smoke.py's
muscle states, on one GPU.

    python3 tools/muscle_precision.py [--envs 4096] [--steps 1 20]

Drives chip_smoke.py's muscle main path (its seeded state and controls,
through the kernels) and, after each listed control step, evaluates the
stages before the constraint stage three ways: the plain version in
float32, the same in float64 (the reference here), and the mega forward
kernel's qacc_smooth. Prints, after the card's name and power limit, one
JSON line per state: for ten_length, ten_velocity, actuator_force,
qfrc_smooth and qacc_smooth of the float32 plain version, and qacc_smooth of
the kernel, the largest error against float64 relative to float64's largest
value, and the env where it lies.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from loco_mujoco_tpu_torch.core import io  # noqa: E402
from loco_mujoco_tpu_torch.ops import (  # noqa: E402
    forward, hopper_fused as hf, hopper_mega as hm, kernels)


def _rel(a, b):
    err = (a.double() - b).abs().reshape(len(b), -1).amax(1)
    return {"rel": float(err.max()) / float(b.abs().max()),
            "env": int(err.argmax())}


def compare(m32, m64, d):
    """One state's muscle stage in float32 (plain and kernel) against
    float64."""
    qs_k = hm.mega_forward(m32, d).qacc_smooth
    p32 = forward.stages(m32, d, plain=True)
    qs_32 = hf.newton_problem(m32, p32)[1][-1]
    d64 = io.make_data(m64, d.qpos.shape[0]).replace(
        **{f: getattr(d, f).double()
           for f in ("qpos", "qvel", "act", "ctrl")})
    p64 = forward.stages(m64, d64, plain=True)
    out = {f: _rel(getattr(p32, f), getattr(p64, f)) for f in (
        "ten_length", "ten_velocity", "actuator_force", "qfrc_smooth")}
    out["qacc_smooth"] = _rel(qs_32, p64.qacc_smooth)
    out["kernel_qacc_smooth"] = _rel(qs_k, p64.qacc_smooth)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=cs.N_ENVS)
    ap.add_argument("--steps", type=int, nargs="+", default=[1, 20])
    args = ap.parse_args()
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
    m32 = io.load_model_npz(ROOT / cs.MUSCLE_ASSET, device=dev)
    m64 = io.load_model_npz(ROOT / cs.MUSCLE_ASSET, device=dev,
                            dtype=torch.float64)
    torque = io.load_model_npz(
        ROOT / "loco_mujoco_tpu_torch/assets/humanoid_torque_shape.npz",
        device="cpu")
    # chip_smoke.py's state and muscle controls (same seed, same draws)
    rng = np.random.default_rng(cs.SEED)
    E, C = args.envs, cs.CONTROL_STEPS
    qpos = torque.qpos0.numpy()[None] + rng.normal(scale=0.02,
                                                   size=(E, torque.nq))
    z = int(torque.jnt_qposadr[torque.names["joint"]["root_z"]])
    qpos[:, z] -= rng.uniform(0.005, 0.02, size=E)
    rng.uniform(-0.3, 0.3, size=(C, E, torque.nu))  # the torque controls
    ctrls = rng.uniform(0.0, 1.0, size=(C, E, m32.nu))
    d = forward.forward(m32, io.make_data(m32, E).replace(
        qpos=torch.as_tensor(qpos, dtype=torch.float32, device=dev)))
    print(f"card: {card}; {E} envs")
    for c in range(max(args.steps)):
        d = forward.step_n(m32, d.replace(ctrl=torch.as_tensor(
            ctrls[c], dtype=torch.float32, device=dev)), cs.SUBSTEPS)
        if c + 1 in args.steps:
            con = forward.forward(m32, d).contact
            n_con = int((con.dist < con.includemargin).sum())
            print(json.dumps({"control_step": c + 1,
                              "contacts_per_env": n_con / E,
                              **compare(m32, m64, d)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
