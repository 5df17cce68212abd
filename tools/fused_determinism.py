#!/usr/bin/env python3
"""Run-to-run determinism of the fused constraint kernel and its agreement
with its plain version, on the inputs of
`tests/test_torch_cuda.py::test_fused_matches_plain`, on one GPU.

    python3 tools/fused_determinism.py [--config rk4] [--seeds 40]
        [--envs 256] [--repeats 4]

For each of `--seeds` draws it makes the test's state of the committed
HumanoidTorque-shaped model (qpos0 plus the test's numpy noise, dropped 15
mm, qvel = 0.1 x a normal draw, here from a torch generator seeded with
the draw's number) and

- builds the kernel's operands twice (kinematics and collision on the
  card) and checks them bit-equal (`inputs_equal`);
- launches the kernel `--repeats` times, with a launch on another draw's
  operands and a mega forward between every two, and checks every output
  bit-equal (`kernel_equal`): a read of memory the kernel did not write,
  or a race, shows as a difference here; runs the plain version twice
  with the same replay and checks it bit-equal too (`plain_equal`);
- holds the kernel against its plain version replaying its decisions (the
  warm start, iteration count, steps taken and, where the tree records
  them, the line search's signs and each Newton step's Hessian decisions
  of the rows) by the test's rule, per env: qacc,
  qfrc_constraint and efc_force_contact within rel 5e-4 of the field's
  largest value (`bad`: the envs that are not).

Prints the card's name and power limit, one JSON line per draw and a
summary line. Runs on any checkout of the port since the fused kernel
(it reads `solver_ls` and `solver_rows` only where the Data has them).
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
sys.path.insert(0, str(ROOT / "tests"))

from loco_mujoco_tpu_torch.core import io  # noqa: E402
from loco_mujoco_tpu_torch.ops import collision as coll  # noqa: E402
from loco_mujoco_tpu_torch.ops import forward as fwd  # noqa: E402
from loco_mujoco_tpu_torch.ops import hopper_fused as hf  # noqa: E402
from loco_mujoco_tpu_torch.ops import kinematics  # noqa: E402
from test_torch_fixture import CONFIGS  # noqa: E402

ASSET = ROOT / "loco_mujoco_tpu_torch/assets/humanoid_torque_shape.npz"
FIELDS = ("qacc", "qfrc_constraint", "efc_force_contact")


def _model(change):
    leaves, aux = io.read_model_npz(ASSET)
    for k, v in change.items():
        if k.startswith("leaf:"):
            leaves[k[5:]] = np.array(leaves[k[5:]])
            leaves[k[5:]][-1, 0] = v
        else:
            aux[k] = v
    return io.model_from_numpy(leaves, aux, device="cuda")


def _dropped(model, E):
    """tests/test_torch_cuda.py's _dropped: qpos0 + noise, 15 mm down."""
    rng = np.random.default_rng(0)
    qpos = model.qpos0.cpu().numpy()[None] + rng.normal(scale=0.02,
                                                        size=(E, model.nq))
    qpos[:, int(model.jnt_qposadr[model.names["joint"]["root_z"]])] -= 0.015
    return io.make_data(model, E).replace(
        qpos=torch.as_tensor(qpos, dtype=torch.float32, device="cuda"))


def _operands(model, E, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    d = _dropped(model, E).replace(
        qvel=0.1 * torch.randn(E, model.nv, device="cuda", generator=g))
    d = coll.collision(model, kinematics.kinematics(model, d))
    return d, (hf.vec(model, d), hf.contact_pack(model, d))


def _outputs(k):
    out = [getattr(k, f) for f in FIELDS]
    out += [k.solver_niter, k.solver_taken]
    for f in ("solver_ls", "solver_rows"):
        if getattr(k, f, None) is not None:
            out.append(getattr(k, f))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="rk4", choices=list(CONFIGS))
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    model, E = _model(CONFIGS[args.config]), args.envs
    mega_model = _model({})
    other, _ = _operands(model, E, 10 ** 6)
    mega_state = fwd.fwd_position(mega_model, _dropped(mega_model, E),
                                  plain=True)
    total_bad, draws = 0, []
    for seed in range(args.seeds):
        d, ops = _operands(model, E, seed)
        _, ops2 = _operands(model, E, seed)
        inputs_equal = all(torch.equal(a, b) for a, b in zip(ops, ops2))
        k = hf.fused_constraint(model, d)
        first = _outputs(k)
        kernel_equal = True
        for _ in range(args.repeats - 1):
            hf.fused_constraint(model, other)
            fwd.forward(mega_model, mega_state)
            again = _outputs(hf.fused_constraint(model, d))
            kernel_equal &= all(torch.equal(a, b)
                                for a, b in zip(first, again))
        replay = (k.solver_niter, k.solver_taken)
        for f in ("solver_ls", "solver_rows"):
            if getattr(k, f, None) is not None:
                replay += (getattr(k, f),)
        r = hf.fused_constraint_plain(model, d, replay=replay)
        r2 = hf.fused_constraint_plain(model, d, replay=replay)
        plain_equal = all(torch.equal(getattr(r, f), getattr(r2, f))
                          for f in FIELDS)
        bad = torch.zeros(E, dtype=torch.bool, device="cuda")
        worst = 0.0
        for f in FIELDS:
            got, ref = getattr(k, f), getattr(r, f)
            scl = float(ref.abs().max()) + 1e-9
            err = (got - ref).abs().reshape(E, -1).amax(1) / scl
            bad |= err >= 5e-4
            worst = max(worst, float(err.max()))
        envs = bad.nonzero().flatten().tolist()
        total_bad += len(envs)
        line = {"seed": seed, "inputs_equal": inputs_equal,
                "kernel_equal": bool(kernel_equal),
                "plain_equal": plain_equal, "bad": envs,
                "worst_rel": worst,
                "iterations_mean": float(k.solver_niter.float().mean())}
        draws.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({
        "config": args.config, "envs": E, "seeds": args.seeds,
        "inputs_equal": all(x["inputs_equal"] for x in draws),
        "kernel_equal": all(x["kernel_equal"] for x in draws),
        "plain_equal": all(x["plain_equal"] for x in draws),
        "bad_envs": total_bad,
        "draws_failing": sum(bool(x["bad"]) for x in draws)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
