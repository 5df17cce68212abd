#!/usr/bin/env python3
"""Where the standalone Newton kernel and its plain version part, on the
G1-shaped stand-ins' seeded states, on one GPU.

    python3 tools/newton_parting.py [--envs 4096 256]

For the committed G1 stand-in (nv 19: the kernel compiled at width 24)
and G1 with its arms (nv 29: width 32) it makes
`tests/test_torch_g1_fixture.g1_states` at each env count, builds their
staged rows (make_constraint) and solves them five ways: the kernel
(`hopper_newton.solve`), its float32 plain version replaying the kernel's
iteration count and taken steps (what the kernel records), the plain
version on its own decisions, and in float64 the same replay and a
converged solve (16 steps, tolerance 1e-12). It prints the card's name
and power limit, then one JSON line per model and env count: the envs
where the kernel and the replayed plain version part past rel 5e-4 (of
the plain version's largest qacc), the largest such difference, in how
many envs the plain version's own decisions are the kernel's, and for up
to 6 parted envs each float32 solve's distance from the float64 ones.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from loco_mujoco_tpu_torch.core import io  # noqa: E402
from loco_mujoco_tpu_torch.ops import constraint as con  # noqa: E402
from loco_mujoco_tpu_torch.ops import forward as fwd  # noqa: E402
from loco_mujoco_tpu_torch.ops import hopper_newton as hn  # noqa: E402
from loco_mujoco_tpu_torch.ops import solver  # noqa: E402
from test_torch_g1_fixture import ASSET, ASSET_ARMS, g1_states  # noqa: E402


def parting(asset, n):
    """One model's five solves at n envs, compared."""
    model = io.load_model_npz(asset, device="cuda")
    q, v, u = g1_states(io.load_model_npz(asset, device="cpu"), n)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                  device="cuda")
    d = io.make_data(model, n).replace(qpos=t(q), qvel=t(v), ctrl=t(u))
    d = fwd.fwd_position(model, d, plain=True)
    d = fwd.fwd_acceleration(model, fwd.fwd_actuation(
        model, fwd.fwd_velocity(model, d)))
    ops, opt = solver.newton_inputs(model, d, con.make_constraint(model, d))
    x_k, _, it_k, tk_k = hn.solve(*ops, **opt)
    x_p, _, _, _ = hn.newton_plain(*ops, **opt, replay=(it_k, tk_k))
    x_o, _, it_o, tk_o = hn.newton_plain(*ops, **opt)
    ops64 = tuple(o.double() for o in ops)
    x_w = hn.newton_plain(*ops64, **opt, replay=(it_k, tk_k))[0]
    x_c = hn.newton_plain(*ops64, **dict(opt, iterations=16, tol=1e-12))[0]
    scale = float(x_p.abs().max())
    err = (x_k - x_p).abs().amax(1) / scale
    bad = (err > 5e-4).nonzero().flatten().tolist()
    out = {"model": asset.stem, "envs": n, "nv": model.nv,
           "nefc": ops[0].shape[1], "parted": len(bad),
           "max_rel": float(err.max()),
           "own_decisions_agree": int(((it_o == it_k)
                                       & (tk_o == tk_k)).sum())}
    rel = lambda a, b, e: float(  # noqa: E731
        (a[e].double() - b[e]).abs().max()) / scale
    for e in bad[:6]:
        out[f"env{e}"] = {
            "kernel_vs_replay64": rel(x_k, x_w, e),
            "plain_vs_replay64": rel(x_p, x_w, e),
            "kernel_vs_converged64": rel(x_k, x_c, e),
            "plain_vs_converged64": rel(x_p, x_c, e),
            "plain_own_vs_converged64": rel(x_o, x_c, e),
            "iterations": int(it_k[e])}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, nargs="+", default=[4096, 256])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}")
    for asset in (ASSET, ASSET_ARMS):
        for n in args.envs:
            print(json.dumps(parting(asset, n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
