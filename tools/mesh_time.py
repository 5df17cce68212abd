#!/usr/bin/env python3
"""Time the plane-mesh kernel (`hopper_collision.mesh_slots`) of a checkout
on one GPU, after holding it to its plain version.

    python3 tools/mesh_time.py [--root DIR] [--envs 4096] [--phases]

At three configurations of `chip_smoke.py`, each at a seeded state dropped
5-20 mm (`tools/layout_host.dropped`) and its position stage: the torque
humanoid (75 hulls, k 8), G1 (18 hulls, k 8) and `wide` (the humanoid at
34 slots), it runs `chip_smoke._mesh_slots_rule` (every env: active slots,
ids and statics exact, depths, positions, frames and every near pair's key
within their tolerances), then prints one JSON line per configuration: the
launch alone (the launcher on outputs made beforehand, enqueued behind a
sleep of the stream, so that the events time the card only), the wrapper
and the plain version in ms (`layout_host.mesh_times`), the near pairs and
active slots, the kernel's registers and spills (its ptxas log) and the
card's name and power limit. `--phases` adds, from the kernel's
compile-time variant `-DLMT_PHASES` (lane 0's clock64() cycles per env,
never built for a path), the mean and the most cycles per warp in the
bounds and the near pairs' walks, the top-K and the slots. `--root DIR`
takes the port, the smoke and the tools of another checkout (an archive,
or a copy with a change to `csrc/plane_mesh.cu`), so that versions of the
kernel fit one call, in turns.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_cycles(torch, hc, kernels, plan, gxp, gxm) -> dict:
    """Mean and most cycles per warp of the LMT_PHASES variant's three
    phases at the poses gxp, gxm."""
    E, G = gxp.shape[0], gxp.shape[1]
    t = plan.tensors(gxp.device)
    dev = gxp.device
    out = [torch.empty((E, plan.k, n), dtype=torch.float32, device=dev)
           for n in (3, 9, 9, hc.META)]
    ids = torch.empty((E, plan.k, 2), dtype=torch.int64, device=dev)
    key = torch.zeros((E, plan.P), dtype=torch.float32, device=dev)
    lib = kernels.library("plane_mesh", hc._SIGNATURES, ("LMT_PHASES",))
    args = ([x.data_ptr() for x in (gxp, gxm, t.flat, t.pair_k, t.pair_f,
                                    t.tbl16)] + [None]
            + [x.data_ptr() for x in (*out[:3], ids, out[3], key)])
    for _ in range(3):  # the last launch's clocks
        kernels.check(lib.lmt_mesh_slots(*args, plan.P, plan.k, E, G,
                                         plan.table_floats,
                                         kernels.stream()), "mesh_slots")
    torch.cuda.synchronize()
    cycles = key[:, :3].double()
    names = ("bounds_and_walks", "top_k", "slots")
    return {"mean_cycles": dict(zip(names, cycles.mean(0).tolist())),
            "most_cycles": dict(zip(names, cycles.max(0).values.tolist()))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from loco_mujoco_tpu_torch.core import io
    from loco_mujoco_tpu_torch.ops import forward as fwd
    from loco_mujoco_tpu_torch.ops import hopper_collision as hc
    from loco_mujoco_tpu_torch.ops import kernels

    lh = _module(root / "tools" / "layout_host.py", "layout_host")
    smoke = _module(root / "chip_smoke.py", "chip_smoke")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels.build_all(["plane_mesh"])
    if args.phases:
        kernels.build_all(["plane_mesh"], ("LMT_PHASES",))
    ptxas = [line.strip() for line in kernels.ptxas_log("plane_mesh")
             .read_text().splitlines() if "registers" in line
             or "spill" in line]
    dev = torch.device("cuda")
    for name, stem, change in (
            ("rk4", "humanoid_torque_shape", {}),
            ("g1", "unitree_g1_shape", {}),
            ("wide", "humanoid_torque_shape", {"contact_k_plane": 34})):
        leaves, aux = io.read_model_npz(
            root / f"loco_mujoco_tpu_torch/assets/{stem}.npz")
        aux.update(change)
        m = io.model_from_numpy(leaves, aux, device=dev, dtype=torch.float32)
        d = fwd.fwd_position(m, lh.dropped(io, m, args.envs, dev),
                             plain=True)
        plan = next(p for p in m.mesh_kernel if p is not None)
        err, active, near = smoke._mesh_slots_rule(
            torch, plan, d.geom_xpos, d.geom_xmat, name)
        times = lh.mesh_times(torch, hc, kernels, plan, d.geom_xpos,
                              d.geom_xmat)
        if args.phases:
            times["phases"] = phase_cycles(torch, hc, kernels, plan,
                                           d.geom_xpos, d.geom_xmat)
        print(json.dumps({"config": name, "pairs": plan.P, "k": plan.k,
                          "envs": args.envs, "max_abs_err": err,
                          "active_slots": active, "near_pairs": near,
                          **times, "ptxas": ptxas, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
