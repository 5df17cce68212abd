#!/usr/bin/env python3
"""Time the megastep kernel on one GPU and break it down by phase.

    python3 tools/megastep_phases.py
        [--configs rk4 euler muscle a1 h1 atlas g1 a1pos g1arms h1arms
                   atlasarms talos g1kp]
        [--envs 4096] [--reps 3] [--root DIR] [--no-phases] [--kernels]
        [--floor N]

For each configuration of `chip_smoke.py`'s main path (the committed
HumanoidTorque-shaped model with RK4 and with Euler, the muscle model, the
A1-shaped model, the H1-, Atlas- and G1-shaped bipeds, A1's position mode,
G1, H1 and Atlas with their arms at the second compiled width, and the
Talos-shaped biped and the small G1 whose plane-mesh groups are at k = P)
it drives the main path as the smoke does: the seeded dropped state and
controls of this checkout's `chip_smoke.seeded_draws` (the bipeds' and
those with their arms, Talos and G1 at k = P: `seeded_biped`; A1's
position mode: `seeded_a1pos`),
a reset forward and 20 control steps of `forward.step_n` (10 substeps
each), and prints the main path's rate (control steps x envs per
second, the `env_steps_per_s` key). At that end state, with the first
control step's controls, it times one megastep launch (one control step,
CUDA events, mean of `--reps` after a warm-up). With `--kernels` it also
times, at that state, one mega forward launch and one fused kernel launch
(on the staged path's inputs there: the position stage and collision, the
muscle model's every stage), the keys `mega_forward_ms` and `fused_ms`.

Unless `--no-phases`, it then builds the compile-time variant of
`csrc/mega.cu` with the per-phase clocks (`-DLMT_PHASES`; the main path
never builds it), launches it once on the same inputs and reads the
clock64() cycles each env spent in each phase of its forwards: FK,
collision, the smooth stage (com, CRB and its factor, forces, the muscle
block, qacc_smooth), the constraint rows, the Newton solve and the
integration (the substep's update, Euler's damping solve), and where the
kernel records them the Newton solve's parts (the gradient and Hessian,
the factor and substitutions, the line search with the new cost; the rest
is its row passes). It prints each phase's share of the summed cycles and
that share of the timed launch, in ms. The clocks count the cycles between a warp's readings, so time spent
waiting for another warp of the same SM is charged to the phase that
waits.

`--floor N` sets `ops/plan.py`'s RESIDENT_FLOOR to N before any launch is
planned: with 3, G1 with its arms keeps the rows' J in shared memory at 3
resident warps per SM instead of in the global scratch (the line's
`j_global` says which), so the two layouts of the same kernel can be timed
in turns.

`--root DIR` runs the port of another checkout (for example an archive of
a parent commit, to put both in one call: parent, change, change,
parent); a checkout whose `mega.cu` has no `LMT_PHASES` variant is timed
only, and one without a configuration's committed model cannot run it. Prints the card's name and power limit, one JSON line per
configuration and nothing else on standard output.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("fk", "collision", "smooth", "rows", "newton", "integration")
CONFIGS = ("rk4", "euler", "muscle", "a1", "h1", "atlas", "g1", "a1pos",
           "g1arms", "h1arms", "atlasarms", "talos", "g1kp")
ASSET_OF = {"muscle": "humanoid_muscle_shape", "a1": "unitree_a1_shape",
            "h1": "unitree_h1_shape", "atlas": "atlas_shape",
            "g1": "unitree_g1_shape", "a1pos": "unitree_a1_position_shape",
            "g1arms": "unitree_g1_arms_shape",
            "h1arms": "unitree_h1_arms_shape", "atlasarms": "atlas_arms_shape",
            "talos": "talos_shape", "g1kp": "unitree_g1_kp_shape"}
# the Newton solve's parts (where the kernel splits it; the rest of the
# Newton phase is its row passes)
NEWTON_PARTS = ("gradient_hessian", "factor_solve", "line_search")


def _smoke():
    """This checkout's chip_smoke.py (its seeded draws and step counts),
    whichever port `--root` times."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _models(io, torch, root: Path, names):
    """The smoke's configurations of the main path, by name."""
    dev = torch.device("cuda")
    assets = root / "loco_mujoco_tpu_torch" / "assets"
    out = {}
    for name in names:
        if name in ("rk4", "euler"):
            leaves, aux = io.read_model_npz(
                assets / "humanoid_torque_shape.npz")
            if name == "euler":
                aux["opt.integrator"] = 0
            m = io.model_from_numpy(leaves, aux, device=dev,
                                    dtype=torch.float32)
        else:
            m = io.load_model_npz(assets / f"{ASSET_OF[name]}.npz",
                                  device=dev)
        out[name] = m
    return out


def _time_ms(torch, fn, reps):
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS),
                    choices=CONFIGS)
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--no-phases", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--floor", type=int, default=None)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from loco_mujoco_tpu_torch.core import io
    from loco_mujoco_tpu_torch.ops import collision as coll
    from loco_mujoco_tpu_torch.ops import forward as fwd
    from loco_mujoco_tpu_torch.ops import hopper_fused as hf
    from loco_mujoco_tpu_torch.ops import hopper_mega as hm
    from loco_mujoco_tpu_torch.ops import kernels, kinematics
    from loco_mujoco_tpu_torch.ops import plan as tplan

    if args.floor is not None:
        tplan.RESIDENT_FLOOR = args.floor

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}; port from {root}")
    src = (root / "loco_mujoco_tpu_torch" / "csrc" / "mega.cu").read_text()
    phases = not args.no_phases and "LMT_PHASES" in src
    found = re.search(r"constexpr int kPhases = (\d+);", src)
    ncol = int(found.group(1)) if found else 0
    kernels.build_all()
    if phases:
        kernels.build_all(["mega"], ("LMT_PHASES",))
    E = args.envs
    smoke = _smoke()
    steps, substeps = smoke.CONTROL_STEPS, smoke.SUBSTEPS
    drawn = _models(io, torch, root, ["rk4", "muscle", "a1"])
    qpos, ctrls_tq, ctrls_mu, qpos_a1, ctrls_a1 = smoke.seeded_draws(
        drawn["rk4"], drawn["muscle"], drawn["a1"], E)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                  device="cuda")
    for name, m in _models(io, torch, root, args.configs).items():
        kp = getattr(smoke, "KP", {})
        if name in smoke.BIPEDS or name in ("g1", "g1arms", *smoke.ARMS,
                                            *kp):
            seed = {"g1": smoke.G1[1], "g1arms": smoke.G1ARMS[1],
                    **smoke.ARMS, **kp}.get(name) or smoke.BIPEDS[name][1]
            q0, ctrls = smoke.seeded_biped(m, seed, E)
        elif name == "a1pos":
            q0, ctrls = smoke.seeded_a1pos(m, E)
        else:
            q0, ctrls = {"a1": (qpos_a1, ctrls_a1),
                         "muscle": (qpos, ctrls_mu)}.get(name,
                                                         (qpos, ctrls_tq))
        d, ctrls = io.make_data(m, E).replace(qpos=t(q0)), t(ctrls)
        kernels.LAUNCHES.clear()
        d = fwd.forward(m, d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(steps):
            d = fwd.step_n(m, d.replace(ctrl=ctrls[c]), substeps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert dict(kernels.LAUNCHES) == {"mega_forward": 1,
                                          "megastep": steps}
        S = d.replace(ctrl=ctrls[0])
        ms = _time_ms(torch, lambda: hm.mega_step_n(m, S, substeps),
                      args.reps)
        line = {"config": name, "envs": E, "card": card,
                "env_steps_per_s": E * steps / wall,
                "megastep_ms": ms,
                "j_global": bool(getattr(tplan.mega_launch(m.plan),
                                         "j_global", False))}
        if args.kernels:
            line["mega_forward_ms"] = _time_ms(
                torch, lambda: hm.mega_forward(m, S), args.reps)
            staged = (fwd.stages(m, S) if m.na else
                      coll.collision(m, kinematics.kinematics(m, S)))
            line["fused_ms"] = _time_ms(
                torch, lambda: hf.fused_constraint(m, staged), args.reps)
        if phases:
            variant = ("LMT_PHASES",)
            wide = (kernels.width_defines(m.plan.nvm)
                    if hasattr(kernels, "width_defines") else ())
            lib = kernels.library("mega", hm._SIGNATURES, wide + variant)
            lib.lmt_mega_phases.argtypes = [kernels.PTR]
            buf = torch.zeros((E, ncol + 1), dtype=torch.int64,
                              device="cuda")
            kernels.check(lib.lmt_mega_phases(kernels.ptr(buf)), "phases")
            hm.mega_step_n(m, S, substeps, defines=variant)  # warm-up
            buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            hm.mega_step_n(m, S, substeps, defines=variant)
            end.record()
            torch.cuda.synchronize()
            cyc = buf[:, :len(PHASES)].sum(0).double()
            share = (cyc / cyc.sum()).tolist()
            line["variant_ms"] = start.elapsed_time(end)
            line["share"] = dict(zip(PHASES, share))
            line["phase_ms"] = {p: s * ms for p, s in zip(PHASES, share)}
            line["cycles_per_env"] = dict(zip(
                PHASES, (cyc / E).tolist()))
            if ncol > len(PHASES):  # the Newton solve's parts
                part = buf[:, len(PHASES):ncol].sum(0).double() / cyc[4]
                line["newton_share"] = dict(zip(NEWTON_PARTS,
                                                part.tolist()))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
