#!/usr/bin/env python3
"""Registers, stack, spills and SASS instruction counts of the port's kernels.

    python3 tools/kernel_code.py [--root DIR]

Builds every kernel library of the checkout at DIR (default: this one)
with that checkout's own `ops/kernels.py` (`build_all()`: each source at
every nv width the checkout compiles), then prints one JSON line per
library and kernel function (its mangled name, without the anonymous
namespace's path hashes): its registers, stack frame and spill bytes
as ptxas reports them (`-Xptxas -v`, the build's `.ptxas` log; `smem`,
the static shared bytes where ptxas prints them) and the number of SASS
instructions `cuobjdump -sass` lists for it. Two checkouts' lines side by
side (an archive of a parent commit under `build/`, and this one) show
whether a change altered a kernel's code.

The warp-per-env kernels take their shared memory dynamically, per env,
from a launch census (`ops/plan.py`): for a checkout that has them it then
prints one JSON line per committed stand-in and kernel (the mega kernels'
`mega_launch`, the fused kernel's `fused_launch`) and for the standalone
Newton kernel at the two configurations without a plan that
`chip_smoke.py` drives (`solve_launch`): shared bytes per env, envs per
block, the resident warps per SM that shared memory allows and where the
rows' J lives. Where a card is present and the checkout has the one
plane-mesh kernel (`hopper_collision.mesh_slots`), it also prints its
launch per stand-in with a kernel-gated plane-mesh group (and the torque
humanoid at 34 slots): pairs, k, shared bytes per env, envs per block and
the resident warps per SM from the CUDA runtime. Needs the CUDA toolkit
(nvcc, cuobjdump); the card only for those last lines.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FN_PROPS = re.compile(r"Function properties for (\S+)")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SASS_FN = re.compile(r"Function : (\S+)")
_SASS_INSN = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+\S")
# the anonymous namespace's hashes in a mangled name depend on the source's
# path: dropped, so that two checkouts' functions compare by name
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?_cu)_[0-9a-f]{8}")


def kernel_name(mangled: str) -> str:
    """The mangled name without the anonymous namespace's hashes."""
    return _ANON.sub(r"_GLOBAL__N__\1", mangled)


def ptxas(log: str) -> dict:
    """Per kernel (and non-inlined device) function: registers, stack,
    spill stores and loads."""
    out, fn, props = {}, None, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            fn = props = m.group(1)
            out.setdefault(fn, {})
            continue
        m = _FN_PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        m = _PROPS.search(line)
        if m and props is not None:
            out.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_st=int(m.group(2)),
                spill_ld=int(m.group(3)))
        m = _REGS.search(line)
        if m and fn is not None:
            out[fn]["registers"] = int(m.group(1))
            m = _SMEM.search(line)
            if m:
                out[fn]["smem"] = int(m.group(1))
    return out


def sass_counts(so: Path) -> dict:
    """Per kernel function: the SASS instructions cuobjdump lists."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = _SASS_FN.search(line)
        if m:
            fn = m.group(1)
            out[fn] = 0
        elif fn is not None and _SASS_INSN.match(line):
            out[fn] += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    root = ap.parse_args().root.resolve()
    sys.path.insert(0, str(root))
    from loco_mujoco_tpu_torch.ops import kernels

    build_s = kernels.build_all()
    targets = (kernels.libraries() if hasattr(kernels, "libraries")
               else [(n, ()) for n in kernels.SOURCES])
    print(json.dumps({"root": str(root), "build_s": round(build_s, 1)}))
    for name, defines in targets:
        so, _ = kernels._target(name, defines)
        label = kernels._label(name, defines)
        regs = ptxas((kernels.build_dir() / f"{label}.ptxas").read_text())
        sass = sass_counts(so)
        for fn in sorted(set(regs) | set(sass)):
            print(json.dumps({"library": label, "function": kernel_name(fn),
                              **regs.get(fn, {}),
                              "sass": sass.get(fn)}))
    census(root)
    return 0


def census(root: Path) -> None:
    """The launch census lines (see the module note) of the checkout at
    root, as far as it has the census functions."""
    import torch

    from loco_mujoco_tpu_torch.core import io
    from loco_mujoco_tpu_torch.ops import constraint, forward
    from loco_mujoco_tpu_torch.ops import hopper_newton as hn
    from loco_mujoco_tpu_torch.ops import plan as tplan

    def line(kernel, model, launch):
        print(json.dumps({
            "census": kernel, "model": model,
            "shared_bytes_per_env": 4 * launch.env_floats,
            "envs_per_block": launch.envs_per_block,
            "resident_warps": launch.resident_warps,
            "j_global": bool(getattr(launch, "j_global", False))}))

    from loco_mujoco_tpu_torch.ops import hopper_collision as hc

    mesh = hasattr(hc, "occupancy") and torch.cuda.is_available()

    def mesh_line(model, name):
        for mk in model.mesh_kernel:
            if mk is not None:
                print(json.dumps({
                    "census": "mesh_slots", "model": name, "pairs": mk.P,
                    "k": mk.k, "shared_bytes_per_env": hc.shared_bytes(mk),
                    "envs_per_block": hc.ENVS_PER_BLOCK,
                    "resident_warps": hc.occupancy(mk)}))

    assets = root / "loco_mujoco_tpu_torch" / "assets"
    for npz in sorted(assets.glob("*.npz")):
        model = io.load_model_npz(npz, device="cpu")
        if mesh:
            mesh_line(model, npz.stem)
        plan = model.plan
        if plan is None:
            continue
        if plan.mega:
            line("mega", npz.stem, tplan.mega_launch(plan))
        if hasattr(tplan, "fused_launch"):
            line("fused", npz.stem, tplan.fused_launch(plan))
    if not hasattr(tplan, "solve_launch"):
        return
    for stem, change in (("humanoid_torque_shape", {"contact_k_plane": 34}),
                         ("unitree_g1_arms_shape", {"contact_k_plane": 20})):
        leaves, aux = io.read_model_npz(assets / f"{stem}.npz")
        aux.update(change)
        m = io.model_from_numpy(leaves, aux, device="cpu",
                                dtype=torch.float32)
        if mesh and stem.startswith("humanoid"):
            mesh_line(m, f"{stem} (34 slots)")
        efc = constraint.make_constraint(m, forward.fwd_position(
            m, io.make_data(m, 1), plain=True))
        ne, nfl = hn.row_class_counts(efc.is_bilateral, efc.is_fl)
        line("newton", f"{stem} (no plan)",
             tplan.solve_launch(m.nv, efc.J.shape[1], ne, nfl))


if __name__ == "__main__":
    sys.exit(main())
