#!/usr/bin/env python3
"""Hold the A1 mega forward against its plain version per env, on one GPU.

    python3 tools/a1_forward_check.py [ROOT]

At `tests/test_torch_a1_fixture.a1_states`' seeded states of the committed
A1-shaped model (256 envs, the card tests' `test_a1_mega_forward_matches_plain`
states, and 4096), it runs `forward.forward` (the mega forward kernel) and
`hopper_mega.mega_forward_plain` replaying the kernel's Newton decisions, and
prints one JSON line per env count: the largest per-env error of qacc,
qfrc_constraint and efc_force_contact relative to the plain version's largest
value (envs whose active contact sets agree), the envs past rel 5e-4, and how
many of them `chip_smoke._newton_witness` finds apart and settles (it prints
each apart env's distance from the float64 solve that replays the kernel's
decisions, for the kernel and for the plain version). ROOT: the checkout whose
port runs (default: this one).
"""

import json
import sys
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parent.parent).resolve()
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from loco_mujoco_tpu_torch.core import io
    from loco_mujoco_tpu_torch.ops import forward as fwd
    from loco_mujoco_tpu_torch.ops import hopper_mega as hm
    from loco_mujoco_tpu_torch.ops import kernels
    from test_torch_a1_fixture import ASSET, a1_states

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    m = io.load_model_npz(ASSET, device="cuda")
    for n in (256, 4096):
        qpos, qvel, ctrl = a1_states(io.load_model_npz(ASSET, device="cpu"),
                                     n)
        t = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                      device="cuda")
        d = io.make_data(m, n).replace(qpos=t(qpos), qvel=t(qvel),
                                       ctrl=t(ctrl))
        k = fwd.forward(m, d)
        r = hm.mega_forward_plain(m, d, replay=(
            k.solver_niter, k.solver_taken, k.solver_ls, k.solver_rows))
        same = torch.all((k.contact.dist < k.contact.includemargin)
                         == (r.contact.dist < r.contact.includemargin), dim=1)
        bad = torch.zeros(n, dtype=torch.bool, device="cuda")
        errs = {}
        for f in ("qacc", "qfrc_constraint", "efc_force_contact"):
            a, b = getattr(k, f), getattr(r, f)
            err = (a - b).abs().reshape(n, -1).amax(1) / float(b.abs().max())
            errs[f] = float(err[same].max())
            bad |= (err > 5e-4) & same
        apart, wit = chip_smoke._newton_witness(torch, m, d, k, r, envs=same)
        print(json.dumps({"envs": n, "errs": errs,
                          "past_5e-4": bad.nonzero().flatten().tolist()[:20],
                          "apart": int(apart.sum()),
                          "settled": int((apart & wit).sum())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
