"""PyTorch/CUDA port of loco_mujoco_tpu's physics engine for NVIDIA Hopper.

The staged, batched physics step (`ops.forward.step`) over a leading env
axis, with hand-written Hopper kernels (`csrc/`) for the Newton solve, the
fused constraint stage and a plane-mesh group's contact slots (select and
top-K in one launch); the mega path (`ops.forward.forward` and
`ops.forward.step_n`, one kernel each) and the env layer over it
(`envs.base.LocoEnv`, with joint-damping randomization as per-env kernel
operands, and stacked model variants and the other randomized leaves as
per-env Model leaves). Models arrive as `.npz` files of the JAX package's model arrays
(`core.io.load_model_npz`). Entry points run on the card unless the caller
passes `device="cpu"`. This package imports neither `jax` nor
`loco_mujoco_tpu`.
"""
