"""Env-major <-> env-last relayouts around the Hopper kernels.

Counterpart of `loco_mujoco_tpu/ops/pallas_layout.py` (`_t2d_kernel`,
`_tg_kernel`, `_fg_kernel`). Every entry point runs one kernel,
`csrc/layout.cu`, which relays a list of up to `MAX_ARRAYS` float32
(R, C) arrays to their (C, R) transposes in one launch: on Hopper the
grouped (K, R, 128) env layout of the TPU has no purpose, so
`to_grouped`/`from_grouped` are the plain (E, K) <-> (K, E) transpose, as
`moveaxis0_last`/`moveaxis_last0` are.

Each entry point has a list form (`moveaxis0_last_many(*xs)`, ...) that
relays all of a call site's arrays in one launch and returns their
results in order; the one-array form is its case of one. Each keeps its
own launch count (`kernels.LAUNCHES`, one per launch), so a run shows
which call sites went through the kernel.

On CUDA tensors a list form checks its operands once (float32,
contiguous, one device, at most `MAX_ARRAYS`; else it raises), allocates
the outputs as one buffer cut into views at 16-byte offsets (the
kernel's float4 stores), and launches. On CPU tensors it takes the plain
version, `transpose_plain` of each array.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from . import kernels
from .kernels import INT, PTR

MAX_ARRAYS = 16  # csrc/layout.cu kMaxArrays
# (x, y, R, C) of each array as 64-bit ints, the count, the stream
_SIGNATURES = {"lmt_transpose_many": [ctypes.c_char_p, INT, PTR]}


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (R, C) -> (C, R), contiguous."""
    return x.t().contiguous()


def _first_to_last(x):
    """(R, C, output shape) of (E, *rest) -> (*rest, E)."""
    s = x.shape
    E = s[0]
    return E, x.numel() // E if E else 0, (*s[1:], E)


def _last_to_first(x):
    """(R, C, output shape) of (*rest, E) -> (E, *rest)."""
    s = x.shape
    E = s[-1]
    return x.numel() // E if E else 0, E, (E, *s[:-1])


def _to_grouped(x):
    E, K = x.shape
    return E, K, (K, E)


def _from_grouped(x):
    K, E = x.shape
    return K, E, (E, K)


def check(role: str, xs) -> None:
    """The kernel's operands: CUDA tensors on one device, float32,
    contiguous, at most MAX_ARRAYS of them."""
    if len(xs) > MAX_ARRAYS:
        raise ValueError(f"{role}: {len(xs)} arrays, at most {MAX_ARRAYS} "
                         f"per launch")
    dev = xs[0].get_device()
    for x in xs:
        if not x.is_cuda or x.get_device() != dev:
            raise ValueError(f"{role}: expected CUDA tensors on one device")
        if x.dtype != torch.float32:
            raise TypeError(f"{role}: expected torch.float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{role}: expected contiguous tensors")


def _strides(shape) -> list:
    """Row-major strides of `shape`."""
    strides, n = [], 1
    for d in reversed(shape):
        strides.append(n)
        n *= d
    return strides[::-1]


def outputs(like: torch.Tensor, dims) -> list:
    """The outputs of `dims` ((R, C, shape) each), on `like`'s device and
    in its dtype: views of one buffer, each starting at a multiple of 4
    floats (one `as_strided` a view: a slice and a view cost twice)."""
    views, total = [], 0
    for R, C, shape in dims:
        views.append((shape, total))
        total += (R * C + 3) & ~3
    flat = like.new_empty(total)
    return [flat.as_strided(shape, _strides(shape), offset)
            for shape, offset in views]


def launch(role: str, xs, ys, dims) -> None:
    """One launch of the kernel over the operands xs into ys."""
    args = []
    for x, y, (R, C, _) in zip(xs, ys, dims):
        args += (x.data_ptr(), y.data_ptr(), R, C)
    lib = kernels.library("layout", _SIGNATURES)
    rc = lib.lmt_transpose_many(struct.pack(f"{len(args)}q", *args),
                                len(xs), kernels.stream())
    kernels.check(rc, role)
    kernels.LAUNCHES[role] += 1


def _relayout(role: str, xs, dims_of) -> list:
    if not xs:
        return []
    dims = [dims_of(x) for x in xs]
    if not xs[0].is_cuda:
        if any(x.is_cuda for x in xs):
            raise ValueError(f"{role}: expected tensors on one device")
        return [transpose_plain(x.reshape(R, C)).reshape(shape)
                for x, (R, C, shape) in zip(xs, dims)]
    check(role, xs)
    ys = outputs(xs[0], dims)
    launch(role, xs, ys, dims)
    return ys


def moveaxis0_last_many(*xs: torch.Tensor) -> list:
    """(E, *rest) -> (*rest, E) for each of xs, in one launch."""
    return _relayout("moveaxis0_last", xs, _first_to_last)


def moveaxis_last0_many(*xs: torch.Tensor) -> list:
    """(*rest, E) -> (E, *rest) for each of xs, in one launch."""
    return _relayout("moveaxis_last0", xs, _last_to_first)


def to_grouped_many(*xs: torch.Tensor) -> list:
    """(E, K) env-major -> (K, E) env-last (the TPU's (K, R, 128) with the
    (R, 128) split dropped) for each of xs, in one launch."""
    return _relayout("to_grouped", xs, _to_grouped)


def from_grouped_many(*xs: torch.Tensor) -> list:
    """(K, E) env-last -> (E, K) env-major, the inverse of `to_grouped`,
    for each of xs, in one launch."""
    return _relayout("from_grouped", xs, _from_grouped)


def moveaxis0_last(x: torch.Tensor) -> torch.Tensor:
    """(E, *rest) -> (*rest, E)."""
    return moveaxis0_last_many(x)[0]


def moveaxis_last0(x: torch.Tensor) -> torch.Tensor:
    """(*rest, E) -> (E, *rest)."""
    return moveaxis_last0_many(x)[0]


def to_grouped(x: torch.Tensor) -> torch.Tensor:
    """(E, K) -> (K, E); see `to_grouped_many`."""
    return to_grouped_many(x)[0]


def from_grouped(x: torch.Tensor) -> torch.Tensor:
    """(K, E) -> (E, K); see `from_grouped_many`."""
    return from_grouped_many(x)[0]


def moveaxis0_last_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.movedim(x, 0, -1).contiguous()


def moveaxis_last0_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.movedim(x, -1, 0).contiguous()
