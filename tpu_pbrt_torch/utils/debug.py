"""Numerical sanitizer: stop at the first pass whose output is not finite
(port of `tpu_pbrt/utils/debug.py`).

The reference turns on `jax_debug_nans`, which re-runs the op that made a
NaN and raises with its source location. PyTorch has no such switch for a
forward pass (`torch.autograd.detect_anomaly` checks backward passes only),
so here the `Renderer`'s and the `App`'s passes call `check_finite` on
their outputs, which raises naming the pass when any value is NaN or
infinite. Off by default: each check reads the device from the host (a
sync a pass), so never turn it on for timed frames. On with
`enable_debug()` or the environment variable TPU_PBRT_DEBUG_NANS=1 (read
by `maybe_enable_from_env`, which the `Renderer` and `App` call when they
are built).

The frame graph never donates or reuses history buffers in place: the
`FrameHistory` is both read and carried, as in the reference.
"""

from __future__ import annotations

import os

import torch

_CHECK_NANS = False


def enable_debug(nans: bool = True) -> None:
    """Turn the NaN check on (or off, with nans=False)."""
    global _CHECK_NANS
    _CHECK_NANS = bool(nans)


def maybe_enable_from_env() -> bool:
    """Honor TPU_PBRT_DEBUG_NANS=1; returns whether the check is on."""
    if os.environ.get("TPU_PBRT_DEBUG_NANS") == "1":
        enable_debug()
    return _CHECK_NANS


def check_finite(name: str, *values) -> None:
    """With the check on, raise FloatingPointError naming the pass `name`
    if any of `values` (tensors, or Vec3s of tensors) holds a NaN or an
    infinity; with it off, do nothing (no device read)."""
    if not _CHECK_NANS:
        return
    for v in values:
        parts = (v.x, v.y, v.z) if hasattr(v, "x") else (v,)
        for t in parts:
            if not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"non-finite values out of the {name!r} pass")
