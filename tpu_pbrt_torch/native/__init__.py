"""Native host builders (C++ through ctypes) for the asset and build
pipeline (port of `tpu_pbrt/native`, with its own copy of `hostops.cpp`).

`lib()` compiles `hostops.cpp` with g++ at first use into the git-ignored
`tpu_pbrt_torch/_build/` (under `ops/cuda.py`'s build lock; the file name
carries a hash of the source and flags, so an edited source is never served
from a stale build) and loads it. As in the reference, every wrapper
returns None when the library cannot be built or loaded, and its caller
keeps the numpy version: these are host builders, not a device path, and
both give the same bits:

  * `morton_order`: the stable Morton argsort of triangle centroids,
    `traverse_resident.prepare`'s order;
  * `block_bounds`: per-block AABBs over Morton-ordered triangles;
  * `mip_downsample`: one level of `texture_io.build_mip_chain`'s box
    filter (the four taps summed in row-major order, then / 4; the sum
    starts from -0.0, where the reference's copy starts from +0.0 and turns
    a texel of four -0.0 taps into +0.0);
  * `pack_level_quads`: `texture._pack_level_quads`'s RGBA8 quad rows.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..ops import cuda

SOURCE = Path(__file__).resolve().parent / "hostops.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: ctypes.CDLL | None = None
_tried = False
build_error: str | None = None     # why the last build or load failed


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return cuda.BUILD_DIR / f"libhostops_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise OSError("g++ not found")
    cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"g++ failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL | None:
    """The loaded native library, or None if it cannot be built (tried
    once a process)."""
    global _lib, _tried, build_error
    with cuda._lib_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            L = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError) as e:
            build_error = str(e)
            return None
        L.morton_order.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int64, ctypes.c_void_p]
        L.block_bounds.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_int32] + [ctypes.c_void_p] * 2
        L.mip_downsample.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        L.pack_level_quads.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p]
        for fn in (L.morton_order, L.block_bounds, L.mip_downsample,
                   L.pack_level_quads):
            fn.restype = None
        _lib = L
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _corners(*arrays):
    out = [np.ascontiguousarray(a, np.float32) for a in arrays]
    if any(a.ndim != 2 or a.shape[1] != 3 or a.shape != out[0].shape
           for a in out):
        raise ValueError("expected equal (N, 3) corner arrays")
    return out


def morton_order(v0: np.ndarray, v1: np.ndarray,
                 v2: np.ndarray) -> np.ndarray | None:
    """Stable Morton-code argsort (int32) of triangle centroids within
    their bounds, or None."""
    L = lib()
    if L is None:
        return None
    v0, v1, v2 = _corners(v0, v1, v2)
    out = np.empty((v0.shape[0],), np.int32)
    L.morton_order(_ptr(v0), _ptr(v1), _ptr(v2), v0.shape[0], _ptr(out))
    return out


def block_bounds(sv0, sv1, sv2, sid, block: int):
    """(nb, 3) min / max AABBs over `block`-sized groups of the slots with
    sid >= 0 (an empty block gives +inf / -inf), or None."""
    L = lib()
    if L is None:
        return None
    sv0, sv1, sv2 = _corners(sv0, sv1, sv2)
    sid = np.ascontiguousarray(sid, np.int32)
    if sid.shape != (sv0.shape[0],) or sv0.shape[0] % block:
        raise ValueError("sid must be (N,), N a multiple of block")
    nb = sv0.shape[0] // block
    bmin = np.empty((nb, 3), np.float32)
    bmax = np.empty((nb, 3), np.float32)
    L.block_bounds(_ptr(sv0), _ptr(sv1), _ptr(sv2), _ptr(sid),
                   sv0.shape[0], block, _ptr(bmin), _ptr(bmax))
    # empty blocks keep the +-3e38 sentinels: numpy's inf form
    bmin[bmin >= 3e38] = np.inf
    bmax[bmax <= -3e38] = -np.inf
    return bmin, bmax


def mip_downsample(src: np.ndarray) -> np.ndarray | None:
    """One box-filtered mip level of an (H, W, C) f32 image, or None."""
    L = lib()
    if L is None:
        return None
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim != 3:
        raise ValueError(f"expected (H, W, C), got {src.shape}")
    h, w, ch = src.shape
    dst = np.empty((max(h // 2, 1), max(w // 2, 1), ch), np.float32)
    L.mip_downsample(_ptr(src), h, w, ch, _ptr(dst))
    return dst


def pack_level_quads(level: np.ndarray, wrap_repeat: bool,
                     srgb: bool) -> np.ndarray | None:
    """(H*W, 4) u32 RGBA8 quad rows of a LINEAR (H, W, 4) level, or
    None."""
    L = lib()
    if L is None:
        return None
    level = np.ascontiguousarray(level, np.float32)
    if level.ndim != 3 or level.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4), got {level.shape}")
    h, w = level.shape[:2]
    out = np.empty((h * w, 4), np.uint32)
    L.pack_level_quads(_ptr(level), h, w, int(wrap_repeat), int(srgb),
                       _ptr(out))
    return out
