"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Each `csrc/*.cu` file compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface, loaded through ctypes (no PyTorch headers: the build takes
seconds). The build runs at first use, from the checkout's sources only,
into `tpu_pbrt_torch/_build/` (git-ignored); the library's file name carries
a hash of the sources, headers and flags, so an edited source is never
served from a stale build.

`-fmad=false` and no `--use_fast_math`: every kernel then rounds op for op
like its plain PyTorch version on the card (each PyTorch op is its own
kernel, so nothing is contracted into an FMA there either), and triangle
ids, hit keys and occlusion can be compared exactly. Division and sqrt stay
IEEE (`-prec-div=true -prec-sqrt=true` are nvcc's defaults without fast
math); `rsqrtf` is the one approximate op, in the bounce fetch.

Each `Kernel` keeps a plain integer launch count, incremented only where
its wrapper launches it, and the same count split by the wrapper's `tag`
(the row fetch tags a launch with its table width and slot count, the
dense sweeps, the bounce fetch and the fused kernel with their ray
count).

Shard threads (`parallel/mesh.run_sharded`) may launch at once: the first
use builds and loads the library under a lock, and a launch goes to its
tensors' device and that device's current stream, whichever device is the
thread's current one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()         # one build and load per process
build_seconds: float | None = None   # wall time of this process's build
build_log: str = ""                  # nvcc's output (ptxas register report)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtpu_pbrt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the build directory unless this exact build
    is already there (one nvcc per source, run in parallel, then one link);
    returns the library path."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(_sources(), objs)]
    logs, failed = [], []
    for src, proc in zip(_sources(), procs):
        stdout, stderr = proc.communicate()
        logs.append(f"== {src.name}\n{stdout}{stderr}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *(str(o) for o in objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use; threads that ask at
    once wait for the one build)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tpb_error_string.argtypes = [ctypes.c_int]
            lib.tpb_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch_device(tensors) -> torch.device:
    """The one device of a launch's tensor arguments (a thread's current
    device may be another); raises if they span devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("kernel arguments span devices "
                         f"{sorted(map(str, devices))}")
    return devices.pop()


class Kernel:
    """One hand-written kernel: its C entry point `tpb_<name>`, where its
    source lives, which TPU kernel it replaces, and its launch count.
    `launches` and `launches_by_tag` are plain counters bumped under the
    interpreter lock: they count the launches of every shard thread."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.launches_by_tag: dict = {}

    def launch(self, *args, tag=None) -> None:
        """Launch on the tensor arguments' device (`launch_device`), made
        current for the call, on its current stream. Tensors pass as device
        pointers, floats as C floats, ints as C ints (the C signature lists
        them in this order, then the stream; None passes a null pointer);
        raises on a nonzero cudaGetLastError(). `tag` (hashable) files the
        launch under `launches_by_tag` as well."""
        c_types = [ctypes.c_void_p if a is None or isinstance(a, torch.Tensor)
                   else ctypes.c_float if isinstance(a, float)
                   else ctypes.c_int for a in args]
        fn = getattr(library(), "tpb_" + self.name)
        fn.argtypes = [*c_types, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor)
                  else None if a is None
                  else a if isinstance(a, float) else int(a) for a in args]
        dev = launch_device([a for a in args if isinstance(a, torch.Tensor)])
        with torch.cuda.device(dev):
            err = fn(*c_args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            msg = library().tpb_error_string(err).decode()
            raise RuntimeError(f"kernel {self.name} launch failed: {msg}")
        self.launches += 1
        if tag is not None:
            self.launches_by_tag[tag] = self.launches_by_tag.get(tag, 0) + 1


KERNELS: dict[str, Kernel] = {}


def register(name: str, source: str, replaces: str) -> Kernel:
    k = Kernel(name, source, replaces)
    KERNELS[name] = k
    return k


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.launches_by_tag.clear()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
          device: torch.device | None = None) -> None:
    """Wrapper-side argument check: CUDA device, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
