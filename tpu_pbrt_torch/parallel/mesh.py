"""Pixel sharding over a 1-D device mesh (port of
`tpu_pbrt/parallel/mesh.py`).

The scene and its tables are replicated, the pixels are split into one
share per shard, and each shard path-traces its share independently: no
per-bounce communication. The reference runs this under `shard_map`, one
controller driving every device. So does the port: `run_sharded` calls a
function once per shard, each in its own Python thread with the shard's
device current, and the shards meet at the collectives of their
`ShardContext` (`ppermute_down` / `ppermute_up`, `all_gather`, `psum`),
which rendezvous on a barrier. One shard runs at a time: it holds a baton
from one collective to the next and hands it on while it waits there.
The interpreter lock lets only one thread run Python anyway, and threads
that contend for it at every PyTorch operation make each launch several
times dearer (PERF.md, `app_sharded`). A tensor
crosses devices with `.to()`; on one device the exchange passes a
reference, and the shards share the device's current stream (correct and
serial).

A `Mesh` is an ordered tuple of devices, and a device may repeat: four
bands on one card is `make_mesh([torch.device("cuda", 0)] * 4)`, four on
the CPU `make_mesh([torch.device("cpu")] * 4)`. `make_mesh()` takes every
CUDA device and raises where there is none.

`split_rows` / `gather_rows` carry an App's `FrameHistory` between its
full-frame form and the sharded step's (`parallel/app_mesh.py`).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading

import torch
from torch import nn

from ..device import resolve
from ..ops.vec import Vec3
from ..passes import pathtrace
from ..render.camera import generate_rays

PIXEL_AXIS = "px"

# how long a shard waits at a collective for the others before the
# rendezvous breaks (a shard that raises breaks it at once)
COLLECTIVE_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shards' devices, in shard order (one may repeat)."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None) -> Mesh:
    """A 1-D mesh over `devices` (every CUDA device when None: raises
    where there is none). Naming CUDA without a card raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes every CUDA device and "
                "torch.cuda.is_available() is False; name the devices, "
                "e.g. [torch.device('cpu')] * n")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        d = resolve(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs))


class _Rendezvous:
    """What the shards of one `run_sharded` call share: the barrier, one
    slot a shard for the collectives, the baton a shard holds while it
    runs, and the first error."""

    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots = [None] * n
        self.baton = threading.Lock()
        self.lock = threading.Lock()
        self.error: BaseException | None = None

    def wait(self) -> None:
        """Meet the other shards, handing the baton on meanwhile."""
        self.baton.release()
        try:
            self.barrier.wait()
        finally:
            self.baton.acquire()

    def fail(self, err: BaseException) -> None:
        with self.lock:
            if self.error is None:
                self.error = err
        self.barrier.abort()


class ShardContext:
    """A shard's view of the mesh inside `run_sharded`: its `index`, the
    mesh `size`, its `device`, and the collectives. Every shard must call
    the same collectives in the same order."""

    def __init__(self, mesh: Mesh, index: int, rdv: _Rendezvous):
        self.index = index
        self.size = mesh.size
        self.device = mesh.devices[index]
        self._rdv = rdv

    def _exchange(self, x):
        """Every shard's `x`, in shard order (two barrier waits: the
        second keeps a fast shard from overwriting a slot still read)."""
        rdv = self._rdv
        rdv.slots[self.index] = x
        rdv.wait()
        out = list(rdv.slots)
        rdv.wait()
        return out

    def ppermute_down(self, x: torch.Tensor) -> torch.Tensor:
        """Send `x` to the next shard; returns what the previous one sent
        (zeros on shard 0), as `jax.lax.ppermute` with pairs (i, i + 1)."""
        got = self._exchange(x)
        if self.index == 0:
            return torch.zeros_like(x)
        return got[self.index - 1].to(self.device)

    def ppermute_up(self, x: torch.Tensor) -> torch.Tensor:
        """Send `x` to the previous shard; returns what the next one sent
        (zeros on the last), as `jax.lax.ppermute` with pairs (i + 1, i)."""
        got = self._exchange(x)
        if self.index == self.size - 1:
            return torch.zeros_like(x)
        return got[self.index + 1].to(self.device)

    def all_gather(self, x: torch.Tensor, tiled: bool = False):
        """Every shard's `x` on this shard's device: stacked on a new
        leading axis, or concatenated along axis 0 when `tiled`."""
        got = [t.to(self.device) for t in self._exchange(x)]
        return torch.cat(got) if tiled else torch.stack(got)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's `x` (in shard order, so every shard
        holds the same bits)."""
        got = self._exchange(x)
        total = got[0].to(self.device)
        for t in got[1:]:
            total = total + t.to(self.device)
        return total


def _device_scope(dev: torch.device):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def run_sharded(mesh: Mesh, fn, *per_shard_args) -> list:
    """Call `fn(ctx, *args)` once per shard, each in its own thread with
    the shard's device current, one shard running at a time (module
    docstring); `per_shard_args` are sequences with one entry a shard.
    Returns the results in mesh order. The first exception of any shard
    breaks the rendezvous (the others' collectives raise
    `threading.BrokenBarrierError`, a shard not yet started does not
    start) and is raised here."""
    n = mesh.size
    for a in per_shard_args:
        if len(a) != n:
            raise ValueError(f"{len(a)} per-shard arguments for {n} shards")
    rdv = _Rendezvous(n, COLLECTIVE_TIMEOUT_S)
    results = [None] * n

    def body(k: int) -> None:
        ctx = ShardContext(mesh, k, rdv)
        rdv.baton.acquire()
        try:
            if rdv.error is None:
                with _device_scope(ctx.device):
                    results[k] = fn(ctx, *(a[k] for a in per_shard_args))
        except BaseException as err:    # re-raised by the caller below
            rdv.fail(err)
        finally:
            rdv.baton.release()

    threads = [threading.Thread(target=body, args=(k,), daemon=True,
                                name=f"shard-{k}") for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if rdv.error is not None:
        raise rdv.error
    return results


def on_device(x, dev: torch.device):
    """`x` on `dev`: a tensor, a Vec3, a NamedTuple of them (at any
    depth), or a module (copied before it moves, so the original stays
    where it is). What is already there is passed through, not copied;
    anything else (None, a number) as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, Vec3):
        return x.map(lambda t: on_device(t, dev))
    if isinstance(x, nn.Module):
        here = next(iter(x.buffers()), None)
        if here is None or here.device == dev:
            return x
        return copy.deepcopy(x).to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(on_device(v, dev) for v in x))
    return x


def replicate(x, mesh: Mesh) -> list:
    """`x` on each shard's device (one copy a distinct device)."""
    per_dev: dict = {}
    for d in mesh.devices:
        if d not in per_dev:
            per_dev[d] = on_device(x, d)
    return [per_dev[d] for d in mesh.devices]


def render_sharded(tracer, env, light_count: int, cam, frame, *,
                   width: int, height: int,
                   settings: pathtrace.PathTraceSettings, mesh: Mesh):
    """One frame with the pixels sharded over `mesh`: shard k path-traces
    the W*H/n flat pixels g = l * n + k (l = 0 .. W*H/n - 1), its rays
    taken from the global pixel grid (the same NDC arithmetic as
    `generate_rays`) and its RNG streams keyed by global pixels. Returns
    ((H, W, 3) radiance and the rays traced, summed by `psum`), both on
    the mesh's first device.

    The reference gives each shard a contiguous block. Dealing pixels
    round robin instead keeps every fold of the compaction schedule
    (`_fold_half` pairs lane i with lane i + R/2 of the pool) pairing the
    same pixels as the unsharded frame, so the sharded frame equals it
    with folds too; without folds both layouts give every pixel the same
    value."""
    n = mesh.size
    if (width * height) % n:
        raise ValueError(f"pixel count {width * height} not divisible by "
                         f"mesh size {n}")
    r = width * height // n
    frame = int(frame) & 0xFFFFFFFF

    def shard(ctx, trc, env_k, cam_k):
        dev = ctx.device
        g = torch.arange(r, dtype=torch.int64, device=dev) * n + ctx.index
        px, py = g % width, g // width
        jit = cam_k.jitter
        ndc_x = (px.to(torch.float32) + 0.5 + jit[0]) / width * 2.0 - 1.0
        ndc_y = 1.0 - (py.to(torch.float32) + 0.5 + jit[1]) / height * 2.0
        o, d, t_min, t_max = generate_rays(cam_k, width, height,
                                           ndc=(ndc_x, ndc_y))
        rad, rays = pathtrace.render_sample_radiance(
            trc, env_k, light_count, o, d, t_min, t_max, px, py, frame,
            settings)
        return rad.to_tensor(), ctx.psum(rays)

    out = run_sharded(mesh, shard, replicate(tracer, mesh),
                      replicate(env, mesh), replicate(cam, mesh))
    dev0 = mesh.devices[0]
    img = torch.stack([rad.to(dev0) for rad, _ in out], 1)
    return img.reshape(height, width, 3), out[0][1]


# --- an App's history between its full-frame and its banded form ----------

def _bands(x, n: int, rows: int) -> list:
    """`x` (a tensor, Vec3 or NamedTuple of them) cut into n bands along
    axis 0; a tensor of another leading size than `rows` (the ReSTIR
    state's (1, 8) surface outside the pairwise modes) goes to every
    band whole."""
    if isinstance(x, torch.Tensor):
        return list(x.chunk(n)) if x.shape[0] == rows else [x] * n
    if isinstance(x, Vec3):
        parts = [_bands(c, n, rows) for c in (x.x, x.y, x.z)]
        return [Vec3(*p) for p in zip(*parts)]
    parts = [_bands(v, n, rows) for v in x]
    return [type(x)(*p) for p in zip(*parts)]


def _unband(parts: list, rows: int):
    """The inverse of `_bands`: bands of `rows` total rows joined along
    axis 0 (a tensor whose band size is not rows / n is taken from the
    first band)."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        if first.shape[0] * len(parts) == rows:
            return torch.cat([p.to(first.device) for p in parts])
        return first
    if isinstance(first, Vec3):
        return Vec3(*(_unband([getattr(p, c) for p in parts], rows)
                      for c in "xyz"))
    return type(first)(*(_unband([p[i] for p in parts], rows)
                         for i in range(len(first))))


def split_rows(history, mesh: Mesh):
    """A full-frame `FrameHistory` (`render/app.py`) in the sharded step's
    form: `restir` and `denoiser` as lists of per-band states (band k on
    mesh.devices[k]); `taa` and `sharc` whole, as they were."""
    n = mesh.size
    den = history.denoiser
    bands = _bands(den, n, den.depth.shape[0])
    restir = None
    if history.restir is not None:
        r = history.restir.depth.shape[0]
        restir = [on_device(b, d) for b, d in
                  zip(_bands(history.restir, n, r), mesh.devices)]
    return history._replace(
        denoiser=[on_device(b, d) for b, d in zip(bands, mesh.devices)],
        restir=restir)


def gather_rows(history, mesh: Mesh):
    """The inverse of `split_rows`: the full-frame `FrameHistory` on the
    mesh's first device."""
    dev0 = mesh.devices[0]
    den = history.denoiser
    rows = sum(b.depth.shape[0] for b in den)
    restir = None
    if history.restir is not None:
        r = sum(b.depth.shape[0] for b in history.restir)
        restir = on_device(_unband(history.restir, r), dev0)
    return history._replace(denoiser=on_device(_unband(den, rows), dev0),
                            restir=restir,
                            taa=on_device(history.taa, dev0),
                            sharc=on_device(history.sharc, dev0))


def jit_render_sharded(settings: pathtrace.PathTraceSettings, mesh: Mesh,
                       width: int, height: int):
    """`render_sharded` as the reference's closure: fn(tracer, scene, cam,
    frame) -> (image, rays) for a port `Scene` (its environment is moved
    to the tracer's device at each call, its light count read on the
    host). PyTorch runs eagerly: nothing is compiled, the name is the
    reference's."""
    def fn(tracer, scene, cam, frame):
        from ..models.scene import environment_tensors

        dev = tracer.shade_table.device
        env = environment_tensors(scene.environment, device=dev)
        return render_sharded(tracer, env, int(scene.lights.count), cam,
                              frame, width=width, height=height,
                              settings=settings, mesh=mesh)
    return fn
