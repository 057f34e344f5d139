"""How `correct` is decided: the frames the timed window produced, held
against the plain reference (`benchmark/plain`), which renders the same
frames from the same scene inputs.

Numbers compared, each the worst over the compared frames (`compare`):

* `px_off`: the share of pixels where some channel differs from the
  reference's by more than ATOL + RTOL |reference|, or is not finite;
* `mean_gap`: the gap between the two images' sums over the sum of the
  reference's magnitudes (a bias of the whole frame);
* `rays_gap`: the gap between the counted rays over the reference's.

Each cell's limits are data: `limits/<cell>.json`, with the readings they
were set from. The control (`rounded_bf16`) is the reference computed with
every float32 result rounded to bfloat16, the nearest precision below the
float32 the renderer states.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from . import cells

HERE = Path(__file__).resolve().parent
ATOL = RTOL = 1e-3
NUMBERS = ("px_off", "mean_gap", "rays_gap")


def _clamped(index, size: int, wrap: bool):
    """An index tensor clamped into a dimension of `size` ([-size, size)
    where negative indices wrap)."""
    if index is None or index.dtype == torch.bool:
        return index
    return index.clamp(-size if wrap else 0, size - 1)


def _in_range(func, args):
    """`args` with the index tensors of an indexing op clamped into range:
    rounded coordinates can land one past the end of a table or image."""
    aten = torch.ops.aten
    if func in (aten.index.Tensor, aten.index_put.default,
                aten.index_put_.default, aten._index_put_impl_.default):
        self, indices = args[0], args[1]
        return (self, [_clamped(i, self.shape[d], True)
                       for d, i in enumerate(indices)], *args[2:])
    if func in (aten.index_select.default, aten.gather.default,
                aten.scatter.src, aten.scatter.value, aten.scatter_.src,
                aten.scatter_.value, aten.scatter_add.default,
                aten.scatter_add_.default, aten.index_add.default,
                aten.index_add_.default, aten.scatter_reduce.two,
                aten.scatter_reduce_.two):
        self, dim, index = args[0], args[1], args[2]
        return (self, dim, _clamped(index, self.shape[dim], False),
                *args[3:])
    if func is aten.take.default:
        return (args[0], _clamped(args[1], args[0].numel(), True))
    return args


class rounded_bf16(TorchDispatchMode):
    """Every float32 result rounded to bfloat16 (kept in float32 storage):
    the control. A result that aliases an input (a view) is left as it
    is; an in-place result is rounded in place. Indices that the rounded
    arithmetic pushes out of range are clamped into it (`_in_range`), so
    that the control gives numbers instead of stopping on a device
    assert."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        args = _in_range(func, args)
        out = func(*args, **kwargs)
        leaves, _ = tree_flatten((args, kwargs))
        ptrs = {a.untyped_storage().data_ptr() for a in leaves
                if isinstance(a, torch.Tensor)}
        mutable = func._schema.is_mutable

        def fix(t):
            if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
                return t
            rounded = t.to(torch.bfloat16).to(torch.float32)
            if t.untyped_storage().data_ptr() in ptrs:
                if mutable:
                    t.copy_(rounded)
                return t
            return rounded
        return tree_map(fix, out)


def reference_frames(cell: cells.Cell, device, first: int, steps,
                     rounded: bool = False) -> dict:
    """The reference's frames at step indices `steps` from frame `first`
    (a skinned scene posed after step + 1 advances of its clip, as the
    animated renderer advances before each frame): {step: (image on the
    host, rays)}. `rounded`: the control."""
    from .plain import render, scene, trace

    src = scene.SceneSource(cell.traffic["scene"], cell.root, device,
                            cell.traffic["dt"])
    settings = {**cell.config["pathtrace"], **cell.traffic["pathtrace"]}
    out, boxes = {}, None
    with torch.no_grad():
        for k in sorted(set(steps)):
            sc = src.at(k + 1)
            if boxes is None or sc is not src.static:
                boxes = trace.Boxes(sc.positions)
            with (rounded_bf16() if rounded else contextlib.nullcontext()):
                img, rays = render.render(
                    sc, boxes, cell.traffic["camera"], cell.width,
                    cell.height, (first + k) & 0xFFFFFFFF, settings)
            out[k] = (img.float().cpu(), float(rays))
            del img, sc
    return out


def numbers(img, rays: float, ref_img, ref_rays: float) -> dict:
    """The compared numbers of one frame."""
    a = img.double()
    b = ref_img.double()
    off = ~torch.isfinite(a) | ((a - b).abs() > ATOL + RTOL * b.abs())
    px = off.reshape(-1, off.shape[-1]).any(-1)
    scale = float(b.abs().sum())
    return {"px_off": float(px.double().mean()),
            "mean_gap": (abs(float(torch.nan_to_num(a, nan=1e30).sum())
                             - float(b.sum())) / scale if scale > 0 else
                         float(not torch.equal(a, b))),
            "rays_gap": abs(rays - ref_rays) / max(abs(ref_rays), 1.0)}


def compare(frames: dict, ref: dict) -> dict:
    """The worst of each number over the compared frames ({step: (image,
    rays)} on both sides)."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    for k, (img, rays) in frames.items():
        got = numbers(img, rays, *ref[k])
        for n in NUMBERS:
            worst[n] = max(worst[n], got[n])
    return worst


def limits(cell: str, root: Path = HERE) -> dict:
    """{number: limit} of a cell (`limits/<cell>.json`)."""
    spec = json.loads((root / "limits" / f"{cell}.json").read_text())
    return {n: float(spec[n]["limit"]) for n in NUMBERS}


def verdict(worst: dict, lim: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct when every number
    is at most its limit (a NaN is not)."""
    shown = {n: {"value": worst[n], "limit": lim[n]} for n in NUMBERS}
    return all(worst[n] <= lim[n] for n in NUMBERS), shown
