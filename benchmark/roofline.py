"""The least time the chip could take for a hand-written kernel's work: a
frozen copy of `chip_smoke.py`'s `bound` and `closest_bound`, its any-hit
sweep bound and its byte counts of K3 (the bounce fetch) and K4 (the row
fetch), kept here so that a change to the program cannot change them.

The bound is the larger of the bytes (each input read once, each output
written once) over the peak HBM rate and the FP32 arithmetic over the peak
FP32 rate outside the tensor cores, of one NVIDIA H100 SXM (NVIDIA's data
sheet, at its full 700 W). Operations are counted on live lanes only: the
work the function needs on these inputs, whatever computes it. The row
fetches count the rows their slots reference, each read once.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# FP32 adds, subtracts, multiplies and divides per ray-triangle test
# (compares and selects not counted): kernel 1 (one division per test),
# kernel 2 (det-scaled, no division); and per ray for the bounce-row unpack
FLOPS_TEST_DIV = 46
FLOPS_TEST_SCALED = 48
FLOPS_UNPACK = 110
# rows of kernel 3's output block (`shade_table.FB_OUT`)
FB_OUT = 23


def bound(nbytes: float, flops: float) -> dict:
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def closest_bound(rays: int, live: int, table_rows: int,
                  triangles: int) -> dict:
    """Kernel 1, the dense closest-hit sweep: 32 bytes a ray in, 8 out,
    36 bytes a table row; FLOPS_TEST_DIV per live lane and triangle."""
    return bound(rays * 32 + rays * 8 + table_rows * 36,
                 live * triangles * FLOPS_TEST_DIV)


def any_bound(rays: int, live: int, occluded: int, table_rows: int,
              triangles: int) -> dict:
    """Kernel 2, the dense any-hit sweep: 32 bytes a ray in, a flag out,
    40 bytes a table row; a live lane that is not occluded tests every
    triangle, an occluded one at least one."""
    return bound(rays * 32 + rays + table_rows * 40,
                 ((live - occluded) * triangles + occluded)
                 * FLOPS_TEST_SCALED)


def fetch_rows_bound(slots: int, rows_read: int, columns: int) -> dict:
    """Kernel 4: 4 bytes a slot, each referenced row of `columns` floats
    once, `columns` floats out a slot."""
    return bound(rows_read * columns * 4 + slots * 4 + slots * columns * 4,
                 0.0)


def fetch_bounce_bound(slots: int, rows_read: int, row_floats: int) -> dict:
    """Kernel 3: the slot and the ray (4 + 24 bytes) in, each referenced
    sub-table row once, FB_OUT floats out; FLOPS_UNPACK a lane."""
    return bound(rows_read * row_floats * 4 + slots * 4 + slots * 24
                 + slots * FB_OUT * 4, slots * FLOPS_UNPACK)
