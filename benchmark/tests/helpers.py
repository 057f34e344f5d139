"""Shared pieces of the benchmark's CPU tests."""

from __future__ import annotations

import time
from pathlib import Path

import torch

from benchmark import cells, check, run

REPO = Path(__file__).resolve().parents[2]
CELLS = ("pt.cornell", "pt.tube-animated", "pt.helmet-100k")
SMALL = (64, 48)


def small(cell: cells.Cell) -> cells.Cell:
    """The cell at 64x48: every other setting as the cell's files give
    it."""
    cell.config["width"], cell.config["height"] = SMALL
    return cell


def small_run(name: str, seed: int, limits="cell", repo: Path = REPO,
              trace: bool = False) -> dict:
    """A run of cell `name` at 64x48 on the CPU, past the look for a card:
    a window of a few frames, the kept frames held against the reference
    with the cell's limits (or `limits`)."""
    cell = small(cells.load(name, repo))
    lim = check.limits(cell.name, cell.root) if limits == "cell" else limits
    torch.manual_seed(0)
    return run.run_cell(cell, seed, 0.05, trace, torch.device("cpu"),
                        time.perf_counter(), lim, log=lambda s: None)
