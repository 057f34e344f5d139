"""The plain reference (`benchmark/plain`) against the port's CPU path at
64x48: the frames a run keeps from its window, rendered again by the
reference from the same scene inputs, agree to rounding; and the reference
imports nothing of the port."""

from __future__ import annotations

import ast
import sys

import pytest

from benchmark.tests.helpers import CELLS, REPO, small, small_run


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name):
    out = small_run(name, 2**31 + 5, limits=None)
    assert out["attempted"] >= 1
    got = {n: c["value"] for n, c in out["checks"].items()}
    assert got["px_off"] == 0.0 and got["rays_gap"] == 0.0
    assert got["mean_gap"] < 1e-6


def test_reference_imports_nothing_of_the_port():
    """The reference's sources import torch, numpy, the standard library
    and, relatively, the benchmark's own scene inputs (`scenes.py` and the
    scene kinds' modules, `kinds/`), which import no package at module
    level."""
    allowed = {"torch", "numpy", "__future__"} | set(sys.stdlib_module_names)
    paths = list((REPO / "benchmark" / "plain").glob("*.py"))
    paths += list((REPO / "benchmark" / "kinds").glob("*.py"))
    paths.append(REPO / "benchmark" / "scenes.py")
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert tops <= allowed, (path, tops)


@pytest.mark.cuda
def test_reference_agrees_with_the_port_on_the_card(card):
    import time

    import torch

    from benchmark import cells, check, run

    cell = small(cells.load("pt.cornell"))
    out = run.run_cell(cell, 3, 0.05, False, card, time.perf_counter(),
                       check.limits(cell.name, cell.root),
                       log=lambda s: None)
    assert out["correct"] is True
    torch.cuda.synchronize()
