"""PyTorch port vs `tpu_pbrt`: the App frame graph sharded over 4 bands of
6 rows (64x48 output, 32x24 internal), with the checks and tolerances of
`tests/test_torch_app_mesh.py` (its docstring has them). A file of its own
so that each of the two reference compiles runs in its own test process.
"""

import pytest

from test_torch_app_mesh import check_images, check_state, run_both


@pytest.fixture(scope="module")
def sharded():
    return run_both(4)


def test_sharded_app_matches_reference(sharded):
    check_images(sharded)


def test_sharded_app_state(sharded):
    check_state(sharded)
