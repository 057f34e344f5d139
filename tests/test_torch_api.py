"""Every module and top-level public name of `tpu_pbrt` has its counterpart
in `tpu_pbrt_torch`, but for an explicit list of TPU-only switches and
modules, each with its reason.

The reference's names are read with `ast` (its modules import JAX, and
nothing of it is imported for this walk): functions, classes and assigned
names at module level that do not start with `_`. The port's modules are
imported and asked for each name."""

import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = REPO / "tpu_pbrt"

# (module, name) or (module, None) for a whole module: left out by rule
TPU_ONLY = {
    # the culled tracer's TPU design: the port computes its function on the
    # resident walk's exact-key mode, with none of these schedules
    ("ops.traverse_culled", "U1"): "pass-1 working-set blocks per chunk",
    ("ops.traverse_culled", "U2"): "cascade pass-2 working-set blocks",
    ("ops.traverse_culled", "GROUP"): "chunks per XLA map step",
    ("ops.traverse_culled", "SUPER"): "blocks per superblock pre-level",
    ("ops.traverse_culled", "KS_EXTRA"): "superblock pre-level slack",
    ("ops.traverse_culled", "PRESELECT"): "superblock pre-level switch",
    ("ops.traverse_culled", "RANK"): "pass-1 block ranking switch",
    ("ops.traverse_culled", "ANY_RANK"): "any-hit block ranking switch",
    ("ops.traverse_culled", "CASCADE_GATHER"): "cascade compaction switch",
    ("ops.traverse_culled", "QUERY_GATHER"): "query head-gather switch",
    ("ops.traverse_culled", "MT_MXU"): "Möller-Trumbore on the MXU",
    ("ops.traverse_culled", "COLS"): "columns of the one-hot fetch table",
    ("ops.traverse_culled", "CHUNK"): "rays per vector-lane chunk",
    # switches and layouts of the TPU's kernels and XLA schedules
    ("ops.traverse_dense", "MT_MXU"): "Möller-Trumbore on the MXU",
    ("ops.shade_table", "FETCH_PALLAS"): "Pallas small-table fetch switch",
    ("ops.shade_table", "FETCH_BLOCK"): "Pallas big-table fetch block",
    ("ops.shade_table", "FETCH_CHUNK"): "Pallas fetch lane chunk",
    ("ops.shade_table", "FETCH_KB"): "Pallas fetch one-hot blocks",
    ("ops.shade_table", "FETCH_GROUP"): "Pallas fetch map step",
    ("ops.shade_table", "FETCH_FUSED"): "fused Pallas bounce fetch switch",
    ("ops.shade_table", "FETCH_SORTED"): "sorted Pallas fetch switch",
    ("ops.shade_table", "FETCH_KB_SORTED"): "sorted fetch one-hot blocks",
    ("ops.shade_table", "ONEHOT_MAX_ROWS"): "MXU one-hot fetch line",
    ("ops.shade_table", "FUSED_MAX_ROWS"): "VMEM bound of the fused fetch",
    ("ops.shade_table", "FB_ROWS"): "the Pallas fused fetch's VMEM rows",
    ("ops.trace_shade_fused", "TILE_OVERRIDE"): "Pallas tile override",
    ("ops.traverse_resident", "SQRT3"): "defined, never read",
    ("passes.pathtrace", "STAGE_BARRIERS"): "XLA optimization barriers",
    ("passes.pathtrace", "STAGE_BARRIERS_SHADE"): "XLA optimization barrier",
    ("passes.restir", "RESTIR_SHARED_TAPS"): (
        "a switch; the port implements its default (shared taps)"),
}


def _reference_names():
    """{module: sorted public names} of every tpu_pbrt module."""
    out = {}
    for path in sorted(REFERENCE.rglob("*.py")):
        mod = ".".join(path.relative_to(REFERENCE).with_suffix("").parts)
        names = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name):
                names.add(node.target.id)
        out[mod] = sorted(n for n in names if not n.startswith("_"))
    return out


REFERENCE_NAMES = _reference_names()


def _port_module(mod: str):
    name = "tpu_pbrt_torch" + ("" if mod == "__init__" else "." + mod)
    return importlib.import_module(name.removesuffix(".__init__"))


@pytest.mark.parametrize("mod", sorted(REFERENCE_NAMES))
def test_module_has_its_counterpart(mod):
    if (mod, None) in TPU_ONLY:
        with pytest.raises(ModuleNotFoundError):
            _port_module(mod)
        return
    port = _port_module(mod)
    missing = [n for n in REFERENCE_NAMES[mod]
               if not hasattr(port, n) and (mod, n) not in TPU_ONLY]
    assert not missing, f"tpu_pbrt_torch.{mod} lacks {missing}"


def test_the_exception_list_is_current():
    """Every listed switch still exists in the reference and is still absent
    from the port (a ported name leaves the list)."""
    for mod, name in TPU_ONLY:
        if name is None:
            assert mod in REFERENCE_NAMES, mod
            continue
        assert name in REFERENCE_NAMES[mod], (mod, name)
        assert not hasattr(_port_module(mod), name), (mod, name)


def test_the_walk_found_the_reference():
    assert len(REFERENCE_NAMES) >= 60
    assert "closest_hit" in REFERENCE_NAMES["ops.traverse"]
    assert "pack_level_quads" in REFERENCE_NAMES["native.__init__"]
