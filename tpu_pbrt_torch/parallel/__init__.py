"""Multi-device work over a 1-D mesh of pixel bands (port of
`tpu_pbrt/parallel/`): the mesh, its collectives and the sharded path
tracer (`mesh.py`), and the whole App frame graph sharded by pixel rows
with halo exchange (`app_mesh.py`). One process drives every shard, as
`shard_map` does."""
