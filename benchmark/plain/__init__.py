"""The benchmark's plain reference: a brute-force path tracer in plain
PyTorch, written from the semantics of the renderer that the port follows
(pcg4d draws per pixel, bounce and slot; the three-lobe BSDF with one-sample
lobe choice; one-light NEE with balance-heuristic MIS; Russian roulette
after bounce 3; the luminance cutoff; pool folds; counted rays). It imports
nothing of the port: it builds its triangle arrays from the same scene
inputs the harness hands the port (`benchmark/kinds/`), finds hits by
testing every triangle of every box a ray crosses, and shades them.

* `scene.py`: scene inputs -> flat triangle, material and light arrays
  (the .glb parsed here), each hit's material (`Scene.material_at`), and
  the lookup of a scene's kind; each kind's module makes its inputs (the
  skinned tube posed in `kinds/skinned_tube.py`);
* `trace.py`: closest and any hit over boxes of 64 triangles;
* `render.py`: camera rays and the path tracer.
"""
