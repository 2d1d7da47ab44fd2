"""The benchmark's plain reference renderer: plain torch, no kernels.

A frozen copy of the plain modules of `rtw_tpu_torch` (scene model,
builder and registry, vectors, sampling, intersection, textures, shading,
the bounce estimator, the RNG streams, the render configuration), taken
when the benchmark was written and imports rewritten to this package.  It
imports nothing of `rtw_tpu_torch`, `rtw_tpu` or JAX, and it builds its own
scenes (decoding `assets/earthmap.jpg` itself), so a later change to the
program cannot change what the program is judged against.  `paths.py` is
the one module of its own: one path per (pixel, sample) lane, traced to
the end with a plain sweep over every primitive, and the counts of what
the paths did, which `harness/work.py` turns into the bound of a render.
"""
