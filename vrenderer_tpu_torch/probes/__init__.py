"""Hopper microbenchmarks: the counterparts of the JAX package's Mosaic
probes (``scripts/probe_*.py``), which answered design questions about the
raster kernel on the TPU. Each module makes its inputs (numpy seeds, the
script's own sizes) and holds the launcher of its kernel in ``csrc/probes.cu``
(CUDA tensors; a launch count on the wrapper), the plain PyTorch version
(CPU tensors, and the card's reference) and ``run``, which holds the kernel
to the plain version bit for bit and times both on the card:

* ``peak`` (P1, ``vrt_probe_sweep``): probe_peak.py and probe_fma.py, the
  float32 rates and what the rasterizer's no-FMA rule costs;
* ``eval`` (P2, ``vrt_probe_eval``): probe_mosaic.py, probe_pack2.py and
  probe_exact.py, B1's front end: ranks, exact compaction in two layouts,
  exact evaluation;
* ``merge`` (P3, ``vrt_probe_merge``): probe_transposed.py, B1's merge:
  64-bit packed atomics, 32-bit atomics and an id pass, owner threads;
* ``window`` (P4, ``vrt_probe_window``): probe_window.py, B3b's
  coefficient gather: scalar against float4 loads.

On the card: ``python -m vrenderer_tpu_torch.probes [peak|eval|merge|
window]``; ``--device cpu --small`` runs the plain versions at test sizes.
"""
