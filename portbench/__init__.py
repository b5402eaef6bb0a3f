"""The benchmark of vrenderer_tpu_torch on one NVIDIA H100: ``run.py``
runs one cell of ``BENCHMARK.json`` once; its docstring says how."""
