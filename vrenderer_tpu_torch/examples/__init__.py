"""Small programs on the port: ``hello_triangle`` (one triangle through
the rasterizer) and ``walkthrough`` (the first-person controller over the
terrain). Run each with ``python -m vrenderer_tpu_torch.examples.<name>``."""
