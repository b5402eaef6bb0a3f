"""The plain reference the benchmark holds the program's frames to.

A frozen copy of the parts of ``vrenderer_tpu_torch`` that the benchmark's
frames run, as they stood when the benchmark was written, in plain
PyTorch: the rasterizer is its plain version (``raster_plain``), never a
kernel. It imports nothing of the program, so a later change to the
program is judged against this copy; nothing here may change with it.
"""
