"""vrenderer_tpu_torch: the PyTorch + CUDA port of the vrenderer_tpu terrain
renderer, for one NVIDIA H100.

The package mirrors ``vrenderer_tpu``'s module layout and imports neither
JAX nor the JAX package. Plain tensor code is PyTorch; the rasterizers are
hand-written CUDA kernels (``csrc/raster.cu``, built on first use by
``ops/_build.py``), each with a plain PyTorch twin that runs on CPU
tensors. ``renderer.Renderer`` renders on the CUDA device unless it is
given another.
"""

from vrenderer_tpu_torch.config import (  # noqa: F401
    FrameConfig, LightParams, RasterSettings, TerrainSettings,
)
