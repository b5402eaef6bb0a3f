"""vrenderer_tpu_torch must import, with every submodule, where JAX is not
installed: the machine with the card runs it without JAX."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = re.compile(r"(import|from)\s+(jax|vrenderer_tpu)(\.|\s|,|$)")

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any "import jax" now raises
import vrenderer_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    vrenderer_tpu_torch.__path__, "vrenderer_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m == "vrenderer_tpu" or m.startswith("vrenderer_tpu.")
               for m in sys.modules), "imported the JAX package"
print(" ".join(names))
"""


def test_package_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # config, camera, renderer, convert, app, capture, editor, entry,
    # utils.{math3d, native}, terrain.{heightmap, grid, quadtree},
    # ops.{texture, vertex, raster, raster_cuda, lighting, shadow, _build},
    # models.{mesh, scene}, profiler.profiler, parallel.sharded,
    # examples.{hello_triangle, walkthrough} and the subpackages
    names = proc.stdout.split()
    assert len(names) >= 33
    for m in ("editor", "entry", "examples.hello_triangle",
              "examples.walkthrough", "models.scene", "parallel.sharded"):
        assert f"vrenderer_tpu_torch.{m}" in names


def test_no_jax_import_in_package_sources():
    """Neither the package nor chip_smoke.py, which runs it on the card."""
    pkg = os.path.join(REPO, "vrenderer_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            for line in fh:
                assert not _FORBIDDEN.match(line.strip()), (path, line)
