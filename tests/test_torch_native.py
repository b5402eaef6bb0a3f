"""The port's build of the native runtime library (native/vrt_native.cpp)
against the JAX package's: its clock and the fBm heightmap bit for bit."""

import numpy as np
import pytest

from vrenderer_tpu_torch.utils import native


def test_build_loads():
    lib = native.load()
    assert native.library_path().exists()
    assert native.library_path().parent.parent == native.BUILD_DIR
    a = lib.vrt_now_ns()
    b = lib.vrt_now_ns()
    assert 0 < a <= b
    assert native.build() == native.library_path()    # reused, not rebuilt


def test_fbm_heightmap_bitwise_equal_to_jax():
    from vrenderer_tpu.utils import native as jnative

    # the JAX package falls back to numpy noise without its library; the
    # comparison is only meaningful against its native path
    assert jnative.available()
    for res, seed in ((1024, 1234), (128, 42)):
        got = native.fbm_heightmap(res, seed=seed, octaves=32, gain=0.55)
        want = jnative.fbm_heightmap(res, seed=seed, octaves=32, gain=0.55)
        assert got.dtype == np.float32 and got.shape == (res, res)
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(native.fbm_heightmap(128, seed=43),
                              native.fbm_heightmap(128, seed=42))
    with pytest.raises(ValueError):
        native.fbm_heightmap(0)


def test_procedural_heightmap_1024_bitwise_equal_to_jax():
    from vrenderer_tpu.terrain import heightmap as jh
    from vrenderer_tpu.utils import native as jnative
    from vrenderer_tpu_torch.terrain import heightmap as th

    assert jnative.available()
    h = th.procedural_heightmap(1024, seed=5, device="cpu")
    assert h.shape == (1024, 1024) and 0.0 <= float(h.min())
    assert float(h.max()) <= 1.0 and float(h.std()) > 0.02
    np.testing.assert_array_equal(h.numpy(),
                                  np.asarray(jh.procedural_heightmap(1024, 5)))
