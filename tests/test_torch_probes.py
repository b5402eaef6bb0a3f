"""The probes' plain versions (vrenderer_tpu_torch/probes) against the JAX
package's Mosaic probes (scripts/probe_*.py) on the same numpy inputs, and
the plain versions' own properties (ties, layouts, the coefficient
gather).

probe_peak, probe_fma, probe_mosaic and probe_transposed run here through
``pl.pallas_call(..., interpret=True)``; their scripts are loaded from the
file without being edited (their environment defaults are undone).
probe_exact, probe_pack2 and probe_window run TPU work when imported, so
their inputs are rebuilt from the same seeds and the plain versions are
held to the scripts' numpy references (want, want3, want6, want_for).

The kernels against the plain versions on the card: the JAX-free
tests/test_torch_probe_kernels.py.

Tolerances: bitwise wherever both sides round the same operations in the
same order. In interpret mode XLA contracts a multiply and an add into one
FMA (ev()'s a*px + c and a*px + b*py, the transposed probe's a*b + x); there
the test rebuilds XLA's contracted order exactly (``math3d.fma32``) and
holds the kernels' uncontracted order to it within the rounding bound of the
contracted operations. A sum of n float32 terms in another order than the
reference's is held to gamma_n * sum |term|, gamma_n = n u / (1 - n u),
u = 2^-24.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import torch_parity  # noqa: F401  (one PyTorch thread a test process)
from vrenderer_tpu_torch.probes import eval as peval
from vrenderer_tpu_torch.probes import merge, peak, window
from vrenderer_tpu_torch.utils.math3d import fma32

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
U = 2.0 ** -24


def gamma(n: int) -> float:
    return n * U / (1 - n * U)


def load_script(name: str):
    """scripts/<name>.py as a module, with the environment it sets undone."""
    keep = dict(os.environ)
    spec = importlib.util.spec_from_file_location(
        f"probe_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(keep)
    return mod


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# ------------------------------------------------------------------ P1

@pytest.fixture(scope="module")
def peak_script():
    return load_script("probe_peak")


@pytest.mark.parametrize("op", ["fma", "min", "cmp"])
def test_sweep_plain_matches_probe_peak(peak_script, op):
    """probe_peak's v*a + b is one FMA under XLA, as the ``fma`` form; its
    min and compare-select sweeps are the ``min`` and ``cmp`` forms."""
    x = peak.sweep_input(8)
    call = pl.pallas_call(
        functools.partial(peak_script.fma_kernel, reps=4, op=op),
        out_shape=jax.ShapeDtypeStruct((8, peak.WIDTH), jnp.float32),
        interpret=True)
    want = np.asarray(call(jnp.asarray(x.numpy())))
    got = peak.sweep_plain(x, op, 4)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert np.isfinite(want).all()


def test_sweep_forms_fma_differs_from_mul_add():
    """The two forms of v*a + b round otherwise: the probe's point."""
    x = peak.sweep_input(8)
    fused, split = peak.sweep_plain(x, "fma", 4), peak.sweep_plain(
        x, "mul_add", 4)
    assert (bits(fused) != bits(split)).any()
    # 4 sweeps, each within an ulp of the other form's input
    np.testing.assert_allclose(fused, split, rtol=8 * U, atol=0)


@pytest.fixture(scope="module")
def fma_script():
    mod = load_script("probe_fma")
    mod.K, mod.P, mod.N = 8, 256, 16        # its globals, at a small size
    return mod


@pytest.mark.parametrize("mode", peak.EV_MODES)
def test_ev_chain_plain_matches_probe_fma(fma_script, mode):
    K, P, N = fma_script.K, fma_script.P, fma_script.N
    xy, coef = peak.ev_inputs(K, P)
    pad = np.zeros((3, K, 128), np.float32)     # the script's (K, 128) refs
    pad[:, :, :8] = coef.numpy()
    call = pl.pallas_call(fma_script.make_kernel(mode),
                          out_shape=jax.ShapeDtypeStruct((K, P), jnp.float32),
                          interpret=True)
    want = np.asarray(call(pad[0], pad[1], pad[2], xy[0:1].numpy(),
                           xy[1:2].numpy()))
    got = peak.ev_chain_plain(xy, coef, mode, N)
    if mode in ("add", "mul"):
        np.testing.assert_array_equal(bits(got), bits(want))
        return
    # XLA's order: fma(a, px, c) and fma(a, px, b*py) + c
    px, py = xy[0][None], xy[1][None]
    acc = torch.zeros((K, P))
    for i in range(N):
        a, b, c = (coef[j, :, i % 8][:, None] for j in range(3))
        acc = acc + (fma32(a, px, c) if mode == "fma1"
                     else fma32(a, px, b * py) + c)
    np.testing.assert_array_equal(bits(acc), bits(want))
    # both orders are within gamma_3 of a term's exact value, and both
    # chains within gamma_N of their terms' exact sum
    terms = torch.stack([(coef[0, :, i % 8][:, None] * px).abs()
                         + (coef[1, :, i % 8][:, None] * py).abs()
                         + coef[2, :, i % 8][:, None].abs()
                         for i in range(N)]).sum(0).double()
    diff = (got.double() - torch.tensor(want).double()).abs()
    assert (diff <= (2 * gamma(3) + 2 * gamma(N) + 4 * U) * terms).all()


def test_sweep_and_ev_plain_at_the_kernel_sizes_are_finite():
    """peak.run on the CPU (plain against plain) at the tests' sizes."""
    res = peak.run("cpu", small=True)
    for name in (*peak.FORMS, *(f"ev_{m}" for m in peak.EV_MODES)):
        assert res[name]["differ"] == 0 and res[name]["bound_ms"] > 0


# ------------------------------------------------------------------ P2

@pytest.fixture(scope="module")
def exact():
    return peval.exact_inputs()


def test_compaction_matches_probe_mosaic():
    mod = load_script("probe_mosaic")
    rng = np.random.default_rng(0)
    mask = (rng.random((peval.N_SUB, peval.T)) < peval.DENSITY)
    data = rng.standard_normal((peval.T, peval.C)).astype(np.float32)
    data_b = np.asarray(jnp.asarray(data).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    call = pl.pallas_call(
        mod.kernel,
        out_shape=jax.ShapeDtypeStruct((peval.K, peval.C), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((peval.N_SUB, peval.T), jnp.float32)],
        interpret=True)
    want = np.asarray(call(jnp.asarray(mask.astype(np.float32)),
                           jnp.asarray(data_b)))
    m = peval.masks(1)
    np.testing.assert_array_equal(m[0].numpy(), mask.astype(np.uint8))
    counts, rows, _ = peval.evaluate_plain(m, torch.as_tensor(data_b)[None],
                                           False, None)
    np.testing.assert_array_equal(bits(rows[0, peval.SUB]), bits(want))
    np.testing.assert_array_equal(counts[0].numpy(), mask.sum(1))


def test_compaction_and_evaluation_match_probe_exact(exact):
    """probe_exact's one-hot of ``sel``: the compaction is data[sel]; the
    evaluation equals numpy's float32 left-to-right sum and is within
    gamma_48 of want3 and want6 (float64 products rounded once)."""
    data, sel = exact["data"], exact["sel"]
    mask = np.zeros((1, peval.N_SUB, peval.T), np.uint8)
    mask[0][:, sel] = 1
    for layout in (False, True):
        d = torch.as_tensor(data)[None]
        if layout:
            d = d.transpose(1, 2).contiguous()
        _, rows, _ = peval.evaluate_plain(torch.as_tensor(mask), d, layout,
                                          None, round_=0)
        np.testing.assert_array_equal(bits(rows[0, 0]), bits(data[sel]))
    for blk, rhs in ((data[sel], exact["rhs"]),
                     (exact["data_e"][sel], exact["rhs_real"])):
        got = peval.eval_plain(torch.as_tensor(blk),
                               torch.as_tensor(rhs)).numpy()
        ltr = blk[:, 0:1] * rhs[0]
        for c in range(1, peval.C):
            ltr = (ltr + blk[:, c:c + 1] * rhs[c]).astype(np.float32)
        np.testing.assert_array_equal(bits(got), bits(ltr))
        want = (blk.astype(np.float64) @ rhs.astype(np.float64)
                ).astype(np.float32)
        mag = np.abs(blk).astype(np.float64) @ np.abs(rhs).astype(np.float64)
        assert (np.abs(got.astype(np.float64) - want)
                <= gamma(peval.C) * mag + np.abs(want) * U).all()


def test_item_rows_layouts_gather_the_same_rows(exact):
    mask = peval.masks(3)
    rows_rm = peval.item_rows(torch.as_tensor(exact["data"]), 3)
    rows_cm = rows_rm.transpose(1, 2).contiguous()
    a = peval.evaluate_plain(mask, rows_rm, False, None)
    b = peval.evaluate_plain(mask, rows_cm, True, None)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # item 1 holds the base rolled by one triangle
    assert torch.equal(rows_rm[1, :-1], rows_rm[0, 1:])


def test_pack2_one_hot_product_is_a_window_group_sum():
    """probe_pack2's ``want``: the (32, 2048) one-hot-ish matrix (ones
    where t // 61 == k) times item 0's rows sums 61 consecutive rows a slot:
    ``window_plain`` with g = 61 over a 1952-row window at 0, within
    gamma_61 of numpy's float32 product."""
    C, I, T, K = 48, 1024, 2048, 32
    comps0 = np.asarray(jax.jit(lambda: jax.random.uniform(
        jax.random.PRNGKey(0), (C, I, T), jnp.float32)[:, 0])())
    oh = (np.arange(T)[None, :] // 61 == np.arange(K)[:, None])
    want = oh.astype(np.float32) @ comps0.T
    got = window.window_plain(torch.as_tensor(comps0),
                              torch.zeros(1, dtype=torch.int32), 61 * K,
                              61)[0].numpy()
    mag = oh.astype(np.float64) @ np.abs(comps0.T).astype(np.float64)
    assert (np.abs(got.astype(np.float64) - want) <= gamma(61) * mag).all()


def test_evaluate_run_on_cpu():
    res = peval.run("cpu", small=True)
    assert res["comp_major"]["triangle_bytes_per_item"] > res["row_major"][
        "triangle_bytes_per_item"] > 0


# ------------------------------------------------------------------ P3

@pytest.fixture(scope="module")
def transposed_script():
    return load_script("probe_transposed")


def test_merge_plain_matches_probe_transposed(transposed_script):
    mod = transposed_script
    x = merge.merge_input(mod.P, mod.K)
    call = pl.pallas_call(
        mod.kernel, grid=(mod.P // mod.PW,),
        in_specs=[pl.BlockSpec((mod.P, mod.K), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((mod.P // 128, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((mod.P // 128, 128), jnp.float32),
        interpret=True)
    want = np.asarray(call(jnp.asarray(x.numpy())))
    # XLA contracts a*b + x into one FMA: its order exactly
    fused = fma32(x[:, 0:1], x[0:1, :], x).amin(1).reshape(want.shape)
    np.testing.assert_array_equal(bits(fused), bits(want))
    # the kernels' order (the product rounded, then the add): each
    # candidate within u |a b| + 2 u |e| of the fused one, so the minimum too
    z, ids = merge.merge_plain(x, rows=mod.P // 128)
    z_pix = z.T.reshape(want.shape)        # back to pixel order
    prod = (x[:, 0:1] * x[0:1, :]).abs().amax(1).reshape(want.shape)
    want_t = torch.tensor(want)
    assert ((z_pix - want_t).abs() <= U * prod + 2 * U * want_t.abs()).all()
    e = x[:, 0:1] * x[0:1, :] + x
    assert torch.equal(e.gather(1, ids.T.reshape(-1, 1).long()).reshape(-1),
                       z.T.reshape(-1))


def test_finalize_matches_probe_transposed_transpose(transposed_script):
    xt = np.random.default_rng(1).random((128, 16), np.float32)
    call = pl.pallas_call(transposed_script.transpose_kernel,
                          out_shape=jax.ShapeDtypeStruct((16, 128),
                                                         jnp.float32),
                          interpret=True)
    want = np.asarray(call(jnp.asarray(xt)))
    got = merge.finalize(torch.as_tensor(xt).reshape(-1), 16)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_merge_ties_go_to_the_lowest_candidate():
    x = torch.zeros((64, 8))
    x[:, 0] = 1.0                     # e = x[p, 0] * x[0, k] + x[p, k]
    x[0, :] = 0.0                     # every candidate gives e = x[p, k]
    x[5, 3] = x[5, 6] = -1.0
    z, ids = merge.merge_plain(x, rows=8)
    zp, ip = z.T.reshape(-1), ids.T.reshape(-1)
    assert float(zp[5]) == -1.0 and int(ip[5]) == 3
    assert int(ip[7]) == 1            # e = 0 at k 1..7 (x[7, 0] is 1)


# ------------------------------------------------------------------ P4

def test_window_plain_matches_probe_window_want_for():
    """probe_window's ``want_for(s)`` (a one-hot summing 16-column groups,
    numpy's float32 product) for each start, within gamma_16."""
    rng = np.random.default_rng(0)
    data = rng.standard_normal((window.C, window.T)).astype(np.float32)
    np.testing.assert_array_equal(window.window_input().numpy(), data)
    oh = (np.arange(window.W)[None, :] // window.G
          == np.arange(window.W // window.G)[:, None]).astype(np.float32)
    got = window.window_plain(torch.as_tensor(data),
                              torch.tensor(window.STARTS, dtype=torch.int32),
                              window.W, window.G).numpy()
    for i, s in enumerate(window.STARTS):
        want = oh @ data[:, s:s + window.W].T
        mag = oh @ np.abs(data[:, s:s + window.W].T)
        assert (np.abs(got[i] - want) <= gamma(window.G) * mag).all()
        # ascending order exactly
        seq = data[:, s:s + window.W].T.reshape(-1, window.G, window.C)
        acc = seq[:, 0]
        for j in range(1, window.G):
            acc = (acc + seq[:, j]).astype(np.float32)
        np.testing.assert_array_equal(bits(got[i]), bits(acc))


def test_window_coef_case_gathers_rows():
    data, starts = window.coef_input("cpu", small=True)
    got = window.window_plain(data, starts, window.COEF_W, 1)
    rows = data.reshape(-1, window.COEF_W)[starts.long() // window.COEF_W]
    assert torch.equal(got[..., 0], rows)
    with pytest.raises(ValueError):
        window.window_plain(data, starts + data.shape[1], window.COEF_W, 1)
