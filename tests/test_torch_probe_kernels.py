"""The probes' kernels (csrc/probes.cu) against their plain PyTorch
versions on the card, bit for bit (marker ``cuda``; they skip without a
card). The file imports no JAX, so on the machine with the card it runs
without the repository's conftest:

    python -m pytest tests/test_torch_probe_kernels.py --noconftest -q

The plain versions are held to the JAX package's probes in
tests/test_torch_probes.py.
"""

import pytest
import torch

from vrenderer_tpu_torch.probes import eval as peval
from vrenderer_tpu_torch.probes import merge, peak, window


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def exact():
    return peval.exact_inputs()


@pytest.mark.cuda
@pytest.mark.parametrize("form", peak.FORMS)
def test_sweep_kernel_matches_plain(cuda_device, form):
    x = peak.sweep_input(64, device=cuda_device)
    assert torch.equal(peak.sweep(x, form, 64).view(torch.int32),
                       peak.sweep_plain(x, form, 64).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", peak.EV_MODES)
def test_ev_kernel_matches_plain(cuda_device, mode):
    xy, coef = peak.ev_inputs(8, 300, device=cuda_device)   # a ragged warp
    assert torch.equal(peak.ev_chain(xy, coef, mode, 21).view(torch.int32),
                       peak.ev_chain_plain(xy, coef, mode, 21)
                       .view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("comp_major", [False, True])
def test_eval_kernel_matches_plain(cuda_device, exact, comp_major):
    mask = peval.masks(8, device=cuda_device)
    d = peval.item_rows(torch.as_tensor(exact["data"], device=cuda_device), 8)
    if comp_major:
        d = d.transpose(1, 2).contiguous()
    rhs = torch.as_tensor(exact["rhs"], device=cuda_device)
    got = peval.evaluate(mask, d, comp_major, rhs)
    want = peval.evaluate_plain(mask, d, comp_major, rhs)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", merge.VARIANTS)
def test_merge_kernel_matches_plain(cuda_device, variant):
    x = merge.merge_input(512, 256, device=cuda_device)
    x[3, 7] = x[3, 9] = -1.0          # a tie
    z, ids = merge.merge(x, 16, variant, regions=3)
    zw, iw = merge.merge_plain(x, 16)
    assert torch.equal(z.view(torch.int32),
                       zw.expand_as(z).contiguous().view(torch.int32))
    assert torch.equal(ids, iw.expand_as(ids))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", window.VARIANTS)
def test_window_kernel_matches_plain(cuda_device, variant):
    data = window.window_input(device=cuda_device)
    starts = torch.tensor(window.STARTS, dtype=torch.int32,
                          device=cuda_device)
    assert torch.equal(window.window(data, starts, window.W, window.G,
                                     variant),
                       window.window_plain(data, starts, window.W, window.G))
    coef, cs = window.coef_input(cuda_device, small=True)
    assert torch.equal(window.window(coef, cs, window.COEF_W, 1, variant),
                       window.window_plain(coef, cs, window.COEF_W, 1))
