"""P1: the float32 rates the bounds divide by, and what the no-FMA rule
costs. The counterpart of scripts/probe_peak.py (``fma_kernel``: R
dependent sweeps over an (S, 1024) block) and scripts/probe_fma.py
(``make_kernel``: N reps of the raster evaluation's ev() shape, summed);
kernel ``vrt_probe_sweep`` of csrc/probes.cu.

Forms of a sweep, v -> ...: ``fma`` v*a + b rounded once, ``mul_add`` the
same as a multiply then an add (how --fmad=false builds the rasterizer's
plane evaluations), ``min`` min(v*a, v + b), ``cmp`` v >= b ? v*a : v + b.
Modes of the ev() chain, out[k, p] = sum over i < N, in order, of: ``add``
px + c, ``mul`` a*px, ``fma1`` a*px + c, ``full`` (a*px + b*py) + c, with
(a, b, c) = column i % 8 of row k's coefficients, never contracted.
"""

from __future__ import annotations

import numpy as np
import torch

from vrenderer_tpu_torch.ops import _build
from vrenderer_tpu_torch.probes import common
from vrenderer_tpu_torch.utils import math3d

S, R = 512, 512              # probe_peak: an (S, 1024) block, R sweeps
WIDTH = 1024
K, P, N = 32, 2048, 512      # probe_fma: rows, pixels, reps
A, B = np.float32(1.0000001), np.float32(1e-7)   # probe_peak's constants
FORMS = ("fma", "mul_add", "min", "cmp")
EV_MODES = ("add", "mul", "fma1", "full")
# float32 operations a sweep element or an ev() rep does (an FMA 2; the
# chain's accumulating add included)
FORM_OPS = {"fma": 2, "mul_add": 2, "min": 3, "cmp": 3}
EV_OPS = {"add": 2, "mul": 2, "fma1": 3, "full": 5}


def sweep_input(rows: int = S, seed: int = 0, device=None) -> torch.Tensor:
    """The (rows, 1024) block, uniform in [0.25, 0.75) from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.25, 0.75, (rows, WIDTH)).astype(np.float32)
    return torch.as_tensor(x, device=device)


def ev_inputs(rows: int = K, cols: int = P, seed: int = 0, device=None):
    """(xy (2, cols): probe_fma's px = linspace(0, 1) and py = 2 px,
    coef (3, rows, 8): the a, b, c columns, normal from ``seed``)."""
    rng = np.random.default_rng(seed)
    px = np.linspace(0.0, 1.0, cols, dtype=np.float32)
    xy = np.stack([px, px * np.float32(2.0)])
    coef = rng.standard_normal((3, rows, 8)).astype(np.float32)
    return (torch.as_tensor(xy, device=device),
            torch.as_tensor(coef, device=device))


def sweep(x: torch.Tensor, form: str, reps: int = R, a: float = float(A),
          b: float = float(B)) -> torch.Tensor:
    """``reps`` sweeps of ``form`` over x (rows, cols), cols a multiple of 4.
    CUDA tensors launch the kernel, CPU tensors run ``sweep_plain``."""
    if x.device.type == "cpu":
        return sweep_plain(x, form, reps, a, b)
    common.check(x, x.shape, torch.float32, x.device, "sweep input")
    out = torch.empty_like(x)
    _build.launch("vrt_probe_sweep", x.device, x.data_ptr(), None,
                  out.data_ptr(), x.shape[0], x.shape[1], reps,
                  FORMS.index(form), a, b)
    sweep.launches += 1
    return out


sweep.launches = 0


def sweep_plain(x: torch.Tensor, form: str, reps: int = R,
                a: float = float(A), b: float = float(B)) -> torch.Tensor:
    """The kernel's sweeps in PyTorch, one rounding an operation (``fma``:
    ``math3d.fma32``)."""
    a_t = torch.tensor(a, dtype=torch.float32, device=x.device)
    b_t = torch.tensor(b, dtype=torch.float32, device=x.device)
    v = x
    for _ in range(reps):
        if form == "fma":
            v = math3d.fma32(v, a_t, b_t)
        elif form == "mul_add":
            v = v * a_t + b_t
        elif form == "min":
            v = torch.minimum(v * a_t, v + b_t)
        elif form == "cmp":
            v = torch.where(v >= b_t, v * a_t, v + b_t)
        else:
            raise ValueError(f"unknown sweep form {form!r}")
    return v


def ev_chain(xy: torch.Tensor, coef: torch.Tensor, mode: str,
             reps: int = N) -> torch.Tensor:
    """probe_fma's chain: (rows, cols) sums over ``reps`` of ``mode``'s
    value. CUDA tensors launch the kernel, CPU tensors run
    ``ev_chain_plain``."""
    if xy.device.type == "cpu":
        return ev_chain_plain(xy, coef, mode, reps)
    rows, cols = coef.shape[1], xy.shape[1]
    common.check(xy, (2, cols), torch.float32, xy.device, "ev pixels")
    common.check(coef, (3, rows, 8), torch.float32, xy.device,
                 "ev coefficients")
    out = torch.empty((rows, cols), dtype=torch.float32, device=xy.device)
    _build.launch("vrt_probe_sweep", xy.device, xy.data_ptr(),
                  coef.data_ptr(), out.data_ptr(), rows, cols, reps,
                  len(FORMS) + EV_MODES.index(mode), 0.0, 0.0)
    ev_chain.launches += 1
    return out


ev_chain.launches = 0


def ev_chain_plain(xy: torch.Tensor, coef: torch.Tensor, mode: str,
                   reps: int = N) -> torch.Tensor:
    """The chain in PyTorch, summed in rep order from 0."""
    px, py = xy[0][None, :], xy[1][None, :]
    acc = torch.zeros((coef.shape[1], xy.shape[1]), dtype=torch.float32,
                      device=xy.device)
    for i in range(reps):
        a, b, c = (coef[j, :, i % 8][:, None] for j in range(3))
        if mode == "add":
            v = px + c
        elif mode == "mul":
            v = a * px
        elif mode == "fma1":
            v = a * px + c
        elif mode == "full":
            v = (a * px + b * py) + c
        else:
            raise ValueError(f"unknown ev mode {mode!r}")
        acc = acc + v
    return acc


def run(device, small: bool = False) -> dict:
    """Every form and mode against its plain version (bit for bit; the
    differing outputs are counted), timed with CUDA events on the card:
    {name: {ms, plain_ms, rate, bound}}, and on the card the SASS
    instructions of each kernel (FFMA against FMUL and FADD)."""
    device = torch.device(device)
    rows, reps = (8, 4) if small else (S, R)
    er, ec, en = (4, 256, 16) if small else (K, P, N)
    on_card = device.type == "cuda"
    x = sweep_input(rows, device=device)
    xy, coef = ev_inputs(er, ec, device=device)
    res = {}
    cases = [(f, lambda f=f: sweep(x, f, reps),
              lambda f=f: sweep_plain(x, f, reps),
              rows * WIDTH * reps, FORM_OPS[f], 2 * x.numel() * 4)
             for f in FORMS]
    cases += [(f"ev_{m}", lambda m=m: ev_chain(xy, coef, m, en),
               lambda m=m: ev_chain_plain(xy, coef, m, en),
               er * ec * en, EV_OPS[m], (xy.numel() + coef.numel()
                                         + er * ec) * 4)
              for m in EV_MODES]
    for name, kern, plain, elem_ops, ops_each, n_bytes in cases:
        got, want = kern(), plain()
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if not torch.isfinite(got).all() or differ:
            raise RuntimeError(f"P1 {name}: {differ} outputs differ from the "
                               f"plain version")
        ops = elem_ops * ops_each
        row = {"differ": differ, "max_abs_err": float(
            (got.double() - want.double()).abs().max()),
               "elem_ops": elem_ops, "ops": ops, "library_ms": None,
               **common.bound(n_bytes, ops)}
        if on_card:
            ms = common.cuda_ms(kern, 20)
            row.update(ms=ms, plain_ms=common.cuda_ms(plain, 1, queued=False),
                       g_elem_ops_s=elem_ops / ms * 1e-6,
                       tflop_s=ops / ms * 1e-9)
        res[name] = row
    if on_card:
        res["fma_over_mul_add"] = res["mul_add"]["ms"] / res["fma"]["ms"]
        res["sass"] = common.sass_ops(
            r"sweep_kernel|ev_kernel", r"FFMA|FMUL|FADD|FMNMX|FSETP|FSEL|SHFL")
    return res
