"""P2: B1's front end alone: ranks, exact compaction and evaluation of a
work item's triangles. The counterpart of scripts/probe_mosaic.py
(``kernel``: prefix-sum ranks of a 5%-dense (16, 2048) mask, the 33rd-64th
set triangles of row 3), scripts/probe_pack2.py (``kern_rowmajor``,
``kern_compmajor``, ``k1``: the triangles' rows read row-major or
component-major, over 1024 items) and scripts/probe_exact.py (``k2``,
``k3``, ``k4``: exact compaction, and the compacted rows times a random and
a block-diagonal edge right-hand side, a*dx + b*dy over 4 x 1024 px);
kernel ``vrt_probe_eval`` of csrc/probes.cu.

For each work item: per mask row the count and the ranks of its set
triangles; the rows of the triangles ranked ``round * 32`` to
``round * 32 + 31`` in each mask row (zero rows past the count); and row
``sub``'s 32 compacted rows times a (48, NP) right-hand side, summed over
the 48 components in ascending order with separate roundings. The TPU
kernels needed one-hot products of three bf16 splits for an exact gather
and HIGHEST matmuls for an exact sum; here both are exact by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from vrenderer_tpu_torch.ops import _build
from vrenderer_tpu_torch.probes import common

T, C, K, N_SUB = 2048, 48, 32, 16    # triangles, floats a row, slots, rows
ITEMS = 1024                         # probe_pack2's work items
PIX = 1024                           # probe_exact's P: 4 blocks of 1024 px
DENSITY = 0.05                       # probe_mosaic's mask density
SUB, ROUND = 3, 1                    # probe_mosaic's row and round
SECTOR = 32                          # bytes of one DRAM/L2 sector
EVAL_OPS = 2 * C - 1                 # a (triangle, pixel) pair's operations


def masks(items: int = ITEMS, seed: int = 0, t: int = T,
          device=None) -> torch.Tensor:
    """(items, 16, t) uint8 selection masks at DENSITY; item 0 of seed 0 is
    probe_mosaic's mask."""
    rng = np.random.default_rng(seed)
    m = (rng.random((items, N_SUB, t)) < DENSITY).astype(np.uint8)
    return torch.as_tensor(m, device=device)


def exact_inputs(seed: int = 0) -> dict:
    """probe_exact's inputs, drawn in its order from ``seed``: data (T, 48)
    (edges O(1), the rest O(1e3)), the 32 sorted selected triangles sel,
    the random right-hand side rhs (48, 4 PIX), the edge form rhs_real, and
    data_e (only the 12 edge floats set)."""
    rng = np.random.default_rng(seed)
    data = np.concatenate([
        rng.standard_normal((T, 12)).astype(np.float32),
        rng.standard_normal((T, 36)).astype(np.float32) * 1e3], axis=1)
    sel = rng.choice(T, K, replace=False)
    sel.sort()
    rhs = rng.standard_normal((C, 4 * PIX)).astype(np.float32)
    rhs_real = np.zeros((C, 4 * PIX), np.float32)
    dx = (np.arange(PIX) % 128 + 0.5).astype(np.float32)
    dy = (np.arange(PIX) // 128 + 0.5).astype(np.float32)
    for q in range(4):
        rhs_real[3 * q, q * PIX:(q + 1) * PIX] = dx
        rhs_real[3 * q + 1, q * PIX:(q + 1) * PIX] = dy
    data_e = np.zeros((T, C), np.float32)
    data_e[:, :12] = rng.standard_normal((T, 12)).astype(np.float32)
    return {"data": data, "sel": sel, "rhs": rhs, "rhs_real": rhs_real,
            "data_e": data_e}


def item_rows(base: torch.Tensor, items: int) -> torch.Tensor:
    """(items, T, 48) row-major triangle rows: item i holds ``base``
    (T, 48) rolled by i triangles, so every item is its own memory."""
    t = base.shape[0]
    idx = (torch.arange(t, device=base.device)[None, :]
           + torch.arange(items, device=base.device)[:, None]) % t
    return base[idx]


def evaluate(mask: torch.Tensor, data: torch.Tensor, comp_major: bool,
             rhs: torch.Tensor | None, sub: int = SUB, round_: int = ROUND):
    """(counts (items, 16) int32, rows (items, 16, 32, 48), evals (items,
    32, NP) or None without ``rhs``). ``data`` is (items, T, 48), or (items,
    48, T) with ``comp_major``. CUDA tensors launch the kernel, CPU tensors
    run ``evaluate_plain``."""
    if mask.device.type == "cpu":
        return evaluate_plain(mask, data, comp_major, rhs, sub, round_)
    dev = mask.device
    items, _, t = mask.shape
    common.check(mask, (items, N_SUB, t), torch.uint8, dev, "masks")
    common.check(data, (items, C, t) if comp_major else (items, t, C),
                 torch.float32, dev, "triangle rows")
    np_ = 0
    if rhs is not None:
        np_ = rhs.shape[1]
        common.check(rhs, (C, np_), torch.float32, dev, "right-hand side")
    counts = torch.empty((items, N_SUB), dtype=torch.int32, device=dev)
    rows = torch.empty((items, N_SUB, K, C), dtype=torch.float32, device=dev)
    evals = (None if rhs is None else
             torch.empty((items, K, np_), dtype=torch.float32, device=dev))
    _build.launch("vrt_probe_eval", dev, mask.data_ptr(), data.data_ptr(),
                  items, t, C, int(comp_major), sub, round_,
                  None if rhs is None else rhs.data_ptr(), np_,
                  counts.data_ptr(), rows.data_ptr(),
                  None if evals is None else evals.data_ptr())
    evaluate.launches += 1
    return counts, rows, evals


evaluate.launches = 0


def selection(mask: torch.Tensor, round_: int = ROUND) -> torch.Tensor:
    """(items, 16, 32) int64: the triangle ranked round_ * 32 + slot in
    each mask row, -1 past the row's count."""
    on = mask != 0
    slot = torch.cumsum(on, dim=-1) - 1 - round_ * K
    keep = on & (slot >= 0) & (slot < K)
    sel = torch.full(mask.shape[:2] + (K,), -1, dtype=torch.int64,
                     device=mask.device)
    it, s, t = torch.nonzero(keep, as_tuple=True)
    sel[it, s, slot[it, s, t]] = t
    return sel


def evaluate_plain(mask, data, comp_major: bool, rhs, sub: int = SUB,
                   round_: int = ROUND):
    """The kernel's function in PyTorch (``evaluate``)."""
    counts = (mask != 0).sum(-1, dtype=torch.int32)
    sel = selection(mask, round_)
    it = torch.arange(mask.shape[0], device=mask.device)[:, None, None]
    g = sel.clamp(min=0)
    rows = data.transpose(1, 2)[it, g] if comp_major else data[it, g]
    rows = torch.where((sel >= 0)[..., None], rows, torch.zeros_like(rows))
    if rhs is None:
        return counts, rows, None
    return counts, rows, eval_plain(rows[:, sub], rhs)


def eval_plain(blk: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(..., 32, 48) rows times rhs (48, NP), each output summed over the
    48 components in ascending order, one rounding an operation."""
    acc = blk[..., 0:1] * rhs[0]
    for c in range(1, blk.shape[-1]):
        acc = acc + blk[..., c:c + 1] * rhs[c]
    return acc


def sectors(mask: torch.Tensor, comp_major: bool,
            round_: int = ROUND) -> int:
    """32-byte sectors of triangle data the compaction touches: a row-major
    row is 6 aligned sectors; a component-major float its own sector,
    shared by triangles t // 8 alike."""
    sel = selection(mask, round_)
    it, s, k = torch.nonzero(sel >= 0, as_tuple=True)
    t = sel[it, s, k]
    if not comp_major:
        return int(torch.unique(it * T + t).numel()) * C * 4 // SECTOR
    per = SECTOR // 4
    return int(torch.unique(it * T + t // per * per).numel()) * C


def run(device, small: bool = False) -> dict:
    """The kernel against its plain version (bit for bit) for both layouts,
    compaction only and with both right-hand sides; the evaluation's
    largest relative error against float64; times, bytes and rates on the
    card."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    items = 4 if small else ITEMS
    ex = exact_inputs()
    mask = masks(items, device=device)
    row_major = item_rows(torch.as_tensor(ex["data"], device=device), items)
    comp = row_major.transpose(1, 2).contiguous()
    rhs = {"random": torch.as_tensor(ex["rhs"], device=device),
           "edges": torch.as_tensor(ex["rhs_real"], device=device)}
    if small:
        rhs = {k: v[:, :256].contiguous() for k, v in rhs.items()}
    n_sel = int((selection(mask) >= 0).sum())
    res = {"items": items, "selected_rows": n_sel}
    counts, rows, _ = evaluate_plain(mask, row_major, False, None)
    for layout, data in (("row_major", row_major), ("comp_major", comp)):
        got = evaluate(mask, data, layout == "comp_major", None)
        if not (common.bits_equal(got[0], counts)
                and common.bits_equal(got[1], rows)):
            raise RuntimeError(f"P2 {layout}: the compaction differs from "
                               f"the plain version")
        nbytes = sectors(mask, layout == "comp_major") * SECTOR
        row = {"triangle_bytes_per_item": nbytes / items,
               "needed_bytes_per_item": n_sel * C * 4 / items,
               "max_abs_err": 0.0, "library_ms": None}
        moved = mask.numel() + counts.numel() * 4 + rows.numel() * 4
        row.update(common.bound(moved + n_sel * C * 4, 0))
        if on_card:
            ms = common.cuda_ms(lambda d=data, c=layout == "comp_major":
                                evaluate(mask, d, c, None), 20)
            row.update(ms=ms, triangle_gb_s=nbytes / ms * 1e-6,
                       plain_ms=common.cuda_ms(
                           lambda d=data, c=layout == "comp_major":
                           evaluate_plain(mask, d, c, None), 1,
                           queued=False))
        res[layout] = row
    for name, r in rhs.items():
        np_ = r.shape[1]
        want = eval_plain(rows[:, SUB], r)
        got = evaluate(mask, row_major, False, r)[2]
        if not common.bits_equal(got, want):
            raise RuntimeError(f"P2 {name}: the evaluation differs from the "
                               f"plain version")
        exact = (rows[:, SUB].double() @ r.double())
        rel = ((got.double() - exact).abs()
               / exact.abs().clamp(min=1e-6)).max()
        pairs = items * K * np_
        ops = pairs * EVAL_OPS
        moved = (mask.numel() + rows.numel() * 4 + counts.numel() * 4
                 + n_sel * C * 4 + r.numel() * 4 + got.numel() * 4)
        row = {"pairs": pairs, "max_rel_err_vs_f64": float(rel),
               "max_abs_err": float((got - want).abs().max()),
               "library_ms": None, **common.bound(moved, ops)}
        if on_card:
            ms = common.cuda_ms(lambda r=r: evaluate(mask, row_major, False,
                                                     r), 20)
            row.update(ms=ms, ns_per_pair=ms * 1e6 / pairs,
                       plain_ms=common.cuda_ms(
                           lambda r=r: evaluate_plain(mask, row_major, False,
                                                      r), 1, queued=False))
        res[f"eval_{name}"] = row
    return res
