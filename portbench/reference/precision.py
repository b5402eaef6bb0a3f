"""The reference's precision: float32, or for the benchmark's controls
one step lower, in two places.

The configurations state float32 with TF32 off. The controls that show
the comparison can tell are the same reference one precision lower:

* ``tf32()``: its matrix products in TF32, what
  ``torch.backends.cuda.matmul.allow_tf32`` would give a later change.
  TF32 keeps 10 of float32's 23 mantissa bits of each operand of a
  product and accumulates in float32, so every product here rounds both
  operands to 10 bits (to nearest, ties away from zero, as the card's
  ``cvt.rna.tf32.f32`` does) and multiplies in float32. The shading has
  no products, so TF32 reaches only the geometry.
* ``bf16_shading()``: the shading path (lighting, eye adaptation,
  tonemap, sky, sRGB encode) in bfloat16, as a half-precision G-buffer
  would give a later change: its inputs and each stage's output are
  rounded to bfloat16 (``store``), the arithmetic between stays float32.

Both round the same on the CPU and the card, so the tests run the same
controls.
"""

from __future__ import annotations

import contextlib

import torch

_state = {"tf32": False, "bf16_shading": False}


@contextlib.contextmanager
def tf32():
    """Within the block, every product of this module rounds its operands
    to TF32."""
    before = _state["tf32"]
    _state["tf32"] = True
    try:
        yield
    finally:
        _state["tf32"] = before


@contextlib.contextmanager
def bf16_shading():
    """Within the block, ``store`` rounds the shading's values to
    bfloat16."""
    before = _state["bf16_shading"]
    _state["bf16_shading"] = True
    try:
        yield
    finally:
        _state["bf16_shading"] = before


def store(x: torch.Tensor) -> torch.Tensor:
    """A float32 shading value as the shading keeps it: unchanged, or
    rounded to bfloat16 (to nearest even) under ``bf16_shading``."""
    if not _state["bf16_shading"]:
        return x
    return x.to(torch.bfloat16).to(torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with its mantissa rounded to 10 bits (ties away)."""
    bits = x.contiguous().view(torch.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    out = (bits & ~0x7FFFFFFF) | (mag & 0x7FFFE000)
    finite = torch.isfinite(x)
    return torch.where(finite, out.view(torch.float32), x)


def _operands(*xs):
    if not _state["tf32"]:
        return xs
    return tuple(round_tf32(x) for x in xs)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _operands(a, b)
    return a @ b


def einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _operands(a, b)
    return torch.einsum(spec, a, b)
