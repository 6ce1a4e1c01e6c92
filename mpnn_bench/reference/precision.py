"""The reference's products, in float32 or in the control's TF32.

Every product of the reference goes through :func:`mm`. In ``"float32"``
it is a float32 product with TF32 off (in ``"float64"``, the witness's,
a float64 product of operands already in float64); in ``"tf32"`` (the control, the
nearest precision below float32 with TF32 off) both operands are first
rounded to TF32's 10-bit mantissa, to nearest, as the tensor cores take
them, and the product is summed in float32. The rounding is done here
rather than by the card's TF32 mode, so the control reads alike on the
card and on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "tf32", "float64")


@contextlib.contextmanager
def tf32_off():
    """TF32 off for matmuls and convolutions, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to 10 mantissa bits, to nearest, ties away;
    the gradient passes straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    r = torch.where(torch.isfinite(x.detach()), r, x.detach())
    return x + (r - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in ``precision``."""
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    elif precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return a @ b


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """A Dense layer, ``w`` in (out, in) layout."""
    return mm(x, w.t(), precision) + b
