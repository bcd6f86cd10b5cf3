"""Linear layers in float32, or with their operands rounded to a lower
precision: the control of the comparison.

``linear(x, w, b, rounding)`` is ``x @ w + b`` in float32 when ``rounding``
is None. Otherwise both operands of every product, forward and backward,
are rounded first, the product is accumulated in float32 and rounded
again, as a tensor core in that precision computes it. The fp8 rounding
scales each tensor by its largest magnitude (per-tensor scaling, as fp8
training does), e4m3 for the forward operands and e5m2 for gradients.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Rounding = Optional[Callable[[torch.Tensor, bool], torch.Tensor]]

_FP8 = {False: (torch.float8_e4m3fn, 448.0), True: (torch.float8_e5m2, 57344.0)}


def fp8(x: torch.Tensor, grad: bool = False) -> torch.Tensor:
    """``x`` rounded to fp8 under one scale for the whole tensor."""
    dtype, top = _FP8[grad]
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).clamp(-top, top).to(dtype).float() * scale).to(x.dtype)


class _RoundedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, rounding):
        xr, wr = rounding(x, False), rounding(w, False)
        ctx.save_for_backward(xr, wr)
        ctx.rounding = rounding
        return rounding(xr @ wr, False) + b

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = ctx.rounding(g, True)
        gx = gr @ wr.t()
        gw = xr.reshape(-1, xr.shape[-1]).t() @ gr.reshape(-1, gr.shape[-1])
        return gx, gw, g.reshape(-1, g.shape[-1]).sum(0), None


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, rounding: Rounding = None) -> torch.Tensor:
    """``x @ w + b`` with ``w`` stored (in, out)."""
    if rounding is None:
        return x @ w + b
    return _RoundedLinear.apply(x, w, b, rounding)
