"""Row permutation with a gather backward. Port of
lsenerf_tpu/ops/fast_gather.py::permute.

The gradient of x[order] is g[inv_order]: a permutation inverts exactly,
so the backward is another gather, where autograd's own backward of an
index would scatter (index_add) into a zero tensor."""

from __future__ import annotations

import torch


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, order, inv_order):
        ctx.save_for_backward(inv_order)
        return x.index_select(0, order)

    @staticmethod
    def backward(ctx, g):
        (inv_order,) = ctx.saved_tensors
        return g.index_select(0, inv_order), None, None


def permute(x: torch.Tensor, order: torch.Tensor, inv_order: torch.Tensor) -> torch.Tensor:
    """x[order] along axis 0; `inv_order` is order's inverse permutation."""
    return _Permute.apply(x, order, inv_order)
