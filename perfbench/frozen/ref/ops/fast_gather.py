"""Row permutation with a gather backward, and the windowed backward's
overflow count. Port of lsenerf_tpu/ops/fast_gather.py::permute and
::window_overflow_count.

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


def window_overflow_count(idx: torch.Tensor, table_len: int, window: int,
                          max_updates: int) -> torch.Tensor:
    """How many of the updates at row indices `idx` the JAX package's
    windowed table-gradient accumulate would drop: it sorts the updates,
    cuts the table into windows of `window` rows and keeps at most
    `max_updates` of each window's. The sum of max(span - max_updates, 0)
    over the windows' spans (searchsorted on the sorted keys); int64."""
    n_windows = -(-table_len // window)
    si = torch.sort(idx.reshape(-1).long()).values
    bounds = torch.arange(n_windows + 1, dtype=torch.int64, device=idx.device) * window
    starts = torch.searchsorted(si, bounds)
    return torch.clamp(starts[1:] - starts[:-1] - max_updates, min=0).sum()
