"""Minimal functional MLP. Port of lsenerf_tpu/models/mlp.py.

Parameters are a plain dict {"w0", "b0", "w1", ...} with weights stored
(in_dim, out_dim), so `apply` is `x @ w + b` and the keys and layouts are
the JAX package's. Init is uniform +/- 1/sqrt(fan_in) (torch.nn.Linear)."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def init_mlp(
    generator: torch.Generator,
    in_dim: int,
    num_layers: int,
    layer_width: int,
    out_dim: int,
    device="cpu",
) -> dict:
    """num_layers linear layers (num_layers-1 hidden ReLUs)."""
    dims = [in_dim] + [layer_width] * (num_layers - 1) + [out_dim]
    params = {}
    for i in range(num_layers):
        bound = 1.0 / dims[i] ** 0.5
        for name, shape in ((f"w{i}", (dims[i], dims[i + 1])), (f"b{i}", (dims[i + 1],))):
            u = torch.rand(shape, generator=generator, device=device)
            params[name] = (u * 2.0 - 1.0) * bound
    return params


def apply_mlp(
    params: dict,
    x: torch.Tensor,
    out_activation: Optional[Callable] = None,
    hidden_activation: Callable = torch.relu,
) -> torch.Tensor:
    num_layers = len(params) // 2
    for i in range(num_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < num_layers - 1:
            x = hidden_activation(x)
    if out_activation is not None:
        x = out_activation(x)
    return x
