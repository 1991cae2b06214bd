"""Intensity mappers: linear radiance -> per-sensor response curves.
Port of lsenerf_tpu/models/mappers.py: the 1->1 `mlp` and 3->3 `rgb_mlp`
mappers (4 layers of width 16, sigmoid out, pretrained to the identity),
the fixed `gt` gamma, `identity` and the learnable-exponent `powpow`."""

from __future__ import annotations

import torch

from perfbench.frozen.ref.models import mlp

MAPPERS = ("mlp", "rgb_mlp", "gt", "identity", "powpow")
PRETRAIN_STEPS = 5000
PRETRAIN_LR = 5e-2


def identity_pretrain(params: dict, in_dim: int, n_steps: int = PRETRAIN_STEPS) -> dict:
    """Fit a mapper MLP to the identity on [0, 1]: n_steps Adam(5e-2)
    steps against a 100-point linspace (mappers.py:19-41), on the
    parameters' device. Returns new leaves; `params` is left as it is."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    device = next(iter(p.values())).device
    inp = torch.linspace(0, 1, 100, device=device)[:, None].expand(100, in_dim)
    opt = torch.optim.Adam(list(p.values()), lr=PRETRAIN_LR)
    for _ in range(n_steps):
        opt.zero_grad(set_to_none=True)
        out = mlp.apply_mlp(p, inp, out_activation=torch.sigmoid)
        ((out - inp) ** 2).mean().backward()
        opt.step()
    return {k: v.detach() for k, v in p.items()}


def init_mapper(name: str, generator: torch.Generator = None, device="cpu") -> dict:
    """A mapper's params; the MLP mappers draw their weights from
    `generator` and are pretrained to the identity."""
    name = name.lower()
    if name in ("mlp", "rgb_mlp"):
        d = 1 if name == "mlp" else 3
        p = mlp.init_mlp(generator, d, 4, 16, d, device)
        return {"mlp": identity_pretrain(p, d, PRETRAIN_STEPS)}
    if name == "powpow":
        return {"pow_coeff": torch.ones((1,), dtype=torch.float32, device=device)}
    if name in ("gt", "identity"):
        return {}
    raise ValueError(f"unknown mapper '{name}'")


def apply_mapper(name: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    name = name.lower()
    if name in ("mlp", "rgb_mlp"):
        return mlp.apply_mlp(params["mlp"], x, out_activation=torch.sigmoid)
    if name == "powpow":
        return x ** params["pow_coeff"]
    if name == "gt":
        return x ** (1.0 / 2.4)
    if name == "identity":
        return x
    raise ValueError(f"unknown mapper '{name}'")
