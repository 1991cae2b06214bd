"""Intensity mappers: linear radiance -> per-sensor response curves.
Port of lsenerf_tpu/models/mappers.py for `identity` and the
learnable-exponent `powpow`; the MLP and gamma mappers are not ported yet."""

from __future__ import annotations

import torch


def init_mapper(name: str, device="cpu") -> dict:
    name = name.lower()
    if name == "powpow":
        return {"pow_coeff": torch.ones((1,), dtype=torch.float32, device=device)}
    if name == "identity":
        return {}
    raise NotImplementedError(f"mapper '{name}' is not ported")


def apply_mapper(name: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    name = name.lower()
    if name == "powpow":
        return x ** params["pow_coeff"]
    if name == "identity":
        return x
    raise NotImplementedError(f"mapper '{name}' is not ported")
