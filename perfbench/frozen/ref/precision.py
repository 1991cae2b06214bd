"""The reference's precision: as the configuration states, or one step
below it, which is the control that the comparison must catch.

The two places where the configuration states bfloat16 (the hash table's
gather and the MLP inputs) round through `bf16`. Inside `lowered("fp8")`
they round through float8 e4m3 first; inside `lowered("tf32")` float32
matmuls run in TF32."""

from __future__ import annotations

import contextlib

import torch

_state = {"fp8": False}


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to float8 e4m3, held in bfloat16, when lowered)."""
    if _state["fp8"]:
        x = x.to(torch.float8_e4m3fn)
    return x.to(torch.bfloat16)


@contextlib.contextmanager
def lowered(kind: str):
    """The reference one step below the configuration's precision: "fp8"
    for bfloat16, "tf32" for float32 with TF32 off; "none" changes nothing."""
    if kind not in ("fp8", "tf32", "none"):
        raise ValueError(f"unknown control precision {kind!r}")
    saved = (_state["fp8"], torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    _state["fp8"] = kind == "fp8"
    if kind == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        _state["fp8"] = saved[0]
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[1:]
