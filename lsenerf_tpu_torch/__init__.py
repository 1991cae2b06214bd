"""LSENeRF in PyTorch for an NVIDIA Hopper card (H100).

The port of the JAX package `lsenerf_tpu`, module for module:

  ops/       hash encoding (with its CUDA kernels in ops/combine.py and
             csrc/), SH encoding, occupancy grid, ray marching,
             compositing, Lie-group and interpolation helpers
  models/    field, MLPs, embeddings, mappers, losses, the LSENeRF model
  cameras/   cameras, ray containers, pose optimizers
  data/      datasets, the scene parser and PNG codec, the synthetic scene,
             the pixel sampler
  engine/    the config tree, schedules, the trainer (`Trainer.step`), the
             training loop, checkpoints, the full-image render and eval
  train.py   the CLI (`python -m lsenerf_tpu_torch.train`); parity.py its
             metric-parity harness

The port imports torch and numpy only. Entry points run on `cuda` unless
the caller passes `device="cpu"`; without a card they raise.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

EPS = 1e-6  # global epsilon, the same value as lsenerf_tpu.EPS


def resolve_device(device=None) -> torch.device:
    """`None` means the card; it raises when there is none. Only an
    explicit `device="cpu"` (as the tests pass) runs on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
