"""numpy -> torch conversion of parameter trees and the occupancy state.

The input is the JAX package's state as numpy arrays (np.asarray of each
leaf), never JAX arrays: this module imports numpy and torch only. The key
names are the JAX package's (`hash_table`, `base_mlp/w0`, `b0`,
`camera_opt/col/pose_adjustment`, ...) and MLP weights keep their
(in, out) layout, so converted trees plug into the port unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from lsenerf_tpu_torch.ops.occupancy import OccGridState


def tree_to_torch(tree, device="cpu"):
    """Nested dict of numpy arrays -> same dict of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree)).to(device)


def params_from_numpy(model: dict, camera_opt: dict, device="cpu") -> dict:
    """The trainer's parameter tree {"model": ..., "camera_opt": ...}."""
    return {
        "model": tree_to_torch(model, device),
        "camera_opt": tree_to_torch(camera_opt, device),
    }


def occ_state_from_numpy(occs, binaries, device="cpu") -> OccGridState:
    return OccGridState(
        occs=torch.as_tensor(np.asarray(occs, np.float32)).to(device),
        binaries=torch.as_tensor(np.asarray(binaries, bool)).to(device),
    )
