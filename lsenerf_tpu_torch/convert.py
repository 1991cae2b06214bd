"""numpy -> torch conversion of parameter trees and the occupancy state.

The input is the JAX package's state as numpy arrays (np.asarray of each
leaf), never JAX arrays: this module imports numpy and torch only. The key
names are the JAX package's (`hash_table`, `base_mlp/w0`, `b0`,
`camera_opt/col/pose_adjustment`, `rgb_mapper/mlp/w0`,
`rgb_to_one/weights`, `field/appearance/table` with one row per image
under evs_emb, ...) and MLP weights keep their (in, out) layout, so
converted trees, pretrained mappers included, plug into the port
unchanged. The one leaf whose layout differs is the ngp hash table: JAX
stores it (F, L*T), the port (L*T, F) (ops/ngp.py), and
`params_from_numpy(..., hash_layout="ngp")` transposes it.
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


def ngp_table_from_jax(table) -> np.ndarray:
    """JAX's ngp table (F, L*T) -> the port's (L*T, F), C-contiguous."""
    return np.ascontiguousarray(np.asarray(table).T)


def ngp_table_to_jax(table: torch.Tensor) -> np.ndarray:
    """The port's ngp table (L*T, F) -> JAX's (F, L*T)."""
    return np.ascontiguousarray(table.detach().cpu().numpy().T)


def params_from_numpy(model: dict, camera_opt: dict, device="cpu",
                      hash_layout: str = "blocked") -> dict:
    """The trainer's parameter tree {"model": ..., "camera_opt": ...};
    `hash_layout` is the field's table layout (HashEncodingConfig.layout)."""
    if hash_layout == "ngp":
        fld = dict(model["field"], hash_table=ngp_table_from_jax(model["field"]["hash_table"]))
        model = dict(model, field=fld)
    return {
        "model": tree_to_torch(model, device),
        "camera_opt": tree_to_torch(camera_opt, device),
    }


def occ_state_from_numpy(occs, binaries, device="cpu") -> OccGridState:
    return OccGridState(
        occs=torch.as_tensor(np.asarray(occs, np.float32)).to(device),
        binaries=torch.as_tensor(np.asarray(binaries, bool)).to(device),
    )
