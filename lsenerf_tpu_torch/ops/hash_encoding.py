"""Multi-resolution hash-grid encoding, blocked layout.

Port of lsenerf_tpu/ops/hash_encoding.py for the layout the flagship uses:
vertices are grouped into overlapping 3x3x3 blocks keyed by the
half-resolution cell k = floor(cube_base / 2), so every sample-level reads
one 64-wide row (27 vertices x F=2 features + 10 pad columns). Dense levels
index the block lattice directly; the rest use the XOR-prime hash.

The encode is a torch.autograd.Function whose forward is kernel K1 and
whose backward is kernel K2 (ops/combine.py). The backward recomputes keys
and fractions from the positions instead of keeping the gathered rows, and
its table gradient is an exact atomic sum: the JAX backward caps updates
per accumulate window (hash_encoding.py:621) and, in bf16, rounds the
gradient factors (:530-536, 560); the port does neither, on purpose.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from lsenerf_tpu_torch.ops import combine


@dataclass(frozen=True)
class HashEncodingConfig:
    num_levels: int = 16
    features_per_level: int = 2
    base_res: int = 16
    max_res: int = 2048
    hash_init_scale: float = 0.001
    # "bfloat16": the f32 table is cast to bf16 once per encode for the
    # lookup; gradients accumulate in f32
    gather_dtype: str = "float32"
    # log2 of hashed rows per level (2^14 rows x 64 == 2^19 entries x 2)
    blocked_rows_log2: int = 14

    def __post_init__(self):
        if self.features_per_level != combine.F:
            raise ValueError(
                f"the blocked kernels take features_per_level={combine.F}"
            )

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def blocked_row_width(self) -> int:
        """27 vertices x F features, padded to a multiple of 32."""
        return ((27 * self.features_per_level + 31) // 32) * 32

    def scalings(self) -> np.ndarray:
        """Per-level grid resolutions floor(base * growth^level)."""
        growth = np.exp(
            (np.log(self.max_res) - np.log(self.base_res)) / (self.num_levels - 1)
        )
        return np.floor(self.base_res * growth ** np.arange(self.num_levels))

    def blocked_level_bdims(self) -> np.ndarray:
        """Block-lattice extent per dim per level: ceil(R / 2)."""
        res = self.scalings().astype(np.int64)
        return (res - 1) // 2 + 1

    def blocked_level_rows(self) -> np.ndarray:
        """Rows per level: the dense block lattice when it fits, else hashed."""
        return np.minimum(self.blocked_level_bdims() ** 3, 2**self.blocked_rows_log2)

    @property
    def total_rows(self) -> int:
        return int(self.blocked_level_rows().sum())


def _dense_level_count(config: HashEncodingConfig) -> int:
    """Number of leading dense-keyed levels (rows < 2^blocked_rows_log2).
    Rows per level are nondecreasing, so these are a prefix."""
    rows = config.blocked_level_rows()
    return int(np.searchsorted(rows, 2**config.blocked_rows_log2))


@functools.lru_cache(maxsize=None)
def _levels(config: HashEncodingConfig, device: torch.device) -> combine.Levels:
    rows = config.blocked_level_rows()
    L = config.num_levels
    params = np.zeros((L, 4), np.int32)
    params[:, 0] = config.scalings().astype(np.int64)
    params[:, 1] = config.blocked_level_bdims()
    params[:_dense_level_count(config), 2] = 1
    params[:, 3] = np.concatenate([[0], np.cumsum(rows)[:-1]])
    return combine.Levels(
        scale=torch.tensor(config.scalings().astype(np.float32), device=device),
        params=torch.tensor(params, device=device),
        hash_mask=2**config.blocked_rows_log2 - 1,
        total_rows=config.total_rows,
    )


def levels_for(config: HashEncodingConfig, device) -> combine.Levels:
    return _levels(config, torch.device(device))


def _blocked_keys_fracs(positions: torch.Tensor, config: HashEncodingConfig):
    """(n, 3) positions -> global row keys (L, n) + per-dim (parity o, frac w)."""
    keys, o, w = combine.keys_fracs(positions, levels_for(config, positions.device))
    return keys, (o[0], w[0]), (o[1], w[1]), (o[2], w[2])


def init_hash_table(
    config: HashEncodingConfig, generator: torch.Generator, device="cpu"
) -> torch.Tensor:
    """U(-scale, scale) init of the (total_rows, row_width) table."""
    shape = (config.total_rows, config.blocked_row_width)
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return (u * 2.0 - 1.0) * config.hash_init_scale


class _BlockedEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, positions, levels, bf16):
        gtable = table.to(torch.bfloat16) if bf16 else table
        ctx.levels = levels
        ctx.save_for_backward(positions, gtable)
        return combine.encode_fwd(positions.contiguous(), gtable, levels)

    @staticmethod
    def backward(ctx, gfeat):
        positions, gtable = ctx.saved_tensors
        dpos, dtable = combine.encode_bwd(
            positions.contiguous(), gtable, gfeat.float().contiguous(), ctx.levels
        )
        return (
            dtable if ctx.needs_input_grad[0] else None,
            dpos if ctx.needs_input_grad[1] else None,
            None,
            None,
        )


def hash_encode(
    table: torch.Tensor, positions: torch.Tensor, config: HashEncodingConfig
) -> torch.Tensor:
    """Encode (n, 3) positions in [0,1]^3 -> (n, L*F) features.
    Differentiable in the table and in the positions."""
    levels = levels_for(config, positions.device)
    return _BlockedEncode.apply(
        table, positions, levels, config.gather_dtype == "bfloat16"
    )
