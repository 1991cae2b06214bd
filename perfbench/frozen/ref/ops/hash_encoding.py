"""Multi-resolution hash-grid encoding, in the JAX package's two layouts.
Port of lsenerf_tpu/ops/hash_encoding.py.

"ngp" (the default, as in JAX) is the reference-exact per-vertex hash
(tiny-cuda-nn's HashGrid): every sample-level reads the 8 vertices of its
cube, each hashed into the level's 2^log2_hashmap_size entries of F
features (features_per_level). The table is (num_levels * T, F) row-major,
the transpose of JAX's (F, num_levels * T) (convert.ngp_table_from_jax).
Forward kernel K7a, backward K7b at F = 2; K7ag/K7bg at any other F
(ops/ngp.py).

"blocked" (the flagship's) groups vertices into overlapping 3x3x3 blocks
keyed by the half-resolution cell k = floor(cube_base / 2), so every
sample-level reads one row of blocked_row_width columns (27 vertices x F
features, padded to a multiple of 32: 64 at F = 2). Dense levels index the
block lattice directly; the rest use the XOR-prime hash. Forward kernel
K1, backward K2 at F = 2; K1g/K2g at any other F (ops/combine.py).

Both encodes are torch.autograd.Functions whose backward recomputes keys
and fractions from the positions instead of keeping the gathered rows. The
table gradient is an exact f32 atomic sum in both: the JAX blocked backward
caps updates per accumulate window (hash_encoding.py:621) and, in bf16,
rounds the gradient factors (:530-536, 560); the JAX ngp backward with a
bf16 gather scatter-adds bf16-rounded updates into a bf16 table
(fast_gather.py:324). The port does none of these, on purpose.

The level window [level_lo, level_hi) encodes a slice of the ladder with
the ladder's geometry (scalings, row offsets, the table's and its
gradient's shapes), so concat(encode[0:C], encode[C:L]) == encode[0:L],
forward and backward: the strided coarse-level field relies on it.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from perfbench.frozen.ref import precision
from perfbench.frozen.ref.ops import combine, ngp

LAYOUTS = ("ngp", "blocked")


@dataclass(frozen=True)
class HashEncodingConfig:
    """The JAX HashEncodingConfig's fields that the port's layouts read,
    with its defaults (its other fields tune the TPU's backward)."""

    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 19  # the ngp layout's entries a level
    base_res: int = 16
    max_res: int = 2048
    hash_init_scale: float = 0.001
    # "bfloat16": the f32 table is cast to bf16 once per encode for the
    # lookup; gradients accumulate in f32
    gather_dtype: str = "float32"
    layout: str = "ngp"  # ngp | blocked
    # log2 of hashed rows per level (2^14 rows x 64 == 2^19 entries x 2)
    blocked_rows_log2: int = 14
    # the active level window [level_lo, level_hi); level_hi=0 means
    # num_levels
    level_lo: int = 0
    level_hi: int = 0
    # JAX's blocked backward takes the levels of fewer rows than
    # max(2^blocked_rows_log2, dense_grad_rows + 1) exactly; the port's
    # grad_overflow count (blocked_overflow_count) skips them as JAX does
    dense_grad_rows: int = 4096

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout {self.layout!r}: one of {LAYOUTS}")
        if self.features_per_level < 1:
            raise ValueError(f"features_per_level={self.features_per_level}: at least 1")
        lo, hi = self.active_range
        if not 0 <= lo < hi <= self.num_levels:
            raise ValueError(f"level window [{lo}, {hi}) of {self.num_levels} levels")

    @property
    def table_size(self) -> int:
        return 2**self.log2_hashmap_size

    @property
    def active_range(self) -> tuple:
        """(lo, hi) of the active level window; hi=0 means num_levels."""
        hi = self.level_hi if self.level_hi > 0 else self.num_levels
        return self.level_lo, hi

    @property
    def out_dim(self) -> int:
        lo, hi = self.active_range
        return (hi - lo) * self.features_per_level

    @property
    def table_shape(self) -> tuple:
        """The table parameter's shape: (num_levels * T, F) for ngp,
        (total_rows, row width) for blocked."""
        if self.layout == "ngp":
            return (self.num_levels * self.table_size, self.features_per_level)
        return (self.total_rows, self.blocked_row_width)

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
    """Number of leading dense-keyed levels of the whole ladder (rows <
    2^blocked_rows_log2): the levels whose keys index the block lattice.
    Rows per level are nondecreasing, so these are a prefix."""
    rows = config.blocked_level_rows()
    return int(np.searchsorted(rows, 2**config.blocked_rows_log2))


def _exact_grad_level_count(config: HashEncodingConfig) -> int:
    """JAX's _dense_level_count (hash_encoding.py:183): the leading levels
    of the ACTIVE window that JAX's blocked backward takes exactly (rows <
    max(2^blocked_rows_log2, dense_grad_rows + 1)); 0 with dense_grad_rows
    <= 0. Unlike _dense_level_count it reads the window and
    dense_grad_rows."""
    lo, hi = config.active_range
    if config.dense_grad_rows <= 0:
        return 0
    cut = max(2**config.blocked_rows_log2, config.dense_grad_rows + 1)
    return int(np.searchsorted(config.blocked_level_rows()[lo:hi], cut))


def _ru256(x: int) -> int:
    return ((x + 255) // 256) * 256


def blocked_overflow_count(positions: torch.Tensor, config: HashEncodingConfig,
                           window: int = 512, max_updates_factor: int = 3) -> torch.Tensor:
    """The grad_overflow metric: how many table-gradient updates JAX's
    sorted windowed accumulate would drop for these (n, 3) unit positions
    (lsenerf_tpu/ops/hash_encoding.py::blocked_overflow_count, with its
    window and per-window cap). The port's own table gradient is exact
    atomics and drops none; the count says whether JAX's would have, on
    the same batch. Its arithmetic is JAX's, index for index. 0-dim int64."""
    from perfbench.frozen.ref.ops.fast_gather import window_overflow_count

    level_rows = config.blocked_level_rows()
    dense_L = _exact_grad_level_count(config)
    if dense_L >= config.num_levels:
        return torch.zeros((), dtype=torch.int64, device=positions.device)
    dense_total = int(level_rows[:dense_L].sum())
    total_rows = int(level_rows.sum())
    keys = _blocked_keys_fracs(positions, config)[0]
    keys_h = keys[dense_L:].reshape(-1).long() - dense_total
    m = keys_h.shape[0]
    n_windows = -(-(total_rows - dense_total) // window)
    mean_per_window = max(1, m // n_windows)
    max_updates = min(_ru256(max(window, max_updates_factor * mean_per_window)), _ru256(m))
    return window_overflow_count(keys_h, total_rows - dense_total, window, max_updates)


@functools.lru_cache(maxsize=None)
def _levels(config: HashEncodingConfig, device: torch.device):
    lo, hi = config.active_range
    scale = torch.tensor(config.scalings()[lo:hi].astype(np.float32), device=device)
    if config.layout == "ngp":
        return ngp.Levels(scale=scale, lo=lo, log2_T=config.log2_hashmap_size,
                          levels=config.num_levels)
    rows = config.blocked_level_rows()
    params = np.zeros((config.num_levels, 4), np.int32)
    params[:, 0] = config.scalings().astype(np.int64)
    params[:, 1] = config.blocked_level_bdims()
    params[:_dense_level_count(config), 2] = 1
    params[:, 3] = np.concatenate([[0], np.cumsum(rows)[:-1]])  # global row offsets
    return combine.Levels(
        scale=scale,
        params=torch.tensor(params[lo:hi], device=device),
        hash_mask=2**config.blocked_rows_log2 - 1,
        total_rows=config.total_rows,
        F=config.features_per_level,
        row_width=config.blocked_row_width,
    )


def levels_for(config: HashEncodingConfig, device):
    """The window's levels on `device`: ngp.Levels for the ngp layout,
    combine.Levels for the blocked one."""
    return _levels(config, torch.device(device))


def _blocked_keys_fracs(positions: torch.Tensor, config: HashEncodingConfig):
    """(n, 3) positions -> global row keys (L, n) + per-dim (parity o, frac w)."""
    keys, o, w = combine.keys_fracs(positions, levels_for(config, positions.device))
    return keys, (o[0], w[0]), (o[1], w[1]), (o[2], w[2])


def init_hash_table(
    config: HashEncodingConfig, generator: torch.Generator, device="cpu"
) -> torch.Tensor:
    """U(-scale, scale) init of the layout's table (config.table_shape)."""
    u = torch.rand(config.table_shape, generator=generator, dtype=torch.float32, device=device)
    return (u * 2.0 - 1.0) * config.hash_init_scale


class _Encode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, positions, levels, bf16, ops):
        gtable = precision.bf16(table) if bf16 else table
        ctx.levels, ctx.ops = levels, ops
        ctx.save_for_backward(positions, gtable)
        return ops.encode_fwd(positions.contiguous(), gtable, levels)

    @staticmethod
    def backward(ctx, gfeat):
        positions, gtable = ctx.saved_tensors
        dpos, dtable = ctx.ops.encode_bwd(
            positions.contiguous(), gtable, gfeat.float().contiguous(), ctx.levels
        )
        return (
            dtable if ctx.needs_input_grad[0] else None,
            dpos if ctx.needs_input_grad[1] else None,
            None,
            None,
            None,
        )


def hash_encode_blocked(
    table: torch.Tensor, positions: torch.Tensor, config: HashEncodingConfig
) -> torch.Tensor:
    """The blocked layout's encode (lsenerf_tpu/ops/hash_encoding.py::
    hash_encode_blocked): (n, 3) positions in [0,1]^3 -> (n, out_dim), one
    row of 27 x F features a sample-level, through K1/K2 (K1g/K2g). As in
    JAX, the table is read as the blocked layout's (total_rows,
    blocked_row_width) whatever `config.layout` says."""
    if config.layout != "blocked":
        config = dataclasses.replace(config, layout="blocked")
    return _Encode.apply(
        table, positions, levels_for(config, positions.device),
        config.gather_dtype == "bfloat16", combine,
    )


def hash_encode(
    table: torch.Tensor, positions: torch.Tensor, config: HashEncodingConfig
) -> torch.Tensor:
    """Encode (n, 3) positions in [0,1]^3 -> (n, out_dim) features of the
    active level window. Differentiable in the table and in the
    positions; the table's gradient has the table's whole shape."""
    if config.layout == "blocked":
        return hash_encode_blocked(table, positions, config)
    return _Encode.apply(
        table, positions, levels_for(config, positions.device),
        config.gather_dtype == "bfloat16", ngp,
    )
