"""The blocked hash encode in plain PyTorch: the frozen copy of the port's
ops/combine.py without its kernels (K1/K2/K1g/K2g). `encode_fwd` and
`encode_bwd` run the plain versions on any device."""

from __future__ import annotations

from dataclasses import dataclass

import torch


_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF





@dataclass(frozen=True, eq=False)
class Levels:
    """Per-level constants of one encode, on one device.

    scale: (L,) f32 grid resolutions; params: (L, 4) int32 rows of
    (res, bdim, dense flag, global row offset); hash_mask: 2^rows_log2 - 1;
    F: features per vertex; row_width: the table's columns (27*F used).
    """

    scale: torch.Tensor
    params: torch.Tensor
    hash_mask: int
    total_rows: int
    F: int
    row_width: int

    @property
    def num(self) -> int:
        return self.scale.shape[0]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def keys_fracs(positions: torch.Tensor, levels: Levels):
    """(n, 3) unit positions -> global row keys (L, n) int64 and per-dim
    parities o and fractions w, each a list of three (L, n) tensors.

    The hash is the JAX uint32 hash done in int64, masked to 32 bits after
    each product, so it wraps exactly as uint32 does."""
    scale = levels.scale[:, None]
    p = levels.params.long()
    res, bdim, dense, off = (p[:, j : j + 1] for j in range(4))
    ks, os_, ws = [], [], []
    for d in range(3):
        s = positions[None, :, d] * scale  # (L, n)
        b = torch.minimum(torch.floor(s).long().clamp(min=0), res - 1)
        ws.append(s - b.float())
        ks.append(b >> 1)
        os_.append(b & 1)
    kx, ky, kz = ks
    key_dense = (kx * bdim + ky) * bdim + kz
    h = (kx * _PRIMES[0]) & _U32
    h = h ^ ((ky * _PRIMES[1]) & _U32)
    h = h ^ ((kz * _PRIMES[2]) & _U32)
    keys = torch.where(dense.bool(), key_dense, h & levels.hash_mask) + off
    return keys, os_, ws


def _slot_weights(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weights of block slots {0, 1, 2} per dimension: (..., 3)."""
    of = o.float()
    return torch.stack(
        [(1.0 - w) * (1.0 - of), w * (1.0 - of) + (1.0 - w) * of, w * of], -1
    )


def _gather_rows(table, keys, F):
    L, n = keys.shape
    rows = table.index_select(0, keys.reshape(-1)).float()
    return rows[:, :27 * F].reshape(L, n, 27, F)


def encode_fwd_plain(positions, table, levels: Levels) -> torch.Tensor:
    n, L, F = positions.shape[0], levels.num, levels.F
    keys, o, w = keys_fracs(positions, levels)
    ux, uy, uz = (_slot_weights(o[d], w[d]) for d in range(3))
    w27 = (
        ux[..., :, None, None] * uy[..., None, :, None] * uz[..., None, None, :]
    ).reshape(L, n, 27)
    feats = (_gather_rows(table, keys, F) * w27[..., None]).sum(2)  # (L, n, F)
    return feats.permute(1, 0, 2).reshape(n, L * F)


def encode_bwd_plain(positions, table, gfeat, levels: Levels):
    n, L, F = positions.shape[0], levels.num, levels.F
    keys, o, w = keys_fracs(positions, levels)
    ux, uy, uz = (_slot_weights(o[d], w[d]) for d in range(3))
    g = gfeat.reshape(n, L, F).permute(1, 0, 2)  # (L, n, F)
    rows = _gather_rows(table, keys, F)
    dw27 = (rows * g[:, :, None, :]).sum(-1).reshape(L, n, 3, 3, 3)
    du = (
        (dw27 * uy[..., None, :, None] * uz[..., None, None, :]).sum((3, 4)),
        (dw27 * ux[..., :, None, None] * uz[..., None, None, :]).sum((2, 4)),
        (dw27 * ux[..., :, None, None] * uy[..., None, :, None]).sum((2, 3)),
    )
    scale = levels.scale[:, None]
    dpos = []
    for d in range(3):
        of = o[d].float()
        dw = (
            -du[d][..., 0] * (1.0 - of)
            + du[d][..., 1] * (1.0 - 2.0 * of)
            + du[d][..., 2] * of
        )
        dpos.append((dw * scale).sum(0))
    w27 = (
        ux[..., :, None, None] * uy[..., None, :, None] * uz[..., None, None, :]
    ).reshape(L, n, 27)
    upd = (w27[..., None] * g[:, :, None, :]).reshape(L * n, 27 * F)
    dtable = torch.zeros(
        (levels.total_rows, levels.row_width), dtype=torch.float32, device=positions.device
    )
    dtable[:, :27 * F].index_add_(0, keys.reshape(-1), upd)
    return torch.stack(dpos, 1), dtable


def encode_fwd(positions, table, levels: Levels) -> torch.Tensor:
    return encode_fwd_plain(positions, table, levels)


def encode_bwd(positions, table, gfeat, levels: Levels):
    return encode_bwd_plain(positions, table, gfeat, levels)
