"""The ngp hash encode in plain PyTorch: the frozen copy of the port's
ops/ngp.py without its kernels (K7a/K7b/K7ag/K7bg). `encode_fwd` and
`encode_bwd` run the plain versions on any device."""

from __future__ import annotations

from dataclasses import dataclass

import torch


_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF




@dataclass(frozen=True, eq=False)
class Levels:
    """The level window of one encode, on one device.

    scale: (Lw,) f32 grid resolutions of levels lo .. lo + Lw - 1; lo: the
    window's first level; log2_T: log2 of the entries a level; levels: the
    ladder's level count, which sets the table's rows (levels * 2^log2_T)."""

    scale: torch.Tensor
    lo: int
    log2_T: int
    levels: int

    @property
    def num(self) -> int:
        return self.scale.shape[0]

    @property
    def table_rows(self) -> int:
        return self.levels << self.log2_T


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def corners(positions: torch.Tensor, lv: Levels):
    """(n, 3) unit positions -> the 8 corners' global table entries (8, Lw,
    n) int64, their weights (8, Lw, n) f32, and the fractions w, a list of
    three (Lw, n) tensors. Corners in JAX's order (x outer, z inner). The
    hash is JAX's uint32 one, done in int64 and masked to 32 bits after each
    product, so it wraps as uint32 does."""
    s = [positions[None, :, d] * lv.scale[:, None] for d in range(3)]  # (Lw, n)
    fl = [torch.floor(x) for x in s]
    w = [x - f for x, f in zip(s, fl)]
    b = [f.long() for f in fl]
    mask = (1 << lv.log2_T) - 1
    off = (torch.arange(lv.num, device=positions.device)[:, None] + lv.lo) << lv.log2_T
    keys, weights = [], []
    for i in (0, 1):
        wx = w[0] if i else 1.0 - w[0]
        hx = ((b[0] + i) & _U32) * _PRIMES[0] & _U32
        for j in (0, 1):
            wy = w[1] if j else 1.0 - w[1]
            hy = ((b[1] + j) & _U32) * _PRIMES[1] & _U32
            for k in (0, 1):
                wz = w[2] if k else 1.0 - w[2]
                hz = ((b[2] + k) & _U32) * _PRIMES[2] & _U32
                keys.append(((hx ^ hy ^ hz) & mask) + off)
                weights.append(wx * wy * wz)
    return torch.stack(keys), torch.stack(weights), w


def _gather(table, keys):
    return table.index_select(0, keys.reshape(-1)).float().reshape(*keys.shape, table.shape[1])


def encode_fwd_plain(positions, table, lv: Levels) -> torch.Tensor:
    n, F = positions.shape[0], table.shape[1]
    keys, wts, _ = corners(positions, lv)
    vals = _gather(table, keys) * wts[..., None]  # (8, Lw, n, F)
    # the corners added one at a time, in order, as K7a adds them: the
    # result is then the same bits whatever the shape
    feats = vals[0]
    for c in range(1, 8):
        feats = feats + vals[c]
    return feats.permute(1, 0, 2).reshape(n, lv.num * F)


def encode_bwd_plain(positions, table, gfeat, lv: Levels):
    n, F = positions.shape[0], table.shape[1]
    keys, wts, w = corners(positions, lv)
    g = gfeat.reshape(n, lv.num, F).permute(1, 0, 2)  # (Lw, n, F)
    dW = (_gather(table, keys) * g[None]).sum(-1)  # (8, Lw, n)
    # the chain rule through weight = (wx' * wy') * wz' in autodiff's
    # order, then wx' = wx or 1 - wx
    u = [(1.0 - x, x) for x in w]
    dw = [torch.zeros_like(w[0]) for _ in range(3)]
    for c in range(8):
        ux, uy, uz = u[0][c >> 2], u[1][(c >> 1) & 1], u[2][c & 1]
        dxy = dW[c] * uz
        for d, term in enumerate((dxy * uy, dxy * ux, dW[c] * (ux * uy))):
            dw[d] = dw[d] + term if (c >> (2 - d)) & 1 else dw[d] - term
    dpos = torch.stack([(x * lv.scale[:, None]).sum(0) for x in dw], 1)
    upd = (wts[..., None] * g[None]).reshape(-1, F)
    dtable = torch.zeros((lv.table_rows, F), dtype=torch.float32, device=positions.device)
    dtable.index_add_(0, keys.reshape(-1), upd)
    return dpos, dtable


def encode_fwd(positions, table, lv: Levels) -> torch.Tensor:
    return encode_fwd_plain(positions, table, lv)


def encode_bwd(positions, table, gfeat, lv: Levels):
    return encode_bwd_plain(positions, table, gfeat, lv)
