"""The bound rule of the port's `chip_smoke.py` (PERF.md's kernel table),
frozen: the least time a piece of work can take on one NVIDIA H100 SXM,
the larger of its bytes at the HBM rate and its f32 operations at the
f32 rate outside the tensor cores. Inputs and outputs count once; a hash
table counts as the distinct rows (entries) its inputs touch.

Every count is worked out from the inputs (positions, rays, grids) that
the benchmark's own reference pass saw, never from a count the program
reports. The functions at the end are what `kernels/<family>.json` names.
"""

from __future__ import annotations

import dataclasses

import torch

from perfbench.frozen.ref.ops import combine, march, ngp
from perfbench.frozen.ref.ops import occupancy as occ_lib

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores


def bound_s(nbytes: float, ops: float) -> float:
    """The least time for the work, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


# -- the encodes (chip_smoke.encode_bounds / ngp_bounds) ----------------------


def blocked_encode(pos: torch.Tensor, lv, table_bytes: int):
    """(K1's, K2's) bounds in s at these positions: the blocked layout's
    rows counted as the distinct rows touched, 27 F used values each in the
    table's type; K2 writes the whole f32 gradient table."""
    n, L, F = pos.shape[0], lv.num, lv.F
    rows = int(torch.unique(combine.keys_fracs(pos, lv)[0]).numel())
    row_bytes = rows * 27 * F * table_bytes
    m = n * L
    fwd_bytes = n * 3 * 4 + row_bytes + m * F * 4
    fwd_ops = m * (3 * 4 + 9 + 27 + 27 * F * 2)
    bwd_bytes = n * 3 * 4 + row_bytes + m * F * 4 + n * 3 * 4 + lv.total_rows * lv.row_width * 4
    bwd_ops = m * (3 * 4 + 27 * 2 * F + 27 * 3 * 3 + 27 * 2 + 8 * F * 2 + 3 * 4)
    return bound_s(fwd_bytes, fwd_ops), bound_s(bwd_bytes, bwd_ops)


def ngp_encode(pos: torch.Tensor, lv, F: int, table_bytes: int):
    """(K7a's, K7b's) bounds in s at these positions: the distinct entries
    touched, F values each in the table's type; K7b writes the whole f32
    gradient table."""
    n, L = pos.shape[0], lv.num
    entries = int(torch.unique(ngp.corners(pos, lv)[0]).numel())
    entry_bytes = entries * F * table_bytes
    m = n * L
    fwd_bytes = n * 3 * 4 + entry_bytes + m * F * 4
    fwd_ops = m * (3 * 3 + 3 + 8 * 2 + 8 * F * 2)
    bwd_bytes = n * 3 * 4 + entry_bytes + m * F * 4 + n * 3 * 4 + lv.table_rows * F * 4
    bwd_ops = m * (3 * 3 + 3 + 8 * 2 + 8 * (2 * F - 1 + 6 + 3 + F) + 3)
    return bound_s(fwd_bytes, fwd_ops), bound_s(bwd_bytes, bwd_ops)


# -- the march (chip_smoke.march_ops / march_bound) ---------------------------


def march_ops(o, d, nears, fars, state, gcfg, cfg) -> int:
    """K3's f32 operations on these rays, from what the plain march needs
    of them (chip_smoke.march_ops)."""
    lookup, t = 35, 2
    t_lo, t_hi = march.ray_range(o, d, nears, fars, gcfg, cfg)
    ops = 30 * o.shape[0]
    if march.use_hierarchical(gcfg, cfg):
        tc, _, keep_c = march._phase1(o, d, t_lo, t_hi, state, gcfg, cfg)
        bounds = torch.clamp((tc[:, :-1] < t_hi[:, None]).sum(1) + 1, max=tc.shape[1])
        k1 = cfg.max_coarse_segments
        count = keep_c.sum(1)
        stride = torch.clamp((count + k1 - 1) // k1, min=1)
        cands = (count + stride - 1) // stride * cfg.coarse_factor
        ops += int(bounds.sum()) * (t + lookup)
    else:
        i = torch.arange(cfg.max_candidates, dtype=torch.float32, device=o.device)[None, :]
        cands = (march.ts_at_indices(t_lo, i, cfg) < t_hi[:, None]).sum(1)
    ops += int(cands.sum()) * (2 * t + 4 + lookup)
    pre = dataclasses.replace(cfg, proposal_samples=0)
    sel = march.march_ts_plain(o, d, nears, fars, state, gcfg, pre)[2].sum(1)
    ops += 2 * int(sel.sum())
    if march.uses_proposal(cfg):
        ops += int(sel.sum()) * (lookup + 8 + 6) + 10 * cfg.proposal_samples * int((sel > 0).sum())
    return ops


def march_bound(o, d, nears, fars, state, gcfg, cfg) -> float:
    """K3's least time in s on these rays: rays (and nears/fars) read once,
    each distinct grid cell its lookups read (a byte a bool, 4 a f32 EMA),
    the outputs written once; its operations each at half the FMA rate."""
    seen, real = {}, occ_lib._take

    def watch(grid, flat):
        key = (grid.data_ptr(), grid.element_size(), tuple(grid.shape))
        seen.setdefault(key, []).append(flat.reshape(-1))
        return real(grid, flat)

    occ_lib._take = watch
    try:
        t_starts, _, _ = march.march_ts_plain(o, d, nears, fars, state, gcfg, cfg)
    finally:
        occ_lib._take = real
    grid_bytes = sum(int(torch.unique(torch.cat(v)).numel()) * k[1] for k, v in seen.items())
    n, m = t_starts.shape
    nbytes = n * 24 + (n * 4 if nears is not None else 0) + (n * 4 if fars is not None else 0)
    nbytes += grid_bytes + n * m * 9
    return bound_s(nbytes, 2 * march_ops(o, d, nears, fars, state, gcfg, cfg))


# -- what the kernel families name -----------------------------------------------


def _encode_total(work: dict, kind: str, layout: str, generic: bool) -> float:
    """The encode calls of one kind and layout, at F = 2 (the K1/K2/K7a/K7b
    kernels) or at any other F (the generic ones)."""
    return sum(c["bound_s"] * c["count"] for c in work.get("encode", [])
               if c["kind"] == kind and c["layout"] == layout and (c["F"] != 2) == generic)


def _nonzero(x: float):
    return x if x > 0 else None


# Each takes the cell's work in the traced window ({"encode": [{"kind",
# "layout", "F", "bound_s", "count"}], "march": [{"bound_s", "count"}]})
# and returns the bound in s of the family's part of it, or None where the
# window holds none. A kernels/<family>.json names one as "bounds.<name>".


def blocked_fwd(work: dict):
    return _nonzero(_encode_total(work, "fwd", "blocked", False))


def blocked_bwd(work: dict):
    return _nonzero(_encode_total(work, "bwd", "blocked", False))


def blocked_fwd_f(work: dict):
    return _nonzero(_encode_total(work, "fwd", "blocked", True))


def blocked_bwd_f(work: dict):
    return _nonzero(_encode_total(work, "bwd", "blocked", True))


def ngp_fwd(work: dict):
    return _nonzero(_encode_total(work, "fwd", "ngp", False))


def ngp_bwd(work: dict):
    return _nonzero(_encode_total(work, "bwd", "ngp", False))


def ngp_fwd_f(work: dict):
    return _nonzero(_encode_total(work, "fwd", "ngp", True))


def ngp_bwd_f(work: dict):
    return _nonzero(_encode_total(work, "bwd", "ngp", True))


def march_k3(work: dict):
    return _nonzero(sum(c["bound_s"] * c["count"] for c in work.get("march", [])))
