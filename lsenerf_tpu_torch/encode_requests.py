"""Models of the generic encode kernels' memory requests and of K1g's
sums, worked out on any device from the plain versions' keys, not
measured: `requests`, the L2 atomic requests of one launch of K2g (blocked)
or K7bg (ngp); `fwd_requests`, the L1 wavefronts and L2 sector requests of
the table loads of one launch of K1g or K7ag; `vec_width`, `fwd_vec_width`,
`fwd_pair` and `fwd_staged`, the choices the kernels' C entries make from F,
the levels and the pointers' alignment; and `k1g_sums`, K1g's output by its
own order of f32 operations. chip_smoke.py prints the models beside the
kernels' times, and the tests hold them to the C sources and to a
brute-force walk of each design's warps.
"""

from __future__ import annotations

import torch

from lsenerf_tpu_torch.ops import combine, ngp

K2G_CHUNK = 8  # csrc/blocked_encode.cu kGenChunk: a corner's features a K2g entry holds
K7AG_SAMPLES = 64  # csrc/ngp_encode.cu kGenFwdSamples: K7ag's samples a block
K7AG_GROUP = 2  # csrc/ngp_encode.cu kGenFwdGroup: K7ag's levels a block, at most
FWD_STAGE = 48 * 1024  # kGenFwdStage of both: the most bytes a block stages its output in


# ---------------------------------------------------------------------------
# the request model
# ---------------------------------------------------------------------------


def _distinct(x: torch.Tensor) -> int:
    """The distinct values of each row of x's last dimension, summed; -1
    is no value."""
    s = x.sort(dim=-1).values
    d = 1 + (s[..., 1:] != s[..., :-1]).sum(-1)
    return int((d - (s[..., 0] < 0).long()).sum())


def _warps(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x's sample dimension `dim` as (warps, 32), the last warp padded with -1."""
    extra = -x.shape[dim] % 32
    if extra:
        pad = list(x.shape)
        pad[dim] = extra
        x = torch.cat([x, x.new_full(pad, -1)], dim)
    return x.unflatten(dim, (-1, 32))


def vec_width(F: int, table: torch.Tensor) -> int:
    """K7bg's V: the largest of 4, 2 and 1 that divides F and to whose
    width the table is aligned (the wrapper's fresh gradient always is)."""
    V = 4
    while V > 1 and (F % V or table.data_ptr() % (V * table.element_size())):
        V //= 2
    return V


def requests(layout: str, positions, table, gfeat, levels) -> tuple[int, int]:
    """The L2 atomic requests of one launch of K2g (blocked) or K7bg (ngp)
    on these inputs, (the first design's, this one's), worked out from the
    plain versions' keys on any device, not measured: one request per
    distinct 32-byte sector of the f32 gradient that one warp instruction
    adds to, zero updates not counted (the kernels skip them).

    The first design of both: a thread a sample, a warp on 32 consecutive
    samples, one scalar atomic instruction a (level, corner, feature) (K7bg:
    where the corner's weight is not 0). This K2g: a warp on one level of
    32 consecutive samples, whose 32 entries of 8 Fc updates (Fc = min(F,
    K2G_CHUNK), corner c's feature f0 + f at c Fc + f, for each chunk f0
    of the features) it adds 32 consecutive values an instruction.
    This K7bg: the first design with a vector of V values (`vec_width`) an
    instruction, which lies in one sector."""
    n, L = positions.shape[0], levels.num
    old = new = 0
    if layout == "blocked":
        F, W = levels.F, levels.row_width
        keys, o, w = combine.keys_fracs(positions, levels)
        g = gfeat.reshape(n, L, F)
        fs = torch.arange(F, device=positions.device)
        for l in range(L):
            u = [(1.0 - w[d][l], w[d][l]) for d in range(3)]
            sec = []
            for c in range(8):
                a, b, z = c >> 2, (c >> 1) & 1, c & 1
                v = ((o[0][l] + a) * 3 + o[1][l] + b) * 3 + o[2][l] + z
                upd = ((u[0][a] * u[1][b]) * u[2][z])[:, None] * g[:, l]
                addr = keys[l][:, None] * W + v[:, None] * F + fs
                sec.append(torch.where(upd != 0, addr >> 3, -1))
            sec = torch.stack(sec, 1)  # (n, 8, F): corner c's feature f
            old += _distinct(_warps(sec, 0).permute(0, 2, 3, 1))
            for f0 in range(0, F, K2G_CHUNK):
                entries = _warps(sec[:, :, f0:f0 + K2G_CHUNK].reshape(n, -1), 0)
                new += _distinct(entries.reshape(entries.shape[0], -1, 32))
        return old, new
    F = table.shape[1]
    V = vec_width(F, table)
    keys, wts, _ = ngp.corners(positions, levels)  # (8, L, n)
    fs = torch.arange(F, device=positions.device)
    for l in range(L):
        addr = keys[:, l, :, None] * F + fs  # (8, n, F)
        live = (wts[:, l] != 0)[..., None]
        old += _distinct(_warps(torch.where(live, addr >> 3, -1), 1).permute(1, 0, 3, 2))
        vec = torch.where(live, addr[..., ::V] >> 3, -1)
        new += _distinct(_warps(vec, 1).permute(1, 0, 3, 2))
    return old, new


# ---------------------------------------------------------------------------
# the forwards: their choices, their loads' model and K1g's sums
# ---------------------------------------------------------------------------


def fwd_vec_width(layout: str, F: int, table: torch.Tensor, row_width: int | None = None) -> int:
    """K1g's and K7ag's V: the largest of 4, 2 and 1 that divides F (and,
    blocked, the row width W) and to whose width the table is aligned (the
    wrapper's fresh output always is), as their C entries choose it."""
    V = 4
    while V > 1 and (F % V or (layout == "blocked" and row_width % V)
                     or table.data_ptr() % (V * table.element_size())):
        V //= 2
    return V


def fwd_pair(F: int, table: torch.Tensor) -> bool:
    """Whether K7ag loads a cube's x-pair, entries h & ~1 and h | 1, as one:
    F == V, 2F values in at most 16 bytes, to whose width the table is
    aligned."""
    b = 2 * F * table.element_size()
    return F == fwd_vec_width("ngp", F, table) and b <= 16 and table.data_ptr() % b == 0


def fwd_staged(layout: str, L: int, F: int) -> bool:
    """Whether a K1g or K7ag block stages its output in shared memory (with
    its positions, within FWD_STAGE bytes) or writes it from registers."""
    if layout == "blocked":
        return (96 + 32 * L * F) * 4 <= FWD_STAGE
    return K7AG_SAMPLES * (3 + min(L, K7AG_GROUP) * F) * 4 <= FWD_STAGE


def _loads(addr: torch.Tensor) -> tuple[int, int]:
    """(L1 wavefronts, L2 sector requests) of warp load instructions whose
    lanes' first bytes are addr (..., 32), -1 where a lane loads nothing:
    one wavefront per distinct 128-byte line, one request per distinct
    32-byte sector (no load here crosses a sector)."""
    live = addr >= 0
    return (_distinct(torch.where(live, addr >> 7, -1)),
            _distinct(torch.where(live, addr >> 5, -1)))


def fwd_requests(layout: str, positions, table, levels) -> tuple[tuple[int, int], tuple[int, int]]:
    """The table loads of one launch of K1g (blocked) or K7ag (ngp) on these
    inputs, ((wavefronts, sectors) of the first design, of this one),
    worked out from the plain versions' keys on any device, not measured:
    L1 wavefronts (a warp load instruction's distinct 128-byte lines) and
    L2 sector requests (its distinct 32-byte sectors), instruction by
    instruction, with no line kept in L1 from one instruction to the next.
    Addresses are the table's own (its offset in a 128-byte line counted).

    The first design of both: a thread a (sample, level), thread t on
    sample t / L, level t % L, a warp on 32 consecutive threads, one scalar
    load instruction a (corner, feature). This K7ag: a warp on one level of
    32 consecutive samples, one V-value load a (corner, V features)
    (`fwd_vec_width`); where `fwd_pair`, one load of entries h & ~1 and
    h | 1 a (cy, cz) and a load of the cx = 1 corner for the lanes whose
    cube's base x is odd. This K1g: a warp on 32 samples of one level, in 4
    steps of 8 samples, lane 4j + q on sample 8s + j's (x, y) pair q = 2a +
    b, whose z-neighbours' F values it loads V at a time (two instructions
    a V-step)."""
    n, L = positions.shape[0], levels.num
    elt, base = table.element_size(), table.data_ptr() % 128
    dev = positions.device

    def bytes_(e):  # element index -> byte address, -1 kept
        return torch.where(e >= 0, e * elt + base, -1)

    def add(acc, wf):
        return acc[0] + wf[0], acc[1] + wf[1]

    old = new = (0, 0)
    if layout == "blocked":
        F, W = levels.F, levels.row_width
        keys, o, _ = combine.keys_fracs(positions, levels)  # (L, n)
        V = fwd_vec_width(layout, F, table, W)
        v0 = (o[0] * 3 + o[1]) * 3 + o[2]
        for c in range(8):
            a, b, z = c >> 2, (c >> 1) & 1, c & 1
            e = (keys * W + (v0 + a * 9 + b * 3 + z) * F).T.reshape(-1)  # thread t = i L + l
            for f in range(F):
                old = add(old, _loads(_warps(bytes_(e + f), 0)))
        # r[l, i, q]: the first value of sample i's run q at level l
        r = keys[..., None] * W + (v0[..., None] + torch.tensor([0, 3, 9, 12], device=dev)) * F
        extra = -n % 32
        r = torch.cat([r, r.new_full((L, extra, 4), -1)], 1).reshape(L, -1, 4, 8, 4)
        lanes = r.reshape(L, -1, 4, 32)  # (level, block, step, lane 4 j + q)
        live = lanes >= 0
        for f in range(0, F, V):
            for e in (lanes + f, lanes + F + f):
                new = add(new, _loads(bytes_(torch.where(live, e, -1))))
        return old, new
    F = table.shape[1]
    V, pair = fwd_vec_width(layout, F, table), fwd_pair(F, table)
    keys = ngp.corners(positions, levels)[0]  # (8, L, n), corner c = cx*4 + cy*2 + cz
    flat = keys.permute(0, 2, 1).reshape(8, n * L)  # thread t = i L + l
    for f in range(F):
        old = add(old, _loads(_warps(bytes_(flat * F + f), 1)))
    per = _warps(keys, 2)  # (8, L, warp, 32)
    if pair:
        odd = _warps(torch.floor(positions[None, :, 0] * levels.scale[:, None]).long() % 2, 1)
        e0 = per[:4]
        new = add(new, _loads(bytes_(torch.where(e0 >= 0, (e0 & ~1) * F, -1))))
        new = add(new, _loads(bytes_(torch.where((odd == 1) & (per[4:] >= 0), per[4:] * F, -1))))
        return old, new
    for f in range(0, F, V):
        new = add(new, _loads(bytes_(torch.where(per >= 0, per * F + f, -1))))
    return old, new


def k1g_sums(positions, table, levels) -> torch.Tensor:
    """K1g's output by its own arithmetic, op by op in f32 on any device
    (each product and sum rounded, as __fmul_rn and __fadd_rn round them):
    the group's lane q = 2a + b on its (x, y) pair, T(a, b) = w0 t(v) + w1
    t(v + 1) with w0 = (ux uy) (1 - wz) and w1 = (ux uy) wz, and the
    shuffles' sum (T(0, 0) + T(0, 1)) + (T(1, 0) + T(1, 1)) (n, L F)."""
    n, L, F, W = positions.shape[0], levels.num, levels.F, levels.row_width
    keys, o, w = combine.keys_fracs(positions, levels)  # (L, n)
    flat = table.reshape(-1)
    fs = torch.arange(F, device=positions.device)
    v0 = (o[0] * 3 + o[1]) * 3 + o[2]
    t = {}
    for a in (0, 1):
        for b in (0, 1):
            r = (keys * W + (v0 + a * 9 + b * 3) * F)[..., None] + fs  # (L, n, F)
            ux = w[0] if a else 1.0 - w[0]
            uy = w[1] if b else 1.0 - w[1]
            wxy = ux * uy
            w0, w1 = (wxy * (1.0 - w[2]))[..., None], (wxy * w[2])[..., None]
            t[a, b] = w0 * flat[r].float() + w1 * flat[r + F].float()
    out = (t[0, 0] + t[0, 1]) + (t[1, 0] + t[1, 1])
    return out.permute(1, 0, 2).reshape(n, L * F)
