"""The port's kernels against their plain PyTorch versions on the card: K1
and K2 (lsenerf_tpu_torch/ops/combine.py) and K7a and K7b
(lsenerf_tpu_torch/ops/ngp.py, with level windows; K7a bit for bit), and
the generic K1g/K2g and K7ag/K7bg at features_per_level 1, 3, 4, 6, 8,
16, 20 and 400 (K7ag bit for bit, K1g the bits of its own order of sums;
K2g's and K7bg's dpos the bits of their first design's arithmetic; all
four also from a table view off their vector loads' alignment; the
forwards on both sides of their output's staging limit), in an f32-table
and a bf16-table arm, also where many samples of a warp share rows (one
cell, rays), at the flagship's 16 levels (16 and 48 samples a ray) and at 2 and 3 levels, and
the gathers G1-G3 (lsenerf_tpu_torch/ops/gather.py), held to exact
equality, G2 at the shapes that pick each of its paths and G3 at several
table and index shapes; K3 (lsenerf_tpu_torch/ops/march.py) at the
flagship's widths on three grids and past its static layout (96 slots and
coarse segments, 4096 candidates), its selection bit for bit, and K5a/K5b
(lsenerf_tpu_torch/ops/composite.py) at 1 to 200 samples a ray for every
background; scan_steps' chunk graph (lsenerf_tpu_torch/engine/
chunk_graph.py) against eager steps, a capture that fails, the march's
live-sample tally (engine/spans.py) replayed in lsenerf_emb's chunk as
its eager twin counts it, and a traced replay's read that leaves the card
busy; and the
fused capturable Adam (engine/trainer.py::build_optimizer) on the 64 MiB
table: 16 replayed steps bit for bit its eager steps, within f32 rounding
of the foreach Adam it replaced, and a checkpoint of that foreach Adam
loading into it; and K8a/K8b, the bundles layer's rays of a step and
their backward (lsenerf_tpu_torch/ops/bundles.py), against their plain
version on the CPU at the three train cells' presets and for every
camera-pose source, with query times outside the knots, the slerp's lerp
branch, zero rotations, a batch on one knot and one camera, a captured
graph's replay and the render path's forward at fixed poses; and K9a/K9b,
the field's MLP head (lsenerf_tpu_torch/ops/field_head.py), against its
plain version on the card at the three train cells' shapes, the
occupancy update's density chunk and operands spread over six decades
(where the plain version with one bf16 or TF32 product a layer is off the
limits), the same bits at a second call, a
16-step chunk graph holding a launch of each a step, and its dispatch (a
frozen field, another hidden width).

This file imports neither JAX nor the JAX package, so a machine with the
card and without JAX runs it on its own, skipping the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_card.py -q

Without a card the test skips: the kernels have no CPU mode."""

import numpy as np
import pytest
import torch

from lsenerf_tpu_torch.ops import combine, gather, ngp
from lsenerf_tpu_torch.ops import hash_encoding as the
from test_torch_adam import _foreach_adam

# 5 levels, res 4..64: levels 0-2 dense, 3-4 hashed (2^10 rows)
T_CFG = the.HashEncodingConfig(num_levels=5, base_res=4, max_res=64, layout="blocked",
                               blocked_rows_log2=10)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K1 and K2 against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(3)
    n, L = 4099, T_CFG.num_levels
    pos = rng.random((n, 3)).astype(np.float32)
    # corners, a clipped top cell and near-boundary coordinates
    pos[:4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.25, 0.75], [1e-7, 0.999999, 0.5]]
    table = rng.standard_normal((T_CFG.total_rows, 64)).astype(np.float32)
    g = np.random.default_rng(4).standard_normal((n, L * 2)).astype(np.float32)
    lv = the.levels_for(T_CFG, "cuda")
    p, t, gg = (torch.from_numpy(a).cuda() for a in (pos, table, g))
    for tab in (t, t.to(torch.bfloat16)):
        got = combine.encode_fwd(p, tab, lv)
        want = combine.encode_fwd_plain(p, tab, lv)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        dpos, dtab = combine.encode_bwd(p, tab, gg, lv)
        wdpos, wdtab = combine.encode_bwd_plain(p, tab, gg, lv)
        # level terms of dpos cancel: atol scales with the largest element
        torch.testing.assert_close(dpos, wdpos, rtol=1e-4,
                                   atol=1e-6 * float(wdpos.abs().max()))
        # atomics add in an order that changes from run to run
        torch.testing.assert_close(
            dtab, wdtab, rtol=0, atol=1e-5 * float(wdtab.abs().max())
        )
        assert not dtab[:, 54:].any()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _positions(kind, n, rng):
    """Unit positions (n, 3) f32: uniform; all inside one cell of the two
    coarsest levels of T_CFG; or rays of 16 ("rays") or 48 ("rays48")
    samples along short segments of the same length (48 a ray are 3x as
    dense), ray-major as the march gives them, all inside the unit cube;
    for the ngp kernels also on multiples of 1/64 ("faces": cell faces at
    every level of a power-of-2 scale, so base corners of both parities)
    and uniform in [-1.5, 2.5]^3 ("outside": negative base corners, which
    the field zeroes before the encode but the wrappers take)."""
    if kind == "uniform":
        return rng.random((n, 3)).astype(np.float32)
    if kind == "faces":
        return (rng.integers(0, 65, (n, 3)) / 64.0).astype(np.float32)
    if kind == "outside":
        return rng.uniform(-1.5, 2.5, (n, 3)).astype(np.float32)
    if kind == "one_cell":
        return (0.30 + 0.05 * rng.random((n, 3))).astype(np.float32)
    k = 48 if kind == "rays48" else 16
    rays = -(-n // k)
    origin = 0.15 + 0.7 * rng.random((rays, 1, 3))
    d = rng.standard_normal((rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = 0.004 * (16 / k) * np.arange(k)[None, :, None]
    return (origin + t * d).reshape(-1, 3)[:n].astype(np.float32)


# (positions, config, n), for K1 and K2: contention in one cell and along
# rays, at L = 5 and at the flagship's 16 levels and widths, n not a
# multiple of 32, and at 48 samples a ray (an lsenerf_emb step's 168,480,
# less 5); at L = 2 and 3 a block has fewer threads (32 L) than a block's
# 96 dpos values
ENCODE_CASES = {
    "uniform-L5": ("uniform", T_CFG, 4099),
    "one_cell-L5": ("one_cell", T_CFG, 4099),
    "rays-L5": ("rays", T_CFG, 4112),
    "rays-L16": ("rays", the.HashEncodingConfig(layout="blocked"), 56_192 - 7),
    "rays48-L16": ("rays48", the.HashEncodingConfig(layout="blocked"), 168_480 - 5),
    "uniform-L2": ("uniform", the.HashEncodingConfig(
        num_levels=2, base_res=4, max_res=16, layout="blocked", blocked_rows_log2=10), 1000),
    "rays-L3": ("rays", the.HashEncodingConfig(
        num_levels=3, base_res=4, max_res=64, layout="blocked", blocked_rows_log2=10), 1000),
}


def _encode_inputs(case, dtype, dev):
    kind, cfg, n = ENCODE_CASES[case]
    rng = np.random.default_rng(8)
    L = cfg.num_levels
    p = torch.from_numpy(_positions(kind, n, rng)).to(dev)
    tab = torch.from_numpy(rng.standard_normal((cfg.total_rows, 64)).astype(np.float32)).to(dev, dtype)
    gg = torch.from_numpy(rng.standard_normal((n, L * 2)).astype(np.float32)).to(dev)
    return p, tab, gg, the.levels_for(cfg, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_fwd_matches_plain_on_card(case, dtype):
    """K1 against its plain version: 8 weighted terms against 27, so the
    two differ by rounding only."""
    p, tab, _, lv = _encode_inputs(case, dtype, _card())
    torch.testing.assert_close(combine.encode_fwd(p, tab, lv), combine.encode_fwd_plain(p, tab, lv),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_encode_fwd_reads_only_the_cube_on_card():
    """K1 reads only the 2 x 2 x 2 cube of vertices that carry weight: NaN in
    a vertex outside it, which makes the plain version's sum NaN, leaves
    the features as they are."""
    dev = _card()
    n = 37  # one sample repeated, over two blocks
    p = torch.tensor([[0.31, 0.77, 0.52]], device=dev).expand(n, 3).contiguous()
    rng = np.random.default_rng(11)
    tab = torch.from_numpy(rng.standard_normal((T_CFG.total_rows, 64)).astype(np.float32)).to(dev)
    lv = the.levels_for(T_CFG, "cuda")
    keys, o, _ = combine.keys_fracs(p, lv)
    poisoned = tab.clone()
    for l in range(T_CFG.num_levels):
        # the x slot outside {o, o + 1}, at the cube's y and z slots
        sx, sy, sz = (0 if o[0][l, 0] else 2), int(o[1][l, 0]), int(o[2][l, 0])
        v = (sx * 3 + sy) * 3 + sz
        poisoned[keys[l, 0], 2 * v:2 * v + 2] = float("nan")
    assert combine.encode_fwd_plain(p, poisoned, lv).isnan().any()
    torch.testing.assert_close(combine.encode_fwd(p, poisoned, lv),
                               combine.encode_fwd_plain(p, tab, lv), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_bwd_matches_plain_on_card(case, dtype):
    """K2 against its plain version, also where many samples of one warp add
    into the same row. dpos is the same bits from call to call; the pad
    columns 54-63 of the table gradient stay zero."""
    p, tab, gg, lv = _encode_inputs(case, dtype, _card())
    dpos, dtab = combine.encode_bwd(p, tab, gg, lv)
    wdpos, wdtab = combine.encode_bwd_plain(p, tab, gg, lv)
    torch.testing.assert_close(dpos, wdpos, rtol=1e-4, atol=1e-6 * float(wdpos.abs().max()))
    torch.testing.assert_close(dtab, wdtab, rtol=0, atol=1e-5 * float(wdtab.abs().max()))
    assert not dtab[:, 54:].any()
    again, _ = combine.encode_bwd(p, tab, gg, lv)
    assert torch.equal(dpos, again), "dpos differs from call to call"


# (positions, config, n) for K7a and K7b: the ngp layout at L = 5 with
# 2^10 entries a level, in one cell and along rays, a level window, and at
# the badnerf preset's 16 levels of 2^19 entries (56,192 samples, less 7)
# with the window [4, 16) of the strided field's fine encode. K7a's blocks
# take 64 samples x 4 levels: n of 1 and 129 and windows of 1, 3, 5 and 12
# levels leave ragged sample blocks and level groups; cell faces give base
# corners of both parities (the x-pair load and its single-load branch),
# and positions outside the cube negative ones.
NGP_CFG = the.HashEncodingConfig(num_levels=5, base_res=4, max_res=64, log2_hashmap_size=10)


def _ngp_cfg(**kw):
    return the.HashEncodingConfig(num_levels=5, base_res=4, max_res=64, log2_hashmap_size=10, **kw)


NGP_CASES = {
    "uniform-L5": ("uniform", NGP_CFG, 4099),
    "one_cell-L5": ("one_cell", NGP_CFG, 4099),
    "rays-L5-window-1-4": ("rays", _ngp_cfg(level_lo=1, level_hi=4), 4112),
    "rays-L16": ("rays", the.HashEncodingConfig(), 56_192 - 7),
    "rays-L16-window-4-16": ("rays", the.HashEncodingConfig(level_lo=4), 56_192 - 7),
    "uniform-L5-n1": ("uniform", NGP_CFG, 1),
    "rays-L5-n129": ("rays", NGP_CFG, 129),
    "uniform-L5-window-2-3": ("uniform", _ngp_cfg(level_lo=2, level_hi=3), 4099),
    "rays-L5-window-0-3": ("rays", _ngp_cfg(level_hi=3), 1000),
    "faces-L5": ("faces", NGP_CFG, 4099),
    "faces-L16": ("faces", the.HashEncodingConfig(), 5000),
    "outside-L5": ("outside", NGP_CFG, 4099),
    "outside-L16-window-4-16": ("outside", the.HashEncodingConfig(level_lo=4), 5000),
}


def _ngp_inputs(case, dtype, dev):
    kind, cfg, n = NGP_CASES[case]
    rng = np.random.default_rng(9)
    p = torch.from_numpy(_positions(kind, n, rng)).to(dev)
    tab = torch.from_numpy(rng.standard_normal(cfg.table_shape).astype(np.float32)).to(dev, dtype)
    gg = torch.from_numpy(rng.standard_normal((n, cfg.out_dim)).astype(np.float32)).to(dev)
    return p, tab, gg, the.levels_for(cfg, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(NGP_CASES))
def test_ngp_encode_matches_plain_on_card(case, dtype):
    """K7a and K7b against their plain versions. The keys are the same bits,
    so the forward differs by the order of the 8-corner sum only; the table
    gradient's atomics add in an order that changes from run to run; dpos
    sums level terms that cancel (atol scales with its largest element) and
    is the same bits from call to call."""
    p, tab, gg, lv = _ngp_inputs(case, dtype, _card())
    torch.testing.assert_close(ngp.encode_fwd(p, tab, lv), ngp.encode_fwd_plain(p, tab, lv),
                               rtol=1e-5, atol=1e-6)
    dpos, dtab = ngp.encode_bwd(p, tab, gg, lv)
    wdpos, wdtab = ngp.encode_bwd_plain(p, tab, gg, lv)
    torch.testing.assert_close(dpos, wdpos, rtol=1e-4, atol=1e-6 * float(wdpos.abs().max()))
    torch.testing.assert_close(dtab, wdtab, rtol=0, atol=1e-5 * float(wdtab.abs().max()))
    lo, hi = lv.lo << lv.log2_T, (lv.lo + lv.num) << lv.log2_T
    assert not dtab[:lo].any() and not dtab[hi:].any(), "levels outside the window moved"
    again, _ = ngp.encode_bwd(p, tab, gg, lv)
    assert torch.equal(dpos, again), "dpos differs from call to call"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(NGP_CASES))
def test_ngp_fwd_is_the_plain_bits_on_card(case, dtype):
    """K7a computes the plain forward's keys and weights and adds the 8
    corners in its order: the same values, and the same bits (signed zeros
    too)."""
    p, tab, _, lv = _ngp_inputs(case, dtype, _card())
    got, want = ngp.encode_fwd(p, tab, lv), ngp.encode_fwd_plain(p, tab, lv)
    assert torch.equal(got, want)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_ngp_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    p, tab, gg, lv = _ngp_inputs("uniform-L5", torch.float32, dev)
    # the right shape one entry off K7a's aligned x-pair loads
    shifted = torch.empty((tab.numel() + 2,), device=dev)[2:].view(tab.shape)
    for args in ((p.double(), tab, lv), (p, tab[1:], lv), (p, tab.half(), lv), (p, tab.T, lv),
                 (p, shifted, lv)):
        with pytest.raises(ValueError):
            ngp.encode_fwd(*args)
    with pytest.raises(ValueError):
        ngp.encode_bwd(p, tab, gg[:, :-2], lv)


# the generic kernels K1g/K2g (blocked) and K7ag/K7bg (ngp) at F != 2: L = 5
# (blocked: 3 dense and 2 hashed levels of 2^10 rows; ngp: 2^10 entries a
# level) on uniform positions, along rays and (ngp) on cell faces and
# outside the cube, and at the 4v paths' 8 levels of the full-width grids
def _generic_cfg(layout, F, full=False):
    if full:
        return the.HashEncodingConfig(layout=layout, num_levels=8, features_per_level=F)
    return the.HashEncodingConfig(num_levels=5, base_res=4, max_res=64, layout=layout,
                                  blocked_rows_log2=10, log2_hashmap_size=10,
                                  features_per_level=F)


GENERIC_KINDS = {"blocked": (("uniform", 4099), ("rays", 4112), ("one_cell", 1000)),
                 "ngp": (("uniform", 4099), ("rays", 4112), ("faces", 4099),
                         ("outside", 4099))}


def _generic_check(layout, cfg, kind, n, dtype, dev):
    mod = combine if layout == "blocked" else ngp
    kf, kb = (combine.K1G, combine.K2G) if layout == "blocked" else (ngp.K7AG, ngp.K7BG)
    rng = np.random.default_rng(12)
    p = torch.from_numpy(_positions(kind, n, rng)).to(dev)
    tab = torch.from_numpy(rng.standard_normal(cfg.table_shape).astype(np.float32)).to(dev, dtype)
    gg = torch.from_numpy(rng.standard_normal((n, cfg.out_dim)).astype(np.float32)).to(dev)
    lv = the.levels_for(cfg, "cuda")
    before = kf.launches, kb.launches
    got, want = mod.encode_fwd(p, tab, lv), mod.encode_fwd_plain(p, tab, lv)
    dpos, dtab = mod.encode_bwd(p, tab, gg, lv)
    torch.cuda.synchronize()
    assert (kf.launches, kb.launches) == (before[0] + 1, before[1] + 1), "not the generic kernels"
    if layout == "ngp":  # the plain forward's keys, weights and order: its bits
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:  # 8 weighted terms against 27
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    wdpos, wdtab = mod.encode_bwd_plain(p, tab, gg, lv)
    torch.testing.assert_close(dpos, wdpos, rtol=1e-4, atol=1e-6 * float(wdpos.abs().max()))
    torch.testing.assert_close(dtab, wdtab, rtol=0, atol=1e-5 * float(wdtab.abs().max()))
    if layout == "blocked":
        assert not dtab[:, 27 * cfg.features_per_level:].any(), "pad columns moved"
    again, _ = mod.encode_bwd(p, tab, gg, lv)
    assert torch.equal(dpos, again), "dpos differs from call to call"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("layout", ["blocked", "ngp"])
def test_generic_encode_matches_plain_on_card(layout, F, dtype):
    """K1g/K2g and K7ag/K7bg, which the wrappers launch at F != 2, against
    their plain versions (K7ag bit for bit; the rest with K1/K2's and
    K7b's tolerances), at L = 5 for each kind of positions and at 8 levels
    of the full-width grid along rays (56,192 samples, less 7). F = 6 takes
    K7bg's float2 width, F = 16 four float4s a corner and fewer K2g warps
    than levels."""
    dev = _card()
    for kind, n in GENERIC_KINDS[layout]:
        _generic_check(layout, _generic_cfg(layout, F), kind, n, dtype, dev)
    _generic_check(layout, _generic_cfg(layout, F, full=True), "rays", 56_192 - 7, dtype, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [20, 400])
@pytest.mark.parametrize("layout", ["blocked", "ngp"])
def test_generic_encode_at_wide_F_on_card(layout, F, dtype):
    """The generic kernels past the common widths, at L = 5: F = 20 takes
    K2g's entries in three feature chunks (8, 8, 4); F = 400 leaves both
    backwards' cotangent unstaged (it outgrows a block's shared memory)."""
    dev = _card()
    for kind, n in GENERIC_KINDS[layout][:2]:
        _generic_check(layout, _generic_cfg(layout, F), kind, n, dtype, dev)


def _scalar_design_dpos(layout, p, tab, gg, lv):
    """dpos as the first design of K2g and K7bg (a thread a sample)
    computed it, op by op in f32 (torch's elementwise kernels round each
    product and each sum, as __fmul_rn and __fadd_rn do): levels in order,
    corners in order, a corner's d loss / d weight over its features in
    order, the chain rule, and the level terms added from 0 in level
    order."""
    n, L = p.shape[0], lv.num
    zero = torch.zeros(n, device=p.device)
    acc = [zero] * 3
    if layout == "blocked":
        F = lv.F
        keys, o, w = combine.keys_fracs(p, lv)
        g = gg.reshape(n, L, F)
        for l in range(L):
            u = [(1.0 - w[d][l], w[d][l]) for d in range(3)]
            du = [[zero, zero] for _ in range(3)]
            row = tab[keys[l]]
            for c in range(8):
                a, b, z = c >> 2, (c >> 1) & 1, c & 1
                v = ((o[0][l] + a) * 3 + o[1][l] + b) * 3 + o[2][l] + z
                vals = row.gather(1, v[:, None] * F + torch.arange(F, device=p.device)).float()
                gv = zero
                for f in range(F):
                    gv = gv + vals[:, f] * g[:, l, f]
                du[0][a] = du[0][a] + (gv * u[1][b]) * u[2][z]
                du[1][b] = du[1][b] + (gv * u[0][a]) * u[2][z]
                du[2][z] = du[2][z] + (gv * u[0][a]) * u[1][b]
            for d in range(3):
                acc[d] = acc[d] + (du[d][1] - du[d][0]) * lv.scale[l]
        return torch.stack(acc, 1)
    F = tab.shape[1]
    keys, _, w = ngp.corners(p, lv)
    g = gg.reshape(n, L, F)
    for l in range(L):
        u = [(1.0 - w[d][l], w[d][l]) for d in range(3)]
        dw = [zero] * 3
        for c in range(8):
            bits = (c >> 2, (c >> 1) & 1, c & 1)
            vals = tab[keys[c, l]].float()
            dW = vals[:, 0] * g[:, l, 0]
            for f in range(1, F):
                dW = dW + vals[:, f] * g[:, l, f]
            ux, uy, uz = (u[d][bits[d]] for d in range(3))
            dxy = dW * uz
            for d, term in enumerate((dxy * uy, dxy * ux, dW * (ux * uy))):
                dw[d] = dw[d] + term if bits[d] else dw[d] - term
        for d in range(3):
            acc[d] = acc[d] + dw[d] * lv.scale[l]
    return torch.stack(acc, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 3, 4, 6])
@pytest.mark.parametrize("layout", ["blocked", "ngp"])
def test_generic_bwd_dpos_keeps_its_first_designs_bits_on_card(layout, F, dtype):
    """K2g and K7bg keep their first design's per-level arithmetic and add the level
    terms in level order: dpos is the bits of that arithmetic, whatever
    the warp layout, vector width or staging."""
    dev = _card()
    mod = combine if layout == "blocked" else ngp
    cfg = _generic_cfg(layout, F)
    for kind, n in GENERIC_KINDS[layout]:
        rng = np.random.default_rng(13)
        p = torch.from_numpy(_positions(kind, n, rng)).to(dev)
        tab = torch.from_numpy(rng.standard_normal(cfg.table_shape).astype(np.float32)).to(dev, dtype)
        gg = torch.from_numpy(rng.standard_normal((n, cfg.out_dim)).astype(np.float32)).to(dev)
        lv = the.levels_for(cfg, "cuda")
        dpos, _ = mod.encode_bwd(p, tab, gg, lv)
        want = _scalar_design_dpos(layout, p, tab, gg, lv)
        assert torch.equal(dpos.view(torch.int32), want.view(torch.int32)), kind


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["blocked", "ngp"])
def test_generic_bwd_takes_an_unaligned_table_on_card(layout, dtype):
    """A table view that starts 1 or 2 values past an aligned boundary (off
    the 16 bytes of K7bg's float4 and K2g's vector loads) goes through the
    kernel at a narrower vector width: the launch is counted, the result
    holds the plain version, and dpos is the aligned table's bits."""
    dev = _card()
    mod = combine if layout == "blocked" else ngp
    kb = combine.K2G if layout == "blocked" else ngp.K7BG
    cfg = _generic_cfg(layout, 4)
    rng = np.random.default_rng(14)
    n = 4099
    p = torch.from_numpy(_positions("uniform", n, rng)).to(dev)
    tab = torch.from_numpy(rng.standard_normal(cfg.table_shape).astype(np.float32)).to(dev, dtype)
    gg = torch.from_numpy(rng.standard_normal((n, cfg.out_dim)).astype(np.float32)).to(dev)
    lv = the.levels_for(cfg, "cuda")
    dpos, _ = mod.encode_bwd(p, tab, gg, lv)
    wdpos, wdtab = mod.encode_bwd_plain(p, tab, gg, lv)
    for off in (1, 2):
        view = torch.empty(tab.numel() + off, dtype=dtype, device=dev)[off:].view(tab.shape)
        view.copy_(tab)
        assert view.data_ptr() % 16 != 0
        before = kb.launches
        got, gtab = mod.encode_bwd(p, view, gg, lv)
        torch.cuda.synchronize()
        assert kb.launches == before + 1, "not the kernel"
        assert torch.equal(got.view(torch.int32), dpos.view(torch.int32))
        torch.testing.assert_close(got, wdpos, rtol=1e-4, atol=1e-6 * float(wdpos.abs().max()))
        torch.testing.assert_close(gtab, wdtab, rtol=0, atol=1e-5 * float(wdtab.abs().max()))


def _fwd_inputs(layout, cfg, n, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(_positions("uniform", n, rng)).to(dev)
    tab = torch.from_numpy(rng.standard_normal(cfg.table_shape).astype(np.float32)).to(dev, dtype)
    return p, tab, the.levels_for(cfg, "cuda")


def _fwd_holds(layout, got, want):
    """K7ag the plain version's bits; K1g within its check's tolerance."""
    if layout == "ngp":
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["blocked", "ngp"])
def test_generic_fwd_takes_an_unaligned_table_on_card(layout, dtype):
    """A table view that starts 1 or 2 values past an aligned boundary (off
    the 16 bytes of K1g's and K7ag's vector loads and K7ag's pair loads)
    goes through the kernel, at F = 4 with a narrower vector width (K7ag
    without the pair load), at F = 1 (K7ag) without the pair load where
    its 4 or 8 bytes are off too: the
    launch is counted and the output is the aligned table's bits (both
    kernels' sums take one order whatever the width)."""
    from lsenerf_tpu_torch import encode_requests

    dev = _card()
    mod = combine if layout == "blocked" else ngp
    kf = combine.K1G if layout == "blocked" else ngp.K7AG
    for F in (1, 4):
        cfg = _generic_cfg(layout, F)
        p, tab, lv = _fwd_inputs(layout, cfg, 4099, dtype, dev, 15)
        want = mod.encode_fwd(p, tab, lv)
        _fwd_holds(layout, want, mod.encode_fwd_plain(p, tab, lv))
        for off in (1, 2):
            view = torch.empty(tab.numel() + off, dtype=dtype, device=dev)[off:].view(tab.shape)
            view.copy_(tab)
            assert view.data_ptr() % 16 != 0
            W = cfg.blocked_row_width if layout == "blocked" else None
            if F == 4:  # a narrower V (K7ag: no pair load)
                assert encode_requests.fwd_vec_width(layout, F, view, W) < 4
                assert not encode_requests.fwd_pair(F, view)
            before = kf.launches
            got = mod.encode_fwd(p, view, lv)
            torch.cuda.synchronize()
            assert kf.launches == before + 1, "not the kernel"
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (F, off)


@pytest.mark.cuda
@pytest.mark.parametrize("past", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["blocked", "ngp"])
def test_generic_fwd_at_the_staging_limit_on_card(layout, dtype, past):
    """K1g and K7ag at L = 5 at the last F whose block output is staged in
    shared memory (encode_requests.fwd_staged, tied to the C sources) and at
    the next one, whose outputs each lane writes from registers: both
    against the plain version (K7ag bit for bit), on uniform positions
    and along rays."""
    from lsenerf_tpu_torch import encode_requests

    dev = _card()
    mod = combine if layout == "blocked" else ngp
    kf = combine.K1G if layout == "blocked" else ngp.K7AG
    F = next(F for F in range(1, 1000) if not encode_requests.fwd_staged(layout, 5, F)) - 1 + past
    assert F > 16 and encode_requests.fwd_staged(layout, 5, F) != past
    cfg = _generic_cfg(layout, F)
    for kind, n in (("uniform", 4099), ("rays", 4112)):
        rng = np.random.default_rng(16)
        p = torch.from_numpy(_positions(kind, n, rng)).to(dev)
        tab = torch.from_numpy(rng.standard_normal(cfg.table_shape).astype(np.float32)).to(dev, dtype)
        lv = the.levels_for(cfg, "cuda")
        before = kf.launches
        got = mod.encode_fwd(p, tab, lv)
        torch.cuda.synchronize()
        assert kf.launches == before + 1, "not the kernel"
        _fwd_holds(layout, got, mod.encode_fwd_plain(p, tab, lv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 3, 4, 8, 20])
def test_k1g_is_its_own_order_of_sums_on_card(F, dtype):
    """K1g rounds every product and sum on its own, in a fixed order that
    encode_requests.k1g_sums repeats op by op: the same bits, at L = 5 on each
    kind of positions and at the full-width grid's 8 levels along rays."""
    from lsenerf_tpu_torch import encode_requests

    dev = _card()
    for cfg, kind, n in [(_generic_cfg("blocked", F), k, n) for k, n in GENERIC_KINDS["blocked"]] + [
            (_generic_cfg("blocked", F, full=True), "rays", 56_192 - 7)]:
        rng = np.random.default_rng(17)
        p = torch.from_numpy(_positions(kind, n, rng)).to(dev)
        tab = torch.from_numpy(rng.standard_normal(cfg.table_shape).astype(np.float32)).to(dev, dtype)
        lv = the.levels_for(cfg, "cuda")
        got = combine.encode_fwd(p, tab, lv)
        want = encode_requests.k1g_sums(p, tab, lv)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), kind


@pytest.mark.cuda
def test_generic_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    for layout in ("blocked", "ngp"):
        cfg = _generic_cfg(layout, 4)
        mod = combine if layout == "blocked" else ngp
        lv = the.levels_for(cfg, "cuda")
        p = torch.rand((33, 3), device=dev)
        tab = torch.zeros(cfg.table_shape, device=dev)
        gg = torch.zeros((33, cfg.out_dim), device=dev)
        for args in ((p.double(), tab, lv), (p, tab[1:], lv), (p, tab.half(), lv)):
            with pytest.raises(ValueError):
                mod.encode_fwd(*args)
        with pytest.raises(ValueError):
            mod.encode_bwd(p, tab, gg[:, :-1], lv)
    # F = 2 in rows other than K1's 64 columns
    lv = the.levels_for(_generic_cfg("blocked", 2), "cuda")
    odd = combine.Levels(scale=lv.scale, params=lv.params, hash_mask=lv.hash_mask,
                         total_rows=lv.total_rows, F=2, row_width=96)
    with pytest.raises(ValueError):
        combine.encode_fwd(torch.rand((4, 3), device=dev),
                           torch.zeros((lv.total_rows, 96), device=dev), odd)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want.cpu()), "not bit-identical"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [64, 128])
def test_row_gather_matches_plain_on_card(dtype, width):
    """G1; every fifth index lies outside the table and gives a zero row."""
    dev = _card()
    rng = np.random.default_rng(5)
    T, m = 1000, 4099
    table = torch.from_numpy(rng.standard_normal((T, width)).astype(np.float32)).to(dev, dtype)
    idx_np = rng.integers(0, T, m).astype(np.int32)
    idx_np[::5] = rng.choice([-1, T, T + 7, -(2**31)], size=idx_np[::5].shape)
    idx = torch.from_numpy(idx_np).to(dev)
    got = gather.row_gather(table, idx)
    _same(got, gather.row_gather_plain(table, idx))
    assert (got[::5] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_matches_plain_on_card(dtype, axis):
    """G2 on a ragged shape; some indices lie outside the axis."""
    dev = _card()
    rng = np.random.default_rng(6)
    R, C = 517, 131
    t = torch.from_numpy(rng.standard_normal((R, C)).astype(np.float32)).to(dev, dtype)
    n = (R, C)[axis]
    idx = torch.from_numpy(rng.integers(-3, n + 3, (R, C)).astype(np.int32)).to(dev)
    _same(gather.take_along(t, idx, axis), gather.take_along_plain(t, idx, axis))


# (R, C, dtype, axis): the probes' 8 x 128 and E2/M3 shapes; bf16 with an
# odd width; an axis-1 row wider than one block's tile (C > 1024, split over
# blocks) and than a block's shared memory; more row tiles than the grid's
# height
TAKE_CASES = {
    "8x128-axis0": (8, 128, torch.float32, 0),
    "8x128-axis1": (8, 128, torch.float32, 1),
    "E2-2048x128-axis0": (2048, 128, torch.float32, 0),
    "M3-1024x128-axis1": (1024, 128, torch.float32, 1),
    "bf16-odd-33x77-axis0": (33, 77, torch.bfloat16, 0),
    "bf16-odd-33x77-axis1": (33, 77, torch.bfloat16, 1),
    "wide-3x20000-axis1": (3, 20_000, torch.float32, 1),
    "tall-70000x1024-axis1": (70_000, 1024, torch.float32, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TAKE_CASES))
def test_take_along_shapes_on_card(case):
    """G2 at the shapes that pick its paths; indices out of range included."""
    dev = _card()
    R, C, dtype, axis = TAKE_CASES[case]
    rng = np.random.default_rng(9)
    t = torch.from_numpy(rng.standard_normal((R, C)).astype(np.float32)).to(dev, dtype)
    n = (R, C)[axis]
    idx = torch.from_numpy(rng.integers(-3, n + 3, (R, C)).astype(np.int32)).to(dev)
    if case.startswith("E2"):  # the row index broadcast over the columns
        idx = idx[:, :1].expand(R, C).contiguous()
    got = gather.take_along(t, idx, axis)
    _same(got, gather.take_along_plain(t, idx, axis))
    bad = (idx < 0) | (idx >= n)
    assert bad.any() and not got[bad].any()


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_unaligned_on_card(axis):
    """G2 on tensors 4 bytes off a 16-byte boundary: the element path."""
    dev = _card()
    rng = np.random.default_rng(10)
    R, C = 64, 128
    tbuf = torch.from_numpy(rng.standard_normal(R * C + 1).astype(np.float32)).to(dev)
    ibuf = torch.from_numpy(rng.integers(0, (R, C)[axis], R * C + 1).astype(np.int32)).to(dev)
    t, idx = tbuf[1:].view(R, C), ibuf[1:].view(R, C)
    assert t.data_ptr() % 16 and idx.data_ptr() % 16
    _same(gather.take_along(t, idx, axis), gather.take_along_plain(t, idx, axis))


# (T, W, R, n): the probe's case H; a 3000-row and a 20,000-row table; W =
# 4 (one 16-byte piece a row) and W = 12; R = 1; R = 13 with a ragged n
SUM_CASES = {
    "H-8192x128-R64": (8192, 128, 64, 8192),
    "3000x128-R64": (3000, 128, 64, 2053),
    "20000x128-R64": (20_000, 128, 64, 2053),
    "W4": (3000, 4, 64, 2053),
    "W12": (3000, 12, 64, 2053),
    "R1": (3000, 128, 1, 2053),
    "R13-ragged": (3000, 128, 13, 24_581),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SUM_CASES))
def test_gather_sum_matches_plain_on_card(case):
    """G3 sums in the plain version's order, so the two are bit-identical.
    Every eleventh index lies outside the table and adds a zero row, in
    order all the same."""
    dev = _card()
    T, W, R, n = SUM_CASES[case]
    rng = np.random.default_rng(12)
    table = torch.from_numpy(rng.standard_normal((T, W)).astype(np.float32)).to(dev)
    idx_np = rng.integers(0, T, (R, n)).astype(np.int32)
    idx_np[:, ::11] = rng.choice([-1, T, T + 5, -(2**31)], size=idx_np[:, ::11].shape)
    idx = torch.from_numpy(idx_np).to(dev)
    _same(gather.gather_sum(table, idx), gather.gather_sum_plain(table, idx))


# -- K3 (march_ts) and K5a/K5b (composite_fwd/_bwd) ---------------------------


def _grid(kind, cfg, dev, seed=0):
    """A flagship-sized occupancy grid: "ones" (fresh), "random" (20%
    occupied) or "ball" (occupied inside a ball of radius 0.8)."""
    from lsenerf_tpu_torch.ops import occupancy as occ_lib

    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (cfg.levels,) + (cfg.resolution,) * 3
    occs = torch.rand(shape, generator=gen, device=dev)
    if kind == "ones":
        return occ_lib.OccGridState(occs=occs, binaries=torch.ones(shape, dtype=torch.bool,
                                                                     device=dev))
    if kind == "random":
        return occ_lib.OccGridState(occs=occs, binaries=torch.rand(shape, generator=gen,
                                                                   device=dev) < 0.2)
    c = (torch.arange(cfg.resolution, device=dev) + 0.5) / cfg.resolution * 2 - 1
    x, y, z = torch.meshgrid(c, c, c, indexing="ij")
    r = torch.sqrt(x**2 + y**2 + z**2)[None] * (2.0 ** torch.arange(cfg.levels, device=dev))[
        :, None, None, None]
    occs = occs * (r < 0.8)
    return occ_lib.OccGridState(occs=occs, binaries=occs > min(float(occs.mean()), 0.01))


MARCH_CASES = {
    "packed_ball": dict(),
    "unpacked_ball": dict(packed_phase2=False),
    "flat_ball": dict(hierarchical=False),
    "cone0_random": dict(cone_angle=0.0),
    "packed_ones": dict(),
    "packed_random_nearfar": dict(),
    "packed_ball_deep": dict(),  # nears past t_crit: n_lin 0, the whole growth table
    # past the static layout's 64 slots and rounds: the wide layout
    "packed_ball_k96": dict(max_samples=96),
    "packed_ball_segs96": dict(max_coarse_segments=96),
    "flat_ball_cands4096": dict(hierarchical=False, max_candidates=4096),
    "packed_ball_all_wide": dict(max_samples=96, max_coarse_segments=96, max_candidates=4096,
                                 proposal_samples=80),
    # segments wider than a warp ("grid": the grid config's fields), in the
    # static layout, in dynamic shared memory and in the global workspace;
    # 3000 slots in the global workspace; "global" cases march 300 rays
    "packed_ball_cf64_r256": dict(coarse_factor=64, max_candidates=4096, grid=dict(resolution=256)),
    "packed_ball_cf48_r96_l1": dict(coarse_factor=48, max_candidates=3072,
                                    grid=dict(resolution=96, levels=1)),
    "unpacked_ball_cf33_r132_l1": dict(coarse_factor=33, max_candidates=2112,
                                       grid=dict(resolution=132, levels=1)),
    "packed_ball_cf64_r256_segs40": dict(coarse_factor=64, max_candidates=4096,
                                         max_coarse_segments=40, grid=dict(resolution=256)),
    "packed_ball_cf64_r256_k3000_global": dict(coarse_factor=64, max_candidates=4096,
                                               max_samples=3000, grid=dict(resolution=256)),
    "flat_ball_k3000_global": dict(hierarchical=False, max_samples=3000, max_candidates=4096),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MARCH_CASES))
def test_march_matches_plain_on_card(case):
    """K3 against march_ts_plain at the flagship's widths (128^3 x 4 grid,
    1024 candidates, 48 slots, F=16), also with every ray's candidates in
    the cone angle's geometric branch, past the static layout (96 slots,
    96 coarse segments, 4096 candidates, F=80), with segments wider than a
    warp (coarse_factor 33, 48, 64) and with 3000 slots in the global
    workspace: the selection before the proposal bit for bit, the
    proposal's samples equal but for bin flips at most 1e-4 of them, each
    within 1e-6 of a CDF step."""
    import dataclasses

    from lsenerf_tpu_torch.ops import march
    from lsenerf_tpu_torch.ops import occupancy as occ_lib

    dev = _card()
    kw = dict(MARCH_CASES[case])
    gcfg = occ_lib.OccGridConfig(**kw.pop("grid", {}))
    cfg = dataclasses.replace(
        march.MarchConfig(render_step_size=2 * 3**0.5 / 1000, max_candidates=1024,
                          proposal_samples=16), **kw)
    if "_cf" in case:
        assert march.use_hierarchical(gcfg, cfg) and cfg.coarse_factor > 32
    if case.endswith(("global", "segs40")):
        assert march._scalars(gcfg, cfg)["wide"] == (march.GLOBAL if "global" in case
                                                     else march.SHARED)
    state = _grid(case.split("_")[1], gcfg, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    n = 300 if case.endswith("global") else 3000
    o = torch.randn((n, 3), generator=gen, device=dev) * 1.5
    d = torch.nn.functional.normalize(-o + 0.3 * torch.randn((n, 3), generator=gen, device=dev),
                                      dim=1)
    d[:100] = -d[:100]  # away from the grid: some miss it
    nears = fars = None
    if case.endswith("nearfar"):
        nears = torch.rand((n,), generator=gen, device=dev)
        fars = nears + 2.0 * torch.rand((n,), generator=gen, device=dev)
    if case.endswith("deep"):
        t_crit = cfg.render_step_size / cfg.cone_angle
        nears = t_crit * 1.01 + torch.rand((n,), generator=gen, device=dev)
    pre = dataclasses.replace(cfg, proposal_samples=0)
    got = march.march_ts(o, d, nears, fars, state, gcfg, pre)
    want = march.march_ts_plain(o, d, nears, fars, state, gcfg, pre)
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    assert want[2].any()
    got = march.march_ts(o, d, nears, fars, state, gcfg, cfg)
    wantf = march.march_ts_plain(o, d, nears, fars, state, gcfg, cfg)
    diff = torch.zeros_like(wantf[2])
    for g, w in zip(got, wantf):
        diff |= (g.view(torch.int32) != w.view(torch.int32)) if g.dtype == torch.float32 else g != w
    if diff.any():
        _, cdf, u = march.proposal_cdf(*want, state, o, d, cfg, gcfg)
        gap = (u[None, :, None] - cdf[:, None, :]).abs().amin(-1)[diff]
        assert int(diff.sum()) <= 1e-4 * diff.numel() and float(gap.max()) < 1e-6


def _composite_inputs(n, k, dev, seed=0):
    """n rays of k samples; among the first rays (where n has them) an inf
    density, a masked-out inf, a ray culled whole at alpha_thre 0.01, an
    opaque one (early stop), an all-masked one and one whose second half
    is inf."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = 0.01 + 0.2 * torch.rand((n, k), generator=gen, device=dev)
    te = torch.cumsum(dt, 1)
    ts = te - dt
    mask = torch.rand((n, k), generator=gen, device=dev) < 0.8
    dens = -3.0 * torch.log(torch.rand((n, k, 1), generator=gen, device=dev))
    inf = float("inf")
    if n > 0:
        dens[0, min(3, k - 1), 0] = inf
    if n > 1:
        dens[1, min(2, k - 1), 0] = inf
        mask[1, min(2, k - 1)] = False
    if n > 3:
        dens[2] = 0.04
        dens[3] = 500.0
    if n > 5:
        mask[4] = False
        dens[5, k // 2:, 0] = inf
    rgb = torch.rand((n, k, 3), generator=gen, device=dev)
    bg = torch.rand((n, 3), generator=gen, device=dev)
    cot = (torch.randn((n, 3), generator=gen, device=dev),
           torch.randn((n, 1), generator=gen, device=dev),
           torch.randn((n, 1), generator=gen, device=dev))
    return dens, rgb, ts, te, mask, bg, cot


# K5a/K5b's samples a ray: each layout's edges (8, 16, 32, 48, 64 a warp's
# lanes; 128 a tile), the tiled walk past 128, and the flagship's 16 and 48
COMPOSITE_KS = [1, 2, 7, 15, 16, 17, 31, 32, 33, 47, 48, 63, 64, 65, 96, 200]


@pytest.mark.cuda
@pytest.mark.parametrize("background", ["linear", "black", "white", "last_sample", "random"])
@pytest.mark.parametrize("k", COMPOSITE_KS)
def test_composite_matches_plain_on_card(background, k):
    """K5a/K5b against composite_fwd_plain/composite_bwd_plain at 1, 3511
    and 4097 rays (the last warp and block part full), with inf densities,
    culled samples, an early stop and an all-masked ray, both alpha_thre
    forms; None cotangents as zeros; the same bits from call to call. A
    ray whose transmittance ties early_stop_eps (within an ulp or two: the
    sums' orders decide it) is held to the plain version at early_stop_eps
    nudged by composite.TIE (1e-6) either way, at the same tolerances."""
    from lsenerf_tpu_torch.ops import composite

    dev = _card()
    for n in (1, 3511, 4097):
        dens, rgb, ts, te, mask, bg, cot = _composite_inputs(n, k, dev)
        for at in (0.01, torch.tensor(0.01, device=dev), 0.0):
            a = (dens, rgb, ts, te, mask, at, 1e-4, bg if background == "random" else None,
                 background)
            got = composite.composite_fwd(*a)
            assert all(torch.isfinite(g).all() for g in got)
            off, ties = composite.rays_off_plain(got, composite.composite_fwd_plain, a)
            assert not off.any() and int(ties.sum()) <= 2, (off.nonzero(), ties.nonzero())
            again = composite.composite_fwd(*a)
            assert all(torch.equal(x, y) for x, y in zip(got, again))
            for c in (cot, (cot[0], None, cot[2])):
                got = composite.composite_bwd(*a, *c)
                assert all(torch.isfinite(g).all() for g in got)
                off, ties = composite.rays_off_plain(got, composite.composite_bwd_plain, a, c,
                                                     rtol=1e-4)
                assert not off.any() and int(ties.sum()) <= 2, (off.nonzero(), ties.nonzero())
                again = composite.composite_bwd(*a, *c)
                assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_march_composite_wrappers_refuse_what_the_kernels_do_not_take():
    from lsenerf_tpu_torch.ops import composite, march
    from lsenerf_tpu_torch.ops import occupancy as occ_lib

    dev = _card()
    gcfg = occ_lib.OccGridConfig(resolution=32, levels=2)
    cfg = march.MarchConfig(render_step_size=0.01, max_candidates=256)
    state = _grid("ones", gcfg, dev)
    o = torch.zeros((4, 3), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        march.march_ts(o.double(), o, None, None, state, gcfg, cfg)
    with pytest.raises(ValueError, match="is on cpu"):
        march.march_ts(o, o.cpu(), None, None, state, gcfg, cfg)
    dens, rgb, ts, te, mask, bg, cot = _composite_inputs(8, 16, dev)
    with pytest.raises(ValueError, match="shape"):
        composite.composite_fwd(dens[:, :8], rgb, ts, te, mask)
    with pytest.raises(ValueError, match="is on cpu"):
        composite.composite_fwd(dens, rgb.cpu(), ts, te, mask)


def _scan_trainer(dev):
    """A small trainer for the scan_steps card tests: RGB and events, SO3xR3
    deltas (the RGB ones delayed, on from step 4), a random background and
    the occupancy update every 4 steps (tests/test_torch_scan_steps.py's
    on the CPU)."""
    from lsenerf_tpu_torch.data import datamanager as tdm
    from lsenerf_tpu_torch.data import synthetic as tsyn
    from lsenerf_tpu_torch.engine import trainer as ttr
    from lsenerf_tpu_torch.models import field as tfield
    from lsenerf_tpu_torch.models import lsenerf as tmodel
    from lsenerf_tpu_torch.ops import occupancy as tocc

    col, evs = tsyn.make_synthetic_scene(n_cams=4, h=16, w=16, focal=20.0)
    dm = tdm.MultiCamDataManager(tdm.DataManagerConfig(train_num_rays_per_batch=64), col, evs,
                                 seed=3)
    mcfg = tmodel.ModelConfig(
        field=tfield.FieldConfig(hash=the.HashEncodingConfig(num_levels=4, base_res=4, max_res=32,
                                                              layout="blocked", blocked_rows_log2=8)),
        grid=tocc.OccGridConfig(resolution=16, levels=1, update_interval=4),
        max_samples=16, max_candidates=64, hierarchical_march=False)
    cfg = ttr.TrainerConfig(
        col_cam_opt=ttr.CameraOptConfig(mode="SO3xR3", scheme="delayed", delay_cnt=3),
        evs_cam_opt=ttr.CameraOptConfig(mode="SO3xR3"),
        fields_optimizer=ttr.OptimizerGroupConfig(lr=1e-2, lr_final=1e-3, max_steps=10))
    tr = ttr.Trainer(cfg, mcfg, dm, device=dev)
    tr.setup()
    return tr


@pytest.mark.cuda
def test_chunk_graph_matches_eager_steps_on_card():
    """Three chunks of 3 steps (the eager warm-up, the capture and its
    replay, a replay; the RGB gate switches on at step 4, inside the
    captured chunk) against 9 eager steps of a trainer built the same way:
    the counts and the background generator's state equal after each
    chunk, each loss within rtol 1e-3 (K2's atomics add in no fixed order,
    and Adam's eps of 1e-15 turns their noise into steps of up to lr), and
    the captured graph holds K1, K2, K3, K5a, K5b, K8a, K8b, K9a and K9b
    once a step, and neither the ngp kernels nor the generic ones of
    F != 2."""
    from lsenerf_tpu_torch.engine.chunk_graph import path_kernels
    from lsenerf_tpu_torch.engine.loop import _covered

    dev = _card()
    k = 3
    eager, chunked = _scan_trainer(dev), _scan_trainer(dev)
    stacked = eager.dm.next_train_stack(0, 3 * k)
    chunked.dm.next_train_stack(0, 3 * k)
    fn = chunked.make_train_step_multi(k)
    for c in range(3):
        part = {key: v[c * k:(c + 1) * k] for key, v in stacked.items()}
        for t in (eager, chunked):
            if _covered(c * k, 4, k):
                t.occ_update()
        want = torch.stack([eager.step({key: v[j] for key, v in part.items()}, update_occ=False)["loss"]
                            for j in range(k)])
        got = fn(part)
        torch.testing.assert_close(chunked.chunk_losses, want, rtol=1e-3, atol=0.0)
        torch.testing.assert_close(got["loss"], want[-1], rtol=1e-3, atol=0.0)
        assert (chunked.step_count, chunked.opt_count) == (eager.step_count, eager.opt_count)
        assert torch.equal(chunked._bg_gen.get_state(), eager._bg_gen.get_state())
    cg = chunked._chunks[k]
    assert cg.graph is not None
    names = [kn.name for kn in path_kernels()
             if not kn.name.startswith("ngp") and not kn.name.endswith("_f")]
    assert min(cg.launches[n] for n in names) >= k, cg.launches
    assert not any(n for name, n in cg.launches.items() if name not in names), cg.launches


@pytest.mark.cuda
def test_chunk_graph_capture_error_propagates(monkeypatch):
    """A host sync inside the chunk's steps ends the capture: the error
    raises, naming where it happened, and no step runs eagerly in its
    place."""
    dev = _card()
    tr = _scan_trainer(dev)
    fn = tr.make_train_step_multi(2)
    fn(tr.dm.next_train_stack(0, 2))  # the eager warm-up
    real = tr._draw_background

    def draw_and_sync(n):
        out = real(n)
        float(out.sum())  # reads the device from the host
        return out

    monkeypatch.setattr(tr, "_draw_background", draw_and_sync)
    with pytest.raises(RuntimeError, match="capturing 2 train steps as one CUDA graph failed at"):
        fn(tr.dm.next_train_stack(2, 2))
    assert tr.step_count == 2


def _emb_trainer(dev):
    """The lsenerf_emb preset's model and ray budget (evs_emb, no proposal:
    48 slots a ray, 3510 rays) on preset_trainer's small scene, both
    cameras fixed, so that the march's masks depend on the grid and the
    batch alone and not on Adam's rounding."""
    import dataclasses

    from lsenerf_tpu_torch import flagship
    from lsenerf_tpu_torch.data import datamanager as tdm
    from lsenerf_tpu_torch.data import synthetic as tsyn
    from lsenerf_tpu_torch.engine import trainer as ttr

    cfg, mcfg, dmc = flagship.preset_configs("lsenerf_emb")
    off = ttr.CameraOptConfig(mode="off")
    cfg = dataclasses.replace(cfg, col_cam_opt=off, evs_cam_opt=off)
    col, evs = tsyn.make_synthetic_scene(n_cams=12, h=64, w=64, focal=60.0)
    tr = ttr.Trainer(cfg, mcfg, tdm.MultiCamDataManager(dmc, col, evs, seed=3), device=dev)
    tr.setup()
    return tr


@pytest.mark.cuda
def test_replayed_live_samples_are_the_eager_twins_masks_on_card(monkeypatch):
    """Three chunks of 4 steps of lsenerf_emb's model (the eager warm-up,
    the capture and its replay, a replay) under a profiler: each chunk's
    live_samples and sample_slots (engine/spans.py), tallied in its marked
    step, are the mask sum and the slots of the same step of an eager twin
    built the same way; the three differ, so a tally frozen at the capture
    would fail."""
    from torch.profiler import ProfilerActivity, profile

    from lsenerf_tpu_torch.engine import spans
    from lsenerf_tpu_torch.models import lsenerf as tmodel

    dev = _card()
    k = 4
    eager, chunked = _emb_trainer(dev), _emb_trainer(dev)
    stacked = eager.dm.next_train_stack(0, 3 * k)
    chunked.dm.next_train_stack(0, 3 * k)
    for t in (eager, chunked):
        t.occ_update()
    masks, real = [], tmodel.march.march_rays

    def watched(*a, **kw):
        out = real(*a, **kw)
        masks.append((int(out.mask.sum()), out.mask.numel()))
        return out

    monkeypatch.setattr(tmodel.march, "march_rays", watched)
    for j in range(3 * k):
        eager.step({key: v[j] for key, v in stacked.items()}, update_occ=False)
    monkeypatch.undo()
    assert all(n == 3510 * 48 for _, n in masks)

    fn = chunked.make_train_step_multi(k)
    spans.reset()
    got = []
    for c in range(3):
        with profile(activities=[ProfilerActivity.CPU]), spans.run():
            fn({key: v[c * k:(c + 1) * k] for key, v in stacked.items()})
        run = spans.snapshot()[-1]["counters"]
        assert run["marked_steps"] == 1, run
        got.append((run["live_samples"], run["sample_slots"]))
    spans.reset()
    marked = chunked._chunks[k].marked_steps()[0]
    want = [masks[c * k + marked] for c in range(3)]
    assert got == want
    assert len({live for live, _ in want}) == 3, want


@pytest.mark.cuda
def test_a_traced_replays_read_leaves_the_card_busy_on_card(monkeypatch):
    """Under a profiler, the read of a replay's marks and tally before the
    next replay (engine/spans.py::read_pending) waits for the replay's
    marked step alone: when it returns the card still holds the replay's
    later steps, so the next replay queues behind them and the card is not
    left idle. Four chunks of 16 steps of lsenerf_emb's model (the eager
    warm-up, the capture and its replay, two replays); the run's tallies
    count the four marked steps."""
    from torch.profiler import ProfilerActivity, profile

    from lsenerf_tpu_torch.engine import spans

    dev = _card()
    k = 16
    t = _emb_trainer(dev)
    stacked = t.dm.next_train_stack(0, 4 * k)
    t.occ_update()
    fn = t.make_train_step_multi(k)
    busy, real = [], spans.read_pending

    def read(wait=False):
        replays = any(g.reused for _, g in spans._pending)
        real(wait)
        if replays and not wait:
            busy.append(not torch.cuda.current_stream(dev).query())

    monkeypatch.setattr(spans, "read_pending", read)
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]), spans.run():
            for c in range(4):
                fn({key: v[c * k:(c + 1) * k] for key, v in stacked.items()})
        run = spans.snapshot()[-1]["counters"]
    finally:
        spans.reset()
    assert busy == [True, True]
    assert run["replays"] == 3 and run["marked_steps"] == 4, run
    assert run["sample_slots"] == 4 * 3510 * 48
    assert 0 < run["live_samples"] < run["sample_slots"]


# -- Adam (lsenerf_tpu_torch/engine/trainer.py::build_optimizer) -----------------

ADAM_TABLE = (16 << 19, 2)  # the 64 MiB f32 table of both benchmark train cells
ADAM_SMALL = {"model/w0": (32, 64), "model/b0": (64,), "model/w1": (64, 64),
              "camera_opt/pose": (200, 6)}


def _adam_inputs(dev, steps):
    """Starting values of the table and the small leaves, and `steps`
    gradients of each (a quarter of the table's rows zero, as rows no
    sample touched)."""
    g = torch.Generator(device=dev).manual_seed(22)
    shapes = {"model/table": ADAM_TABLE, **ADAM_SMALL}
    init = {p: torch.randn(s, generator=g, device=dev) * 1e-2 for p, s in shapes.items()}
    grads = []
    for _ in range(steps):
        step = {p: torch.randn(s, generator=g, device=dev) for p, s in shapes.items()}
        step["model/table"][torch.rand(ADAM_TABLE[0], generator=g, device=dev) < 0.25] = 0.0
        grads.append(step)
    return init, grads


def _adam(init, foreach=False):
    """build_optimizer's Adam over copies of `init` ({path: tensor}), or the
    foreach one it replaced: (optimizer, schedules, {path: leaf})."""
    from lsenerf_tpu_torch.engine import trainer as ttr

    params = {"model": {}, "camera_opt": {}}
    for p, v in init.items():
        top, name = p.split("/")
        params[top][name] = v.clone()
    opt, schedules, _ = ttr.build_optimizer(ttr.TrainerConfig(), params)
    return _foreach_adam(opt) if foreach else opt, schedules, dict(ttr.tree_leaves(params))


def _adam_steps(opt, schedules, leaves, grads):
    from lsenerf_tpu_torch.engine import trainer as ttr

    for j, step in enumerate(grads):
        for p, t in leaves.items():
            t.grad = step[p]
        ttr.set_lrs(opt, schedules, j)
        opt.step()


@pytest.mark.cuda
def test_fused_adam_replayed_is_its_eager_steps_on_card():
    """16 steps of build_optimizer's Adam (fused, capturable, each group's lr
    a device tensor) on the 64 MiB table and small leaves, captured in one
    CUDA graph (each step's gradients and lrs copied in, as ChunkGraph
    does) and replayed, equal 16 eager steps bit for bit: parameters,
    moments and counts. The capture follows one eager step that builds the
    moments, after which the state goes back to its start in place, as the
    benchmark's restart does."""
    from lsenerf_tpu_torch.engine import trainer as ttr

    dev = _card()
    k = 16
    init, grads = _adam_inputs(dev, k)
    opt, schedules, eager = _adam(init)
    group = opt.param_groups[0]
    assert group["fused"] and group["capturable"] and group["lr"].is_cuda
    _adam_steps(opt, schedules, eager, grads)

    gopt, _, leaves = _adam(init)
    static = {p: torch.zeros_like(t) for p, t in leaves.items()}
    for p, t in leaves.items():
        t.grad = static[p]
    lrs = torch.tensor([[s(j) for s in schedules] for j in range(k)], dtype=torch.float32,
                       device=dev)
    gopt.step()
    with torch.no_grad():
        for p, t in leaves.items():
            t.copy_(init[p])
        for st in gopt.state.values():
            for v in st.values():
                v.zero_()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for j in range(k):
            for p in static:
                static[p].copy_(grads[j][p])
            for gi, grp in enumerate(gopt.param_groups):
                grp["lr"].copy_(lrs[j, gi])
            gopt.step()
    graph.replay()
    torch.cuda.synchronize()
    for p, t in eager.items():
        assert torch.equal(leaves[p], t), p
        for key, v in opt.state[t].items():
            assert torch.equal(gopt.state[leaves[p]][key], v), (p, key)
    assert float(gopt.state[leaves["model/table"]]["step"]) == k


@pytest.mark.cuda
def test_fused_adam_is_foreach_adam_to_rounding_on_card():
    """16 eager steps of the fused capturable Adam and of the foreach
    capturable one it replaced, on the same gradients: per leaf, the gap
    between the two parameters over the foreach change, both by norm,
    stays at f32 rounding (the largest is printed). The gap is mostly the
    foreach path's bias correction: it takes 1 - 0.999^t in f32, where
    0.999 is 1.3e-5 of 1 - 0.999 off (6.4e-6 after the square root); the
    fused kernel takes it in double, as the benchmark's reference does."""
    dev = _card()
    init, grads = _adam_inputs(dev, 16)
    gaps = {}
    fused, schedules, a = _adam(init)
    _adam_steps(fused, schedules, a, grads)
    foreach, schedules, b = _adam(init, foreach=True)
    _adam_steps(foreach, schedules, b, grads)
    for p in a:
        gaps[p] = float((a[p] - b[p]).norm() / (b[p] - init[p]).norm())
    worst = max(gaps, key=gaps.get)
    print(f"fused against foreach capturable Adam after 16 steps: largest gap {gaps[worst]:.3e} "
          f"({worst})")
    assert gaps[worst] < 1e-5, gaps


@pytest.mark.cuda
def test_a_foreach_checkpoint_loads_into_the_fused_adam_on_card(tmp_path):
    """A checkpoint of a trainer whose Adam was the foreach capturable one
    (its counts on the card, saved to the CPU) loads into a fresh trainer:
    every count beside its leaf on the card in f32, and the next two steps'
    losses within rtol 1e-3 of the foreach run's (K2's atomics add in no
    fixed order; test_chunk_graph_matches_eager_steps_on_card's rule)."""
    from lsenerf_tpu_torch.engine import checkpoints as ckpt
    from lsenerf_tpu_torch.engine import trainer as ttr

    dev = _card()
    old = _scan_trainer(dev)
    old.optimizer = _foreach_adam(old.optimizer)
    batches = [old.dm.next_train(i) for i in range(6)]
    for b in batches[:4]:
        old.step(b)
    d = str(tmp_path / "ckpts")
    ckpt.save_checkpoint(d, 3, old)
    step, params, occ, opt, rng = ckpt.load_checkpoint_full(d)
    new = _scan_trainer(dev)
    assert ckpt.restore_into_state(new, params, occ, step, opt=opt, rng=rng)
    assert all(g["fused"] for g in new.optimizer.param_groups)
    for _, t in ttr.tree_leaves(new.params):
        st = new.optimizer.state.get(t)
        if st is not None:
            assert st["step"].is_cuda and st["step"].dtype == torch.float32
            assert float(st["step"]) == 4.0
    for b in batches[4:]:
        want, got = old.step(b)["loss"], new.step(b)["loss"]
        torch.testing.assert_close(got, want, rtol=1e-3, atol=0.0)
    assert new.opt_count == old.opt_count == 6


# -- K8a/K8b: the camera rays of a step -------------------------------------------


def _bundles_card_vs_cpu(tr, dev, gates=(1.0, 1.0), edit=None, tensor_gates=False):
    """One step's rays and camera-leaf gradients by K8a/K8b on the card and
    by the plain version on the CPU, from the same inputs (`edit` changes
    them first); returns (card bundle, card grads, cpu bundle, cpu grads,
    the card's K8a and K8b launches)."""
    import torch_bundle_cases as cases
    from lsenerf_tpu_torch.ops import bundles

    inputs = cases.step_inputs(tr)
    if edit is not None:
        edit(inputs)
    out = []
    launches = (bundles.K8A.launches, bundles.K8B.launches)
    for where in (dev, torch.device("cpu")):
        parts, cp, batch, spline, rgb_ts, ne = cases.on_device(inputs, where)
        g = tuple(torch.tensor(x, device=where) for x in gates) if tensor_gates else gates
        big, sizes = bundles.step_rays(parts, cp, batch, g, spline, rgb_ts, ne)
        assert sum(sizes) == len(big)
        loss = cases.loss_of(big, cases.cotangents(len(big)))
        if loss.requires_grad:
            loss.backward()
        out += [big, cases.leaf_grads(cp)]
        if where == dev:
            launches = (bundles.K8A.launches - launches[0], bundles.K8B.launches - launches[1])
    return (*out, launches)


def _same_rays(got, want):
    torch.testing.assert_close(got.origins.cpu(), want.origins, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.directions.cpu(), want.directions, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.pixel_area.cpu(), want.pixel_area, rtol=2e-4, atol=1e-9)
    for name in ("camera_indices", "times"):
        torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name), rtol=0, atol=0)
    torch.testing.assert_close(got.metadata["appearance_id"].cpu(),
                               want.metadata["appearance_id"], rtol=0, atol=0)


def _same_grads(got, want):
    assert got.keys() == want.keys()
    for path, w in want.items():
        if w is None:
            assert got[path] is None, path
            continue
        # the f32 sums into a knot or a camera add in another order
        torch.testing.assert_close(got[path], w, rtol=1e-4,
                                   atol=2e-5 * max(float(w.abs().max()), 1e-6), msg=path)


def parts_rep(tr) -> int:
    return tr._parts()[0].rep


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["lsenerf", "lsenerf_emb", "badnerf_ngp_f32"])
def test_bundles_match_plain_at_the_cells_on_card(preset):
    """K8a/K8b at the train cells' presets and batch shapes (RGB spline +
    deblur x4; the event presets' two SO3xR3 bundles), with the first and
    last frames' exposures reaching past the knots, the gates as device
    values: the rays and every camera leaf's gradient within f32 rounding
    of the plain version on the CPU; one launch each."""
    import torch_bundle_cases as cases
    from lsenerf_tpu_torch.flagship import preset_trainer

    dev = _card()
    field = dict(hash_layout="ngp", compute_dtype="float32") if preset.startswith("badnerf") else {}
    tr = preset_trainer(preset.split("_ngp")[0], device=dev, **field)
    cases.move_leaves(tr.params["camera_opt"], 1)
    n = len(tr.col_cams)

    def ends(inputs):
        rows = inputs[2]["col_indices"]
        rows[:8, 0], rows[8:16, 0] = 0, n - 1

    got, g_got, want, g_want, launches = _bundles_card_vs_cpu(tr, dev, edit=ends,
                                                              tensor_gates=True)
    _same_rays(got, want)
    _same_grads(g_got, g_want)
    assert launches == (1, 1)
    # the first 16 pixels' rays (4 a pixel) are on the first and last frames
    ts = tr.col_spline_static.ctrl_ts
    q = got.times[:16 * parts_rep(tr)].cpu()[:, 0]
    assert float(q.min()) == float(ts[0]) and float(q.max()) == float(ts[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [1.0, 0.0])
@pytest.mark.parametrize("case", ["spline", "spline_deblur", "event_spline", "so3xr3", "se3",
                                  "prevnext", "none"])
def test_bundles_match_plain_for_each_pose_source_on_card(case, gate):
    import torch_bundle_cases as cases

    dev = _card()
    tr = cases.case_trainer(case, device=dev, n_cams=12, size=64, rays=1024)
    got, g_got, want, g_want, launches = _bundles_card_vs_cpu(tr, dev, gates=(gate, gate))
    _same_rays(got, want)
    _same_grads(g_got, g_want)
    assert launches == (1, 0 if case == "none" else 1)
    if gate == 0.0:
        assert not any(g is not None and g.any() for g in g_got.values())


@pytest.mark.cuda
def test_bundles_lerp_branch_zero_rotations_and_one_knot_on_card():
    """200 frames (neighbouring knots a degree apart: the slerp's lerp
    branch), knots and delta rows with no rotation at all, and every ray of
    the batch on one camera (so on one knot and one delta row: K8b's sums
    of 2,316 + 1,194 rays into one row)."""
    import torch_bundle_cases as cases
    from lsenerf_tpu_torch.ops import lie

    dev = _card()
    tr = cases.case_trainer("prevnext", device=dev, n_cams=200, size=64, rays=3510)
    cp = tr.params["camera_opt"]
    ct = cp["col"]["ctrl_tangents"]
    with torch.no_grad():
        # knots near the trajectory, a fraction of the knots' spacing off it
        noise = torch.randn(ct.shape, generator=torch.Generator().manual_seed(2)) * 3e-3
        ct.copy_(tr.col_spline_params["ctrl_tangents"] + noise.to(dev))
        ct[3:8, 3:] = 0.0
        cp["evs"]["prev"]["pose_adjustment"][:, 3:] = 0.0
    q = lie.exp_map_to_quat(cp["col"]["ctrl_tangents"][:, 3:].detach().cpu())
    q = q / q.norm(dim=1, keepdim=True)
    assert float(((q[1:] * q[:-1]).sum(1).abs() > 0.9995).float().mean()) > 0.9
    for cam in (None, 5):
        def one(inputs, cam=cam):
            if cam is not None:
                inputs[2]["col_indices"][:, 0] = cam
                inputs[2]["evs_indices"][:, 0] = cam

        got, g_got, want, g_want, _ = _bundles_card_vs_cpu(tr, dev, edit=one)
        _same_rays(got, want)
        _same_grads(g_got, g_want)
        for path in ("col/ctrl_tangents", "evs/prev/pose_adjustment"):
            assert g_got[path].abs().sum() > 0, path


@pytest.mark.cuda
def test_bundles_graph_replay_matches_eager_on_card():
    """A step's rays and backward captured as a CUDA graph (its gates
    device values): a replay with the gates at 1 gives the eager call's
    rays and gradients bit for bit (K8b sums in a fixed order, no
    atomics); at 0 the same rays and zero gradients."""
    import torch_bundle_cases as cases
    from lsenerf_tpu_torch.engine.trainer import tree_leaves
    from lsenerf_tpu_torch.ops import bundles

    dev = _card()
    tr = cases.case_trainer("event_spline", device=dev, n_cams=12, size=64, rays=1024)
    parts, cp, batch, spline, rgb_ts, ne = cases.on_device(cases.step_inputs(tr), dev)
    leaves = [t for _, t in tree_leaves(cp)]
    gates = torch.ones(2, device=dev)
    n = sum(batch[p.rows].shape[0] * p.rep for p in parts)
    cots = [c.to(dev) for c in cases.cotangents(n)]

    def body():
        for t in leaves:
            t.grad = None
        big, _ = bundles.step_rays(parts, cp, batch, (gates[0], gates[1]), spline, rgb_ts, ne)
        cases.loss_of(big, cots).backward()
        return big

    eager = body()
    want = {p: t.grad.clone() for p, t in tree_leaves(cp)}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = body()
    gates.fill_(0.0)
    graph.replay()
    torch.testing.assert_close(static.origins, eager.origins, rtol=0, atol=0)
    assert not any(t.grad.any() for t in leaves)
    gates.fill_(1.0)
    graph.replay()
    for name in ("origins", "directions", "pixel_area", "camera_indices", "times"):
        torch.testing.assert_close(getattr(static, name), getattr(eager, name), rtol=0, atol=0)
    for p, t in tree_leaves(cp):
        torch.testing.assert_close(t.grad, want[p], rtol=0, atol=0, msg=p)


@pytest.mark.cuda
def test_render_rays_forward_only_on_card():
    """generate_rays on the card (eval batches, render_image, render.py,
    the viewer) is K8a at fixed poses with no backward: the cameras' own
    poses, one override pose expanded over the rays, a pose a ray, and
    OpenCV distortion, each within f32 rounding of the plain version on
    the CPU; a pose that needs a gradient is refused."""
    import dataclasses

    import torch_bundle_cases as cases
    from lsenerf_tpu_torch.cameras import cameras as tcams
    from lsenerf_tpu_torch.ops import bundles

    dev = _card()
    tr = cases.case_trainer("none", device=dev, n_cams=12, size=64)
    cams = tr.col_cams
    g = torch.Generator().manual_seed(0)
    n = 4096
    idx = torch.randint(0, len(cams), (n,), generator=g)
    coords = torch.rand((n, 2), generator=g) * 64
    pose = cams.camera_to_worlds[3:4].cpu() + 0.01
    dist = torch.tensor([0.05, -0.01, 0.002, 0.0, 0.001, -0.002])
    cases_ = [(cams, None), (cams, pose.expand(n, 3, 4)),
              (cams, cams.camera_to_worlds.cpu()[idx] * 1.01),
              (dataclasses.replace(cams, distortion_params=dist.to(dev)), None)]
    for c, c2w in cases_:
        before = (bundles.K8A.launches, bundles.K8B.launches)
        got = tcams.generate_rays(c, idx.to(dev), coords.to(dev),
                                  None if c2w is None else c2w.to(dev))
        assert (bundles.K8A.launches - before[0], bundles.K8B.launches - before[1]) == (1, 0)
        want = tcams.generate_rays(c.to("cpu"), idx, coords, c2w)
        for name in ("origins", "directions"):
            torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name), rtol=1e-5,
                                       atol=1e-6, msg=name)
        torch.testing.assert_close(got.pixel_area.cpu(), want.pixel_area, rtol=2e-4, atol=1e-9)
        for name in ("camera_indices", "times"):
            torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name), rtol=0,
                                       atol=0)
    with pytest.raises(ValueError, match="gradient"):
        tcams.generate_rays(cams, idx.to(dev), coords.to(dev),
                            pose.to(dev).requires_grad_(True).expand(n, 3, 4))


# -- K9a/K9b, the field's MLP head -----------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["lsenerf step", "lsenerf_emb step", "badnerf_ngp_f32 step",
                                   "occupancy chunk", "other widths", "dynamic range"])
def test_head_matches_plain_at_the_cells_on_card(shape):
    """K9a (and K9b where the shape trains) against the plain version on the
    card at flagship.head_shapes, the three train cells' shapes, the
    occupancy chunk, widths that take the kernels compiled for no
    preset (64 features, 16-wide codes) and badnerf's f32 step with weights
    and features spread over six decades: each output within
    field_head.TOLERANCE of the plain version's, relative to its norm (set
    from the readings in PERF.md: the f32 sums' order, and in bf16 a colour
    input or cotangent an ulp apart rounding to the neighbouring bf16 at a
    few samples); K9a launched once without a gradient and once more,
    saving its activations for K9b, with one."""
    from lsenerf_tpu_torch.flagship import head_shapes
    from lsenerf_tpu_torch.models import field as tfield
    from lsenerf_tpu_torch.ops import field_head as fh

    a = head_shapes(_card(), names=[shape])[shape]
    before = (fh.K9A.launches, fh.K9B.launches)
    got = fh.run(*a[:8])
    assert fh.off_plain(got, fh.run(*a[:8], plain=tfield.head_plain), a[7], False) == {}
    if a[4] is not None:
        grads = fh.run(*a)
        assert fh.off_plain(grads, fh.run(*a, plain=tfield.head_plain), a[7], True) == {}
        assert all(g is not None for g in grads)
    trains = int(a[4] is not None)
    assert (fh.K9A.launches - before[0], fh.K9B.launches - before[1]) == (1 + trains, trains)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["lsenerf step", "lsenerf_emb step", "badnerf_ngp_f32 step",
                                   "other widths", "dynamic range"])
def test_head_is_the_same_bits_twice_on_card(shape):
    """No atomics: two calls of K9a and of K9b give every output's bits."""
    from lsenerf_tpu_torch.flagship import head_shapes
    from lsenerf_tpu_torch.ops import field_head as fh

    a = head_shapes(_card(), names=[shape])[shape]
    for args in (a[:8], a):
        one, two = fh.run(*args), fh.run(*args)
        for x, y in zip(one, two):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["lsenerf step", "lsenerf_emb step", "badnerf_ngp_f32 step",
                                   "dynamic range"])
def test_head_tolerance_refuses_tf32_products_on_card(shape):
    """The control of field_head.TOLERANCE: the plain version with TF32
    products (the lower precision the kernels must not use) is off the
    limits, forward and backward, at each train cell's shape and where the
    operands span six decades."""
    from lsenerf_tpu_torch.flagship import head_shapes
    from lsenerf_tpu_torch.models import field as tfield
    from lsenerf_tpu_torch.ops import field_head as fh

    a = head_shapes(_card(), names=[shape])[shape]
    for backward, args in ((False, a[:8]), (True, a)):
        want = fh.run(*args, plain=tfield.head_plain)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            control = fh.run(*args, plain=tfield.head_plain)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        assert fh.off_plain(control, want, a[7], backward) != {}, (shape, backward)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["badnerf_ngp_f32 step", "dynamic range"])
def test_head_split_is_what_holds_the_tolerance_on_card(shape):
    """What keeps the kernels' tensor-core products at f32 accuracy is the
    split (field_head.KEPT): the plain version with each product taken once
    in bf16 (autocast), the product a kernel would take unsplit, is off
    field_head.TOLERANCE forward and backward in f32, at badnerf's step and
    where weights and features span six decades, while K9a/K9b stay within
    it there."""
    from lsenerf_tpu_torch.flagship import head_shapes
    from lsenerf_tpu_torch.models import field as tfield
    from lsenerf_tpu_torch.ops import field_head as fh

    a = head_shapes(_card(), names=[shape])[shape]
    for backward, args in ((False, a[:8]), (True, a)):
        want = fh.run(*args, plain=tfield.head_plain)
        assert fh.off_plain(fh.run(*args), want, a[7], backward) == {}, (shape, backward)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            control = fh.run(*args, plain=tfield.head_plain)
        assert fh.off_plain(control, want, a[7], backward) != {}, (shape, backward)


@pytest.mark.cuda
def test_head_chunk_graph_holds_a_launch_a_step_on_card():
    """A 16-step chunk graph holds 16 launches of K9a and 16 of K9b."""
    dev = _card()
    tr = _scan_trainer(dev)
    fn = tr.make_train_step_multi(16)
    for c in range(2):  # the eager warm-up, then the capture and its replay
        fn(tr.dm.next_train_stack(16 * c, 16))
    launches = tr._chunks[16].launches
    assert (launches["head_fwd"], launches["head_bwd"]) == (16, 16), launches


@pytest.mark.cuda
def test_head_dispatch_on_card():
    """A frozen field's step launches K9b for the cotangents alone (no
    weight gradient); what the kernels do not take -- another hidden
    width, more than 64 features or code widths, density alone with a
    gradient -- raises ValueError naming it, and launches nothing."""
    from lsenerf_tpu_torch.flagship import head_shapes
    from lsenerf_tpu_torch.models import field as tfield
    from lsenerf_tpu_torch.models import mlp
    from lsenerf_tpu_torch.ops import field_head as fh

    base, color, feats, sel, dirs, codes, aid, bf16, g_d, g_rgb = head_shapes(
        _card(), names=["lsenerf step"])["lsenerf step"]
    f = feats.clone().requires_grad_(True)
    before = fh.K9B.launches
    density, rgb = tfield.head(base, color, f, sel, dirs, codes, aid, bf16)
    torch.autograd.backward((density, rgb), (g_d, g_rgb))
    assert fh.K9B.launches == before + 1 and f.grad is not None
    assert all(t.grad is None for t in base.values())
    want = fh.run(base, color, feats, sel, dirs, codes, aid, bf16, g_d, g_rgb,
                  plain=tfield.head_plain)[0]
    assert fh.errors([f.grad], [want], ["features"])["features"] <= fh.TOLERANCE[bf16][1]
    gen = torch.Generator(device=feats.device).manual_seed(0)
    n = feats.shape[0]
    wide = torch.zeros((n, 66), device=feats.device)
    refused = {
        "32-wide hidden base MLP": (mlp.init_mlp(gen, 32, 2, 32, 16, feats.device), None, feats,
                                    None, None),
        "66 features": (mlp.init_mlp(gen, 66, 2, 64, 16, feats.device), None, wide, None, None),
        "128-wide codes": (base, mlp.init_mlp(gen, 31 + 128, 3, 64, 3, feats.device), feats,
                           dirs, torch.zeros((n // 16, 128), device=feats.device)),
        "gradient": (base, None, f, None, None),
    }
    before = (fh.K9A.launches, fh.K9B.launches)
    for what, (b, c, x, d, cd) in refused.items():
        with pytest.raises(ValueError, match="do not take") as e:
            tfield.head(b, c, x, sel, d, cd, aid, bf16)
        assert what.split()[-1] in str(e.value), (what, str(e.value))
    assert (fh.K9A.launches, fh.K9B.launches) == before
