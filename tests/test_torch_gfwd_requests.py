"""encode_requests.fwd_requests, the model of K1g's and K7ag's table loads a
launch (L1 wavefronts and L2 sector requests, lsenerf_tpu_torch/
encode_requests.py), against a brute-force loop that walks each design's
warps, load instructions and lanes as the kernels in csrc/blocked_encode.cu
and csrc/ngp_encode.cu do, on a few hundred samples at two levels, for
F = 1, 4, 6 and 12 with an f32 and a bf16 table (K7ag takes its pair
loads at F = 1 and at bf16 F = 4); the forwards' launch choices (vector width, pair
load, staging) as their C sources make them; and encode_requests.k1g_sums,
K1g's order of operations, against the plain version."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lsenerf_tpu_torch import encode_requests
from lsenerf_tpu_torch.ops import combine, ngp
from lsenerf_tpu_torch.ops import hash_encoding as the

CSRC = Path(encode_requests.__file__).parent / "csrc"


def _inputs(layout, F, dtype, n=300):
    cfg = the.HashEncodingConfig(num_levels=2, base_res=4, max_res=16, layout=layout,
                                 blocked_rows_log2=10, log2_hashmap_size=10,
                                 features_per_level=F)
    rng = np.random.default_rng(F)
    pos = rng.random((n, 3)).astype(np.float32)
    pos[::7] = np.round(pos[::7] * 8) / 8  # on faces of both levels' cells
    table = torch.from_numpy(rng.standard_normal(cfg.table_shape).astype(np.float32)).to(dtype)
    return torch.from_numpy(pos), table, the.levels_for(cfg, "cpu")


def _count(instructions, elt, base):
    """(wavefronts, sectors) of instructions, each a list of the element
    indices its lanes load first."""
    w = s = 0
    for lanes in instructions:
        addr = [e * elt + base for e in lanes]
        w += len({a >> 7 for a in addr})
        s += len({a >> 5 for a in addr})
    return w, s


def _brute_blocked(pos, table, lv):
    n, L, F, W = pos.shape[0], lv.num, lv.F, lv.row_width
    elt, base = table.element_size(), table.data_ptr() % 128
    V = encode_requests.fwd_vec_width("blocked", F, table, W)
    keys, o, _ = combine.keys_fracs(pos, lv)
    keys, o = keys.tolist(), [x.tolist() for x in o]

    def vertex(l, i, a, b, z):
        return ((o[0][l][i] + a) * 3 + o[1][l][i] + b) * 3 + o[2][l][i] + z

    # the first design: thread t on sample t / L, level t % L; one
    # instruction a (feature, corner)
    old = []
    for t0 in range(0, n * L, 32):
        threads = range(t0, min(t0 + 32, n * L))
        for f in range(F):
            for c in range(8):
                old.append([keys[t % L][t // L] * W + vertex(t % L, t // L, c >> 2, (c >> 1) & 1,
                                                             c & 1) * F + f for t in threads])
    # this design: block b's warp at level l, step s, lane 4 j + q on sample
    # 32 b + 8 s + j's pair q = 2a + b
    new = []
    for blk in range(0, n, 32):
        for l in range(L):
            for f in range(0, F, V):
                for s in range(4):
                    first, second = [], []
                    for lane in range(32):
                        i = blk + 8 * s + (lane >> 2)
                        if i >= n:
                            continue
                        a, b = (lane & 3) >> 1, lane & 1
                        r = keys[l][i] * W + vertex(l, i, a, b, 0) * F
                        first.append(r + f)
                        second.append(r + F + f)
                    new += [x for x in (first, second) if x]
    return _count(old, elt, base), _count(new, elt, base)


def _brute_ngp(pos, table, lv):
    n, L, F = pos.shape[0], lv.num, table.shape[1]
    elt, base = table.element_size(), table.data_ptr() % 128
    V = encode_requests.fwd_vec_width("ngp", F, table)
    pair = encode_requests.fwd_pair(F, table)
    keys = ngp.corners(pos, lv)[0].tolist()  # (8, L, n)
    bx = torch.floor(pos[None, :, 0] * lv.scale[:, None]).long().tolist()  # (L, n)
    old = []
    for t0 in range(0, n * L, 32):
        threads = range(t0, min(t0 + 32, n * L))
        for c in range(8):
            for f in range(F):
                old.append([keys[c][t % L][t // L] * F + f for t in threads])
    # this design: a warp on one level of 32 consecutive samples (blocks of
    # 64 samples x 4 levels)
    new = []
    for i0 in range(0, n, 32):
        lanes = range(i0, min(i0 + 32, n))
        for l in range(L):
            if pair:
                for yz in range(4):
                    new.append([(keys[yz][l][i] & ~1) * F for i in lanes])
                    odd = [keys[4 + yz][l][i] * F for i in lanes if bx[l][i] % 2]
                    if odd:
                        new.append(odd)
                continue
            for f in range(0, F, V):
                for c in range(8):
                    new.append([keys[c][l][i] * F + f for i in lanes])
    return _count(old, elt, base), _count(new, elt, base)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 4, 6, 12])
@pytest.mark.parametrize("layout", ["blocked", "ngp"])
def test_fwd_request_model_matches_a_brute_force_loop(layout, F, dtype):
    pos, table, lv = _inputs(layout, F, dtype)
    got = encode_requests.fwd_requests(layout, pos, table, lv)
    want = (_brute_blocked if layout == "blocked" else _brute_ngp)(pos, table, lv)
    assert got == want
    (w0, s0), (w1, s1) = got
    # the first design's scalar loads: at least one wavefront and one
    # sector an instruction; the new layouts load fewer of both
    assert 0 < w1 < w0 and 0 < s1 < s0 and w1 <= s1 and w0 <= s0


def test_fwd_choices_follow_the_tables_alignment():
    """V and K7ag's pair load drop where a view of the table starts off
    their width, as the C entries' choices do; the pair load needs F == V
    and 2F values in 16 bytes."""
    f32 = torch.zeros(4 * 64 + 4)
    bf = torch.zeros(8 * 64 + 8, dtype=torch.bfloat16)
    for layout, W in (("ngp", None), ("blocked", 128)):
        assert encode_requests.fwd_vec_width(layout, 4, f32[:256].view(64, 4), W) == 4
        assert encode_requests.fwd_vec_width(layout, 4, f32[2:258].view(64, 4), W) == 2
        assert encode_requests.fwd_vec_width(layout, 4, f32[1:257].view(64, 4), W) == 1
        assert encode_requests.fwd_vec_width(layout, 4, bf[4:260].view(64, 4), W) == 4
        assert encode_requests.fwd_vec_width(layout, 4, bf[2:258].view(64, 4), W) == 2
    # a row width that is not a multiple of V
    assert encode_requests.fwd_vec_width("blocked", 4, f32[:256].view(64, 4), 110) == 2
    assert not encode_requests.fwd_pair(4, f32[:256].view(64, 4))  # 32 bytes
    assert encode_requests.fwd_pair(4, bf[:256].view(64, 4))  # 16 bytes
    assert not encode_requests.fwd_pair(4, bf[4:260].view(64, 4))  # 8 bytes off
    assert not encode_requests.fwd_pair(4, bf[2:258].view(64, 4))  # V = 2
    assert encode_requests.fwd_pair(1, f32[:256].view(-1, 1))
    assert encode_requests.fwd_pair(1, f32[2:258].view(-1, 1))  # 8 bytes, aligned
    assert not encode_requests.fwd_pair(1, f32[1:257].view(-1, 1))
    assert not encode_requests.fwd_pair(3, bf[:192].view(64, 3))


def test_fwd_staging_limit():
    """Where a block's output stops fitting in shared memory: K7ag at 2
    levels a block past F = 94 (at 1 level past 189), K1g past L F = 381."""
    staged = encode_requests.fwd_staged
    assert staged("ngp", 5, 94) and not staged("ngp", 5, 95)
    assert staged("ngp", 1, 189) and not staged("ngp", 1, 190)
    assert staged("blocked", 5, 76) and not staged("blocked", 5, 77)
    assert staged("blocked", 8, 16)


def test_fwd_model_follows_the_kernels_source():
    """The constants and choices the model copies from the forwards' C
    sources: K7ag's block shape, the staging limit, and each entry's
    choice of V, of K7ag's pair load and of staging. A change to any
    in the source must reach the model too."""
    ngp_src = (CSRC / "ngp_encode.cu").read_text()
    blocked = (CSRC / "blocked_encode.cu").read_text()

    def const(src, name):
        m = re.search(rf"constexpr (?:int|size_t) {name} = ([0-9 *]+);", src)
        assert m, name
        return eval(m.group(1))  # noqa: S307 (a literal product)

    assert const(ngp_src, "kGenFwdSamples") == encode_requests.K7AG_SAMPLES
    assert const(ngp_src, "kGenFwdGroup") == encode_requests.K7AG_GROUP
    assert (const(ngp_src, "kGenFwdStage") == const(blocked, "kGenFwdStage")
            == encode_requests.FWD_STAGE)
    entry = ngp_src.split("int ngp_encode_fwd_f(")[1].split("\n}\n")[0]
    assert re.search(r"int V = 4;\s*while \(V > 1 && \(F % V \|\| at % \(V \* elt\) \|\| "
                     r"ao % \(V \* 4\)\)\) V /= 2;", entry)
    assert "const bool pair = F == V && 2 * F * elt <= 16 && at % (2 * F * elt) == 0;" in entry
    assert re.search(r"staged_bytes = \(size_t\)kGenFwdSamples \* \(3 \+ group \* F\)", entry)
    entry = blocked.split("int blocked_encode_fwd_f(")[1].split("\n}\n")[0]
    assert re.search(r"int V = 4;\s*while \(V > 1 && \(F % V \|\| W % V \|\| at % \(V \* elt\)\)\) "
                     r"V /= 2;", entry)
    assert "pair" not in entry
    assert "staged_bytes = (96 + (size_t)32 * L * F) * sizeof(float);" in entry


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 3, 4, 8])
def test_k1g_sums_hold_the_plain_version(F, dtype):
    """K1g's own order of operations (8 weighted vertices as 4 lanes'
    z-pair terms, then the shuffles' pairwise sums) against the plain
    version's 27-term sum, within K1g's check on the card (rtol 1e-5, atol
    1e-6), at every level kind (dense and hashed) and on cell faces."""
    pos, table, lv = _inputs("blocked", F, dtype, n=257)
    cfg = the.HashEncodingConfig(num_levels=5, base_res=4, max_res=64, layout="blocked",
                                 blocked_rows_log2=10, features_per_level=F)
    lv = the.levels_for(cfg, "cpu")
    table = torch.from_numpy(np.random.default_rng(F).standard_normal(cfg.table_shape)
                             .astype(np.float32)).to(dtype)
    got = encode_requests.k1g_sums(pos, table, lv)
    want = combine.encode_fwd_plain(pos, table, lv)
    assert got.shape == want.shape == (257, 5 * F)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # a different order than the plain version's somewhere: not its bits
    if F > 1:
        assert not torch.equal(got, want)
