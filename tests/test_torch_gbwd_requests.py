"""encode_requests.requests, the model of K2g's and K7bg's L2 atomic requests
a launch (lsenerf_tpu_torch/encode_requests.py), against a brute-force loop
that walks each design's warps, instructions and lanes as the kernels in
csrc/blocked_encode.cu and csrc/ngp_encode.cu do, on a few hundred samples
at two levels, for F = 1, 4, 6 and 12 (two of K2g's feature chunks). Some
samples lie on cell faces (corners of weight 0) and some cotangents are 0,
so that skipped updates count."""

import re

import numpy as np
import pytest
import torch

from lsenerf_tpu_torch import encode_requests
from lsenerf_tpu_torch.ops import combine, ngp
from lsenerf_tpu_torch.ops import hash_encoding as the


def _inputs(layout, F, n=300):
    cfg = the.HashEncodingConfig(num_levels=2, base_res=4, max_res=16, layout=layout,
                                 blocked_rows_log2=10, log2_hashmap_size=10,
                                 features_per_level=F)
    rng = np.random.default_rng(F)
    pos = rng.random((n, 3)).astype(np.float32)
    pos[::7] = np.round(pos[::7] * 8) / 8  # on faces of both levels' cells
    g = rng.standard_normal((n, cfg.out_dim)).astype(np.float32)
    g[rng.random(g.shape) < 0.2] = 0.0
    table = torch.zeros(cfg.table_shape)
    return torch.from_numpy(pos), table, torch.from_numpy(g), the.levels_for(cfg, "cpu")


def _brute_blocked(pos, gfeat, lv):
    n, L, F, W = pos.shape[0], lv.num, lv.F, lv.row_width
    keys, o, w = combine.keys_fracs(pos, lv)
    keys, o, w = keys.tolist(), [x.tolist() for x in o], [x.numpy() for x in w]
    g = gfeat.reshape(n, L, F).numpy()
    one = np.float32(1.0)

    def upd(l, i, c, f):  # in f32, in the kernels' order
        a, b, z = c >> 2, (c >> 1) & 1, c & 1
        u = [(one - w[d][l, i], w[d][l, i]) for d in range(3)]
        return (u[0][a] * u[1][b]) * u[2][z] * g[i, l, f]

    def addr(l, i, c, f):
        a, b, z = c >> 2, (c >> 1) & 1, c & 1
        v = ((o[0][l][i] + a) * 3 + o[1][l][i] + b) * 3 + o[2][l][i] + z
        return keys[l][i] * W + v * F + f

    old = new = 0
    for i0 in range(0, n, 32):
        live = min(32, n - i0)
        for l in range(L):
            # the first design: each lane its sample, one instruction a (corner, feature)
            for c in range(8):
                for f in range(F):
                    old += len({addr(l, i0 + k, c, f) >> 3 for k in range(live)
                                if upd(l, i0 + k, c, f) != 0})
            # this design: the warp's entries of 8 fc values a chunk of the
            # features, lane by lane as the kernel steps through them
            for f0 in range(0, F, encode_requests.K2G_CHUNK):
                fc = min(encode_requests.K2G_CHUNK, F - f0)
                E, sectors = 8 * fc, {}
                for lane in range(32):
                    k, j, it = lane // E, lane % E, 0
                    while k < live:
                        c, f = j // fc, f0 + j % fc
                        if upd(l, i0 + k, c, f) != 0:
                            sectors.setdefault(it, set()).add(addr(l, i0 + k, c, f) >> 3)
                        k, j, it = k + 32 // E, j + 32 % E, it + 1
                        if j >= E:
                            j, k = j - E, k + 1
                new += sum(len(s) for s in sectors.values())
    return old, new


def _brute_ngp(pos, table, lv):
    n, L, F = pos.shape[0], lv.num, table.shape[1]
    V = encode_requests.vec_width(F, table)
    keys, wts, _ = ngp.corners(pos, lv)
    keys, wts = keys.tolist(), wts.tolist()
    old = new = 0
    for i0 in range(0, n, 32):
        lanes = range(i0, min(i0 + 32, n))
        for l in range(L):
            for c in range(8):
                live = [i for i in lanes if wts[c][l][i] != 0]
                for f in range(F):
                    old += len({(keys[c][l][i] * F + f) >> 3 for i in live})
                for f in range(0, F, V):
                    new += len({(keys[c][l][i] * F + f) >> 3 for i in live})
    return old, new


@pytest.mark.parametrize("F", [1, 4, 6, 12])
@pytest.mark.parametrize("layout", ["blocked", "ngp"])
def test_request_model_matches_a_brute_force_loop(layout, F):
    pos, table, g, lv = _inputs(layout, F)
    got = encode_requests.requests(layout, pos, table, g, lv)
    want = _brute_blocked(pos, g, lv) if layout == "blocked" else _brute_ngp(pos, table, lv)
    assert got == want
    old, new = got
    V = encode_requests.vec_width(F, table)
    assert V == {1: 1, 4: 4, 6: 2, 12: 4}[F]
    # the new designs merge a sector's lanes (K2g) or V values (K7bg)
    assert 0 < new < old if layout == "blocked" or V > 1 else new == old


def test_vec_width_follows_the_tables_alignment():
    """K7bg's V drops where a view of the table starts off a V-value
    boundary, as the C entry's choice does."""
    base = torch.zeros(4 * 16 + 4)
    assert encode_requests.vec_width(4, base[:64].view(16, 4)) == 4
    assert encode_requests.vec_width(4, base[2:66].view(16, 4)) == 2
    assert encode_requests.vec_width(4, base[1:65].view(16, 4)) == 1
    half = torch.zeros(70, dtype=torch.bfloat16)
    assert encode_requests.vec_width(8, half[4:68].view(8, 8)) == 4
    assert encode_requests.vec_width(8, half[1:65].view(8, 8)) == 1


def test_model_follows_the_kernels_source():
    """The two decisions the model copies from the kernels: K2g's feature
    chunk (kGenChunk) and K7bg's vector width (the C entry's choice of V
    from F and the table's alignment). A change to either in the source
    must reach the model too."""
    from pathlib import Path

    csrc = Path(encode_requests.__file__).parent / "csrc"
    blocked = (csrc / "blocked_encode.cu").read_text()
    chunk = re.search(r"constexpr int kGenChunk = (\d+);", blocked)
    assert chunk and int(chunk.group(1)) == encode_requests.K2G_CHUNK
    entry = (csrc / "ngp_encode.cu").read_text().split("int ngp_encode_bwd_f(")[1]
    assert re.search(r"int V = 4;\s*while \(V > 1 && \(F % V \|\| at % \(V \* elt\) \|\| "
                     r"ad % \(V \* 4\)\)\) V /= 2;", entry)
