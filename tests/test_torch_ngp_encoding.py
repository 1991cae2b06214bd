"""The port's ngp hash encode (lsenerf_tpu_torch/ops/hash_encoding.py with
layout="ngp", kernels K7a/K7b in ops/ngp.py, their plain versions on the
CPU) against the JAX `hash_encode` with layout="ngp" (its scatter-add
backward off the TPU): values, table gradient and position gradient in an
f32 arm and a bf16 arm; the level-window identity in both layouts; and
convert's table mapping both ways.

Tolerances. f32: the keys and weights are JAX's bits, and the table
gradient adds the same f32 updates (JAX's scatter, the port's index_add_);
what differs is the order of the 8-corner sums and of the position
gradient's terms, so rtol 1e-5 / atol 1e-6. bf16: JAX rounds each table
update to bf16 and scatter-adds into a bf16 table (fast_gather.py:324); the
port adds the f32 updates in f32, on purpose. Its table gradient is held
to an f64 sum of the same updates within the f32 sum's own error bound,
and to JAX's within JAX's bf16 rounding: each of k adds rounds to 2^-8 of
the running sum, so |port - JAX| <= (k + 1) 2^-8 sum|updates| an entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.ops import hash_encoding as jhe
from lsenerf_tpu_torch import convert
from lsenerf_tpu_torch.ops import hash_encoding as the
from lsenerf_tpu_torch.ops import ngp

import torch_parity


def _inputs(tcfg, seed, n=301):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)).astype(np.float32)
    table = (rng.uniform(-1, 1, (2, tcfg.num_levels * tcfg.table_size)) * 1e-2).astype(np.float32)
    probe = rng.standard_normal((n, tcfg.out_dim)).astype(np.float32)
    return pos, table, probe


def _jax(jcfg, pos, table, probe):
    def loss(t, p):
        return (jhe.hash_encode(t, p, jcfg) * probe).sum()

    out = np.asarray(jhe.hash_encode(jnp.asarray(table), jnp.asarray(pos), jcfg))
    dt, dp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(pos))
    return out, convert.ngp_table_from_jax(np.asarray(dt, np.float32)), np.asarray(dp)


def _port(tcfg, pos, table, probe, layout_table=None):
    tt = torch.from_numpy(convert.ngp_table_from_jax(table) if layout_table is None
                          else layout_table).requires_grad_(True)
    tp = torch.from_numpy(pos).requires_grad_(True)
    out = the.hash_encode(tt, tp, tcfg)
    (out * torch.from_numpy(probe)).sum().backward()
    return out.detach().numpy(), tt.grad.numpy(), tp.grad.numpy()


WINDOWS = {"all": {}, "fine": dict(level_lo=2), "coarse": dict(level_hi=2),
           "middle": dict(level_lo=1, level_hi=5)}


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("seed", [0, 1])
def test_f32_arm_matches_jax(seed, window):
    jcfg, tcfg = torch_parity.hash_configs("float32", "ngp", **WINDOWS[window])
    pos, table, probe = _inputs(tcfg, seed)
    (jout, jdt, jdp), (tout, tdt, tdp) = _jax(jcfg, pos, table, probe), _port(tcfg, pos, table, probe)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tdt, jdt, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tdp, jdp, rtol=1e-5, atol=1e-6)
    assert np.abs(jdt).max() > 0 and tout.shape == (pos.shape[0], tcfg.out_dim)


def _update_sums(tcfg, pos, probe):
    """The table gradient as an f64 sum of the port's f32 updates, and the
    sum of their magnitudes, an entry."""
    lv = the.levels_for(tcfg, "cpu")
    keys, wts, _ = ngp.corners(torch.from_numpy(pos), lv)
    g = torch.from_numpy(probe).reshape(pos.shape[0], lv.num, 2).permute(1, 0, 2)
    upd = (wts[..., None] * g[None]).reshape(-1, 2).double()
    k = keys.reshape(-1)
    exact = torch.zeros((lv.table_rows, 2), dtype=torch.float64).index_add_(0, k, upd)
    mag = torch.zeros_like(exact).index_add_(0, k, upd.abs())
    count = torch.zeros(lv.table_rows, dtype=torch.float64).index_add_(
        0, k, torch.ones_like(k, dtype=torch.float64))
    return exact.numpy(), mag.numpy(), count.numpy()[:, None]


@pytest.mark.parametrize("window", ["all", "middle"])
def test_bf16_arm_matches_jax(window):
    jcfg, tcfg = torch_parity.hash_configs("bfloat16", "ngp", **WINDOWS[window])
    pos, table, probe = _inputs(tcfg, 2)
    (jout, jdt, jdp), (tout, tdt, tdp) = _jax(jcfg, pos, table, probe), _port(tcfg, pos, table, probe)
    # both gather the same bf16-rounded features
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tdp, jdp, rtol=1e-5, atol=1e-6)
    exact, mag, count = _update_sums(tcfg, pos, probe)
    f32_bound = np.maximum(count - 1, 0) * 2.0**-24 * mag
    assert np.all(np.abs(tdt - exact) <= f32_bound + 1e-30)
    bf16_bound = (count + 1) * 2.0**-8 * mag
    assert np.all(np.abs(tdt - jdt) <= bf16_bound + 1e-30)
    # JAX's bf16 sum does round: the port is not JAX's bits
    assert np.abs(tdt - jdt).max() > 0 and np.abs(jdt).max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["ngp", "blocked"])
def test_level_window_concatenates_to_the_ladder(layout, dtype):
    """concat(encode[0:C], encode[C:L]) == encode[0:L] in both layouts,
    forward, table gradient and position gradient: the window keeps the
    ladder's geometry (tests/test_field.py's invariant for JAX)."""
    C = 2
    _, full = torch_parity.hash_configs(dtype, layout)
    lo = torch_parity.hash_configs(dtype, layout, level_hi=C)[1]
    hi = torch_parity.hash_configs(dtype, layout, level_lo=C)[1]
    rng = np.random.default_rng(5)
    pos = torch.from_numpy(rng.random((257, 3)).astype(np.float32))
    table = torch.from_numpy((rng.uniform(-1, 1, full.table_shape) * 1e-2).astype(np.float32))
    probe = torch.from_numpy(rng.standard_normal((257, full.out_dim)).astype(np.float32))

    def run(cfgs):
        t, p = table.clone().requires_grad_(True), pos.clone().requires_grad_(True)
        out = torch.cat([the.hash_encode(t, p, c) for c in cfgs], dim=-1)
        (out * probe).sum().backward()
        return out.detach(), t.grad, p.grad

    (o1, t1, p1), (o2, t2, p2) = run([full]), run([lo, hi])
    assert lo.out_dim + hi.out_dim == full.out_dim
    torch.testing.assert_close(o2, o1, rtol=0, atol=0)
    # the two windows' gradients are added by autograd: one rounding apart
    torch.testing.assert_close(t2, t1, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(p2, p1, rtol=1e-5, atol=1e-6)


def test_convert_maps_the_ngp_table_both_ways():
    """JAX's (F, L*T) table -> the port's (L*T, F) and back; the port's
    encode of the converted table is JAX's encode of the original; a
    blocked table passes through params_from_numpy as it is."""
    jcfg, tcfg = torch_parity.hash_configs("float32", "ngp")
    key = jax.random.PRNGKey(3)
    jt = np.asarray(jhe.init_hash_table(key, jcfg))
    assert jt.shape == (2, tcfg.num_levels * tcfg.table_size)
    params = convert.params_from_numpy({"field": {"hash_table": jt}}, {}, hash_layout="ngp")
    tt = params["model"]["field"]["hash_table"]
    assert tt.shape == tcfg.table_shape and tt.is_contiguous()
    np.testing.assert_array_equal(convert.ngp_table_to_jax(tt), jt)
    pos = np.random.default_rng(0).random((64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        the.hash_encode(tt, torch.from_numpy(pos), tcfg).numpy(),
        np.asarray(jhe.hash_encode(jnp.asarray(jt), jnp.asarray(pos), jcfg)), rtol=1e-5, atol=1e-7)
    blocked = np.ones((5, 64), np.float32)
    same = convert.params_from_numpy({"field": {"hash_table": blocked}}, {})
    np.testing.assert_array_equal(same["model"]["field"]["hash_table"].numpy(), blocked)


def test_config_matches_jax_defaults_and_geometry():
    """The port's HashEncodingConfig() is JAX's: layout ngp, 2^19 entries a
    level; table shape, out_dim and active range follow the window."""
    j, t = jhe.HashEncodingConfig(), the.HashEncodingConfig()
    assert (t.layout, t.log2_hashmap_size, t.table_size) == (j.layout, j.log2_hashmap_size, j.table_size)
    assert t.table_shape == (16 * 2**19, 2)
    np.testing.assert_array_equal(t.scalings(), j.scalings())
    for kw in ({}, dict(level_lo=4), dict(level_hi=4), dict(level_lo=3, level_hi=9)):
        jw, tw = jhe.HashEncodingConfig(**kw), the.HashEncodingConfig(**kw)
        assert (tw.active_range, tw.out_dim) == (jw.active_range, jw.out_dim)
    with pytest.raises(ValueError):
        the.HashEncodingConfig(layout="dense")
    with pytest.raises(ValueError):
        the.HashEncodingConfig(level_lo=4, level_hi=4)


def test_encode_is_the_kernel_wrappers():
    """The ngp autograd.Function's forward and backward go through the
    K7a/K7b wrappers (which on CPU tensors run the plain versions), and the
    table gradient has the table's whole shape under a window."""
    _, tcfg = torch_parity.hash_configs("float32", "ngp", level_lo=2)
    calls = []
    fwd, bwd = ngp.encode_fwd, ngp.encode_bwd
    try:
        ngp.encode_fwd = lambda *a: calls.append("fwd") or fwd(*a)
        ngp.encode_bwd = lambda *a: calls.append("bwd") or bwd(*a)
        t = the.init_hash_table(tcfg, torch.Generator().manual_seed(0)).requires_grad_(True)
        p = torch.rand((17, 3), generator=torch.Generator().manual_seed(1))
        the.hash_encode(t, p, tcfg).sum().backward()
    finally:
        ngp.encode_fwd, ngp.encode_bwd = fwd, bwd
    assert calls == ["fwd", "bwd"]
    assert t.grad.shape == tcfg.table_shape
    assert not t.grad[: 2 * tcfg.table_size].any() and t.grad[2 * tcfg.table_size:].any()


def test_wrappers_run_the_plain_version_only_on_the_cpu():
    """A CUDA tensor never falls back to the plain version: without a card
    the check refuses it before any launch."""
    _, tcfg = torch_parity.hash_configs("float32", "ngp")
    lv = the.levels_for(tcfg, "cpu")
    pos = torch.rand((8, 3))
    table = torch.zeros(tcfg.table_shape)
    assert ngp.encode_fwd(pos, table, lv).shape == (8, tcfg.out_dim)
    with pytest.raises(ValueError, match="CUDA"):
        ngp._check(pos, table, lv)


def _pair_positions(kind, n, rng):
    """Unit-cube positions (n, 3), on grid faces at the given levels, or
    outside the cube (negative base corners), as the wrapper accepts them."""
    if kind == "uniform":
        return rng.random((n, 3)).astype(np.float32)
    if kind == "faces":  # multiples of 1/64: faces of every level with a power-of-2 scale
        return (rng.integers(0, 65, (n, 3)) / 64.0).astype(np.float32)
    return rng.uniform(-1.5, 2.5, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("log2_T", [1, 4, 10, 19])
@pytest.mark.parametrize("window", [(0, 5), (2, 3), (4, 5)])
@pytest.mark.parametrize("kind", ["uniform", "faces", "outside"])
def test_even_base_pairs_the_x_corners(kind, window, log2_T):
    """The invariant K7a's x-pair load relies on: wherever a cube's base x
    coordinate is even, its corners with cx = 0 and cx = 1 (same cy, cz)
    have global keys that differ by exactly 1, the smaller even; so the
    pair is one aligned two-entry load. Both parities occur."""
    lo, hi = window
    cfg = the.HashEncodingConfig(num_levels=5, base_res=4, max_res=64, log2_hashmap_size=log2_T,
                                 level_lo=lo, level_hi=hi)
    lv = the.levels_for(cfg, "cpu")
    pos = torch.from_numpy(_pair_positions(kind, 997, np.random.default_rng(log2_T + lo)))
    keys, _, _ = ngp.corners(pos, lv)  # (8, Lw, n), corner c = cx*4 + cy*2 + cz
    b0 = torch.floor(pos[None, :, 0] * lv.scale[:, None]).long()
    even = b0 % 2 == 0
    assert even.any() and (~even).any()
    k0, k1 = keys[:4], keys[4:]
    assert torch.equal(k0[:, even] ^ 1, k1[:, even])
    assert torch.equal(torch.minimum(k0, k1)[:, even] % 2, torch.zeros_like(k0[:, even]))
    if kind == "outside":
        assert (b0 < 0).any()
