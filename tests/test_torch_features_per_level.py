"""The port's hash encode at features_per_level F other than 2, against the
JAX package on the CPU, in both layouts: the plain versions of K1g/K2g
(ops/combine.py) and K7ag/K7bg (ops/ngp.py), which the wrappers run on CPU
tensors.

- `hash_encode` at F in {1, 3, 4, 6, 8}, with an f32 and a bf16 gather:
  values, table gradient and position gradient against JAX's `hash_encode`
  and `jax.grad` (the blocked layout with the Pallas combine P1/P2 in
  interpret mode, which take F as a parameter);
- K1g's own order of sums (`encode_requests.k1g_sums`, which the card test
  holds K1g to bit for bit) against JAX's values at F in {1, 4, 8};
- the configuration's shapes (row width, table shape, out_dim) against
  JAX's, `convert`'s ngp table mapping both ways and the blocked layout's
  grad_overflow count at F = 4;
- one train step at 8 levels of F = 4 in both layouts (tests/
  torch_parity.py's small configuration): loss rtol 1e-5, gradients rtol
  1e-3 / atol 1e-6 (PERF.md §2), and the strided coarse-level field at
  F = 4 (its anchors' C F columns).

Tolerances, those of test_torch_hash_encoding.py (blocked) and
test_torch_ngp_encoding.py (ngp) at F = 2. Blocked: the plain version sums
27 terms where JAX's Pallas combine adds them in its own order, rtol 1e-4
/ atol 1e-5; with a bf16 gather JAX also rounds the table-gradient factors
to bf16 and the port keeps them f32, so the table gradient is held to 0.03
x its largest entry (tests/test_blocked_hash.py's bound). ngp, f32: the
keys and weights are JAX's bits and the sums take another order, rtol 1e-5
/ atol 1e-6. ngp, bf16: JAX's backward rounds each table update to bf16 and
scatter-adds it into a bf16 table (fast_gather.py:324); the port adds the
f32 updates in f32. Its table gradient is held to an f64 sum of the same
updates within the f32 sum's error bound, and to JAX's within JAX's bf16
rounding, (k + 1) 2^-8 of the updates' magnitudes for an entry of k
updates."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.ops import hash_encoding as jhe
from lsenerf_tpu_torch import convert
from lsenerf_tpu_torch.engine.trainer import tree_leaves
from lsenerf_tpu_torch.ops import combine, ngp
from lsenerf_tpu_torch.ops import hash_encoding as the

import torch_parity

FEATURES = [1, 3, 4, 6, 8]


def _inputs(jcfg, tcfg, seed, n=193):
    """Positions, the JAX-layout table and a cotangent probe."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)).astype(np.float32)
    shape = ((tcfg.total_rows, tcfg.blocked_row_width) if tcfg.layout == "blocked"
             else (tcfg.features_per_level, tcfg.num_levels * tcfg.table_size))
    table = (rng.uniform(-1, 1, shape) * 1e-2).astype(np.float32)
    probe = rng.standard_normal((n, tcfg.out_dim)).astype(np.float32)
    if tcfg.layout == "blocked":
        # JAX's hashed-level gradient drops updates past its window cap:
        # hold the port to it on inputs where nothing is dropped
        assert int(jhe.blocked_overflow_count(jnp.asarray(pos), jcfg)) == 0
    return pos, table, probe


def _jax(jcfg, pos, table, probe):
    def loss(t, p):
        return (jhe.hash_encode(t, p, jcfg) * probe).sum()

    out = np.asarray(jhe.hash_encode(jnp.asarray(table), jnp.asarray(pos), jcfg))
    dt, dp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(pos))
    dt = np.asarray(dt, np.float32)
    if jcfg.layout == "ngp":
        dt = convert.ngp_table_from_jax(dt)
    return out, dt, np.asarray(dp)


def _port(tcfg, pos, table, probe):
    t = convert.ngp_table_from_jax(table) if tcfg.layout == "ngp" else table
    tt = torch.from_numpy(np.ascontiguousarray(t)).requires_grad_(True)
    tp = torch.from_numpy(pos).requires_grad_(True)
    out = the.hash_encode(tt, tp, tcfg)
    (out * torch.from_numpy(probe)).sum().backward()
    return out.detach().numpy(), tt.grad.numpy(), tp.grad.numpy()


def _ngp_update_sums(tcfg, pos, probe):
    """The ngp table gradient as an f64 sum of the port's f32 updates, the
    sum of their magnitudes, and their count, an entry."""
    lv = the.levels_for(tcfg, "cpu")
    F = tcfg.features_per_level
    keys, wts, _ = ngp.corners(torch.from_numpy(pos), lv)
    g = torch.from_numpy(probe).reshape(pos.shape[0], lv.num, F).permute(1, 0, 2)
    upd = (wts[..., None] * g[None]).reshape(-1, F).double()
    k = keys.reshape(-1)
    exact = torch.zeros((lv.table_rows, F), dtype=torch.float64).index_add_(0, k, upd)
    mag = torch.zeros_like(exact).index_add_(0, k, upd.abs())
    count = torch.zeros(lv.table_rows, dtype=torch.float64).index_add_(
        0, k, torch.ones_like(k, dtype=torch.float64))
    return exact.numpy(), mag.numpy(), count.numpy()[:, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", FEATURES)
@pytest.mark.parametrize("layout", ["blocked", "ngp"])
def test_encode_matches_jax(layout, F, dtype):
    jcfg, tcfg = torch_parity.hash_configs(dtype, layout, features_per_level=F)
    pos, table, probe = _inputs(jcfg, tcfg, seed=F)
    (jout, jdt, jdp), (tout, tdt, tdp) = _jax(jcfg, pos, table, probe), _port(tcfg, pos, table, probe)
    assert tout.shape == (pos.shape[0], tcfg.num_levels * F) and tdt.shape == tcfg.table_shape
    assert np.abs(jdt).max() > 0
    if layout == "blocked":
        np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-5)
        if dtype == "float32":
            np.testing.assert_allclose(tdt, jdt, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(tdp, jdp, rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_allclose(tdp, jdp, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(tdt, jdt, atol=0.03 * np.abs(jdt).max())
        # the pad columns past 27 F carry no gradient
        assert not tdt[:, 27 * F:].any()
        return
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tdp, jdp, rtol=1e-5, atol=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(tdt, jdt, rtol=1e-5, atol=1e-6)
        return
    exact, mag, count = _ngp_update_sums(tcfg, pos, probe)
    assert np.all(np.abs(tdt - exact) <= np.maximum(count - 1, 0) * 2.0**-24 * mag + 1e-30)
    assert np.all(np.abs(tdt - jdt) <= (count + 1) * 2.0**-8 * mag + 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 4, 8])
def test_k1g_order_of_sums_matches_jax(F, dtype):
    """K1g's own order of operations (encode_requests.k1g_sums: each lane of
    a group of 4 weighs its z-pair, the shuffles add the lanes' terms
    pairwise, every product and sum rounded) against JAX's
    hash_encode(layout="blocked") (the Pallas combine in interpret mode)
    and the plain version, within K1g's tolerance on the card, rtol 1e-5 /
    atol 1e-6, on the table the kernel reads (bf16 with a bf16 gather)."""
    from lsenerf_tpu_torch import encode_requests

    jcfg, tcfg = torch_parity.hash_configs(dtype, "blocked", features_per_level=F)
    pos, table, _ = _inputs(jcfg, tcfg, seed=F)
    jout = np.asarray(jhe.hash_encode(jnp.asarray(table), jnp.asarray(pos), jcfg))
    t = torch.from_numpy(table)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    lv = the.levels_for(tcfg, "cpu")
    got = encode_requests.k1g_sums(torch.from_numpy(pos), t, lv)
    assert got.shape == (pos.shape[0], tcfg.out_dim)
    np.testing.assert_allclose(got.numpy(), jout, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got, combine.encode_fwd_plain(torch.from_numpy(pos), t, lv),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("F", FEATURES)
def test_config_shapes_match_jax(F):
    """Row width (32, 96, 128, 192, 224), table shapes and out_dim as JAX's, in
    both layouts; init_hash_table makes the table of that shape."""
    for layout in ("blocked", "ngp"):
        jcfg, tcfg = torch_parity.hash_configs("float32", layout, features_per_level=F)
        assert tcfg.blocked_row_width == jcfg.blocked_row_width
        assert tcfg.out_dim == jcfg.out_dim == tcfg.num_levels * F
        t = the.init_hash_table(tcfg, torch.Generator().manual_seed(0))
        assert t.shape == tcfg.table_shape
        if layout == "ngp":
            assert tcfg.table_shape == (tcfg.num_levels * tcfg.table_size, F)
        else:
            assert tcfg.table_shape == (int(jcfg.blocked_level_rows().sum()), jcfg.blocked_row_width)
    assert {1: 32, 3: 96, 4: 128, 6: 192, 8: 224}[F] == tcfg.blocked_row_width


def test_features_per_level_must_be_positive():
    with pytest.raises(ValueError):
        the.HashEncodingConfig(features_per_level=0)
    for F in (1, 5, 16):
        the.HashEncodingConfig(features_per_level=F, layout="blocked")
        the.HashEncodingConfig(features_per_level=F)


def test_convert_ngp_table_round_trips_at_F4():
    rng = np.random.default_rng(2)
    _, tcfg = torch_parity.hash_configs("float32", "ngp", features_per_level=4)
    jtab = rng.standard_normal((4, tcfg.num_levels * tcfg.table_size)).astype(np.float32)
    ptab = convert.ngp_table_from_jax(jtab)
    assert ptab.shape == tcfg.table_shape
    np.testing.assert_array_equal(ptab[7], jtab[:, 7])
    np.testing.assert_array_equal(convert.ngp_table_to_jax(torch.from_numpy(ptab)), jtab)
    # a model's params carry the table across in the port's layout
    p = convert.params_from_numpy({"field": {"hash_table": jtab}}, {}, hash_layout="ngp")
    assert tuple(p["model"]["field"]["hash_table"].shape) == tcfg.table_shape


@pytest.mark.parametrize("dense_grad_rows", [64, 0])
def test_blocked_overflow_count_matches_jax_at_F4(dense_grad_rows):
    """The sentinel's count reads keys, which do not depend on F: at F = 4
    it is JAX's on uniform samples (none dropped) and on clustered ones
    with every level windowed (dense_grad_rows 0), where JAX's windows
    overflow."""
    jcfg, tcfg = (dataclasses.replace(c, dense_grad_rows=dense_grad_rows)
                  for c in torch_parity.hash_configs("float32", "blocked", features_per_level=4))
    rng = np.random.default_rng(3)
    pos = rng.random((3000, 3)).astype(np.float32)
    if dense_grad_rows == 0:
        pos = 0.4 + 0.05 * pos
    want = int(jhe.blocked_overflow_count(jnp.asarray(pos), jcfg))
    assert int(the.blocked_overflow_count(torch.from_numpy(pos), tcfg)) == want
    assert (want > 0) == (dense_grad_rows == 0)


@pytest.mark.parametrize("layout", ["blocked", "ngp"])
def test_cuda_style_tensors_never_take_the_plain_version(layout):
    """A tensor off the CPU goes to the kernels' checks, which refuse a
    non-CUDA device: the wrappers have no fallback to the plain versions."""
    _, tcfg = torch_parity.hash_configs("float32", layout, features_per_level=4)
    lv = the.levels_for(tcfg, "meta")
    mod = combine if layout == "blocked" else ngp
    pos = torch.empty((5, 3), device="meta")
    table = torch.empty(tcfg.table_shape, device="meta")
    with pytest.raises(ValueError):
        mod.encode_fwd(pos, table, lv)
    with pytest.raises(ValueError):
        mod.encode_bwd(pos, table, torch.empty((5, tcfg.out_dim), device="meta"), lv)


def test_each_layout_counts_its_generic_kernels():
    """K1g/K2g and K7ag/K7bg are launch counters of the path
    (engine.chunk_graph.path_kernels counts them in a capture)."""
    from lsenerf_tpu_torch.engine import chunk_graph

    names = [k.name for k in chunk_graph.path_kernels()]
    for k in (combine.K1G, combine.K2G, ngp.K7AG, ngp.K7BG):
        assert k.name in names and k.name.endswith("_f")


@functools.lru_cache(maxsize=None)
def _step(layout):
    jt, state, tt = torch_parity.trainers(
        layout=layout, hash=dict(num_levels=8, features_per_level=4))
    batch = jt.dm.next_train(0)
    rng = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jt._build_loss_fn(), has_aux=True))(
        state.params, state.occ, jb, jnp.int32(0), rng)
    overflow = 0
    if layout == "blocked":
        overflow = int(jt.make_overflow_probe()(state.params, state.occ, jb, jnp.int32(0)))
    return jt, tt, batch, (loss, metrics, grads, rng, overflow)


@pytest.mark.parametrize("layout", ["blocked", "ngp"])
def test_train_step_at_8_levels_of_4_features_matches_jax(layout):
    jt, tt, batch, (loss, metrics, grads, rng, overflow) = _step(layout)
    assert overflow == 0  # JAX's blocked table gradient is exact only then
    hcfg = tt.model_config.field.hash
    assert (hcfg.num_levels, hcfg.features_per_level, hcfg.out_dim) == (8, 4, 32)
    tb = tt.batch_to_device(batch)
    bg = torch.from_numpy(np.array(jax.random.uniform(rng, (tt.num_rays(tb), 3))))
    tloss, tmetrics, tgrads = tt.grads(tb, bg_color=bg)
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    assert set(tmetrics) == set(metrics)
    jg = dict(tree_leaves(jax.tree.map(np.asarray, grads)))
    assert set(jg) == set(tgrads)
    for path, g in jg.items():
        if path == "model/field/hash_table" and layout == "ngp":
            g = convert.ngp_table_from_jax(g)
        np.testing.assert_allclose(tgrads[path].numpy(), g, rtol=1e-3, atol=1e-6, err_msg=path)
    assert np.abs(jg["model/field/hash_table"]).max() > 0
    assert tt.params["model"]["field"]["hash_table"].shape == hcfg.table_shape


@pytest.mark.parametrize("layout", ["blocked", "ngp"])
def test_strided_field_at_F4_matches_jax(layout):
    """The strided coarse-level field at 8 levels of F = 4 (coarse_levels 2:
    its anchors' features are the first 2 F columns): density, rgb and
    every gradient against JAX's field_apply_strided, with
    test_torch_field_strided.py's tolerances."""
    from lsenerf_tpu.models import field as jfield
    from lsenerf_tpu_torch.models import field as tfield

    jm, tm = torch_parity.model_configs(
        layout=layout, hash=dict(num_levels=8, features_per_level=4),
        field=dict(coarse_stride=2, coarse_levels=2, use_contraction=False))
    jp = jfield.init_field(jax.random.PRNGKey(1), jm.field)
    rng = np.random.default_rng(3)
    n, k = 16, 12
    o = rng.uniform(-0.7, 0.7, (n, 1, 3))
    d = rng.standard_normal((n, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ts = np.sort(rng.uniform(0.05, 1.8, (n, k)), axis=1).astype(np.float32)
    pos = (o + ts[..., None] * d).astype(np.float32)
    dirs = np.repeat(d[:, 0], k, axis=0).astype(np.float32)
    wd = rng.standard_normal((n * k, 1)).astype(np.float32)
    wr = rng.standard_normal((n * k, 3)).astype(np.float32)
    app = np.zeros(n * k, np.int32)

    def jloss(p, x):
        dens, rgb = jfield.field_apply_strided(p, x, jnp.asarray(ts), jnp.asarray(dirs),
                                               jnp.asarray(app), jm.field)
        return (dens * wd).sum() + (rgb * wr).sum(), (dens, rgb)

    (_, (jd, jc)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(pos))
    tp = convert.params_from_numpy({"field": jax.tree.map(np.asarray, jp)}, {},
                                   hash_layout=layout)["model"]["field"]
    leaves = dict(tree_leaves(tp))
    for t in leaves.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(pos).requires_grad_(True)
    td, tc = tfield.field_apply_strided(tp, tx, torch.from_numpy(ts), torch.from_numpy(dirs),
                                        torch.zeros(n, dtype=torch.int32), tm.field)
    ((td * torch.from_numpy(wd)).sum() + (tc * torch.from_numpy(wr)).sum()).backward()
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-3, atol=1e-5)
    for path, g in tree_leaves(jax.tree.map(np.asarray, jgp)):
        if path == "hash_table" and layout == "ngp":
            g = convert.ngp_table_from_jax(g)
        np.testing.assert_allclose(leaves[path].grad.numpy(), g, rtol=1e-3, atol=1e-6,
                                   err_msg=path)
    assert np.abs(np.asarray(jgp["hash_table"])).max() > 0
