"""The port's blocked-encode kernel math (lsenerf_tpu_torch/ops/combine.py)
against the JAX package's keys and Pallas combine kernels.

On the CPU the wrappers run their plain PyTorch versions; the Pallas kernels
run in interpret mode, as tests/test_blocked_hash.py runs them. The
kernel-against-plain check on the card is tests/test_torch_kernels_card.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.ops import hash_encoding as jhe
from lsenerf_tpu.ops import pallas_combine
from lsenerf_tpu_torch.ops import combine
from lsenerf_tpu_torch.ops import hash_encoding as the

# 5 levels, res 4..64: levels 0-2 dense, 3-4 hashed (2^10 rows)
J_CFG = jhe.HashEncodingConfig(
    num_levels=5, base_res=4, max_res=64, layout="blocked", blocked_rows_log2=10,
    dense_grad_rows=64,
)
T_CFG = the.HashEncodingConfig(
    num_levels=5, base_res=4, max_res=64, blocked_rows_log2=10,
)


def _inputs(seed, n=257):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)).astype(np.float32)
    pos[:4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.25, 0.75], [1e-7, 0.999999, 0.5]]
    table = rng.standard_normal((T_CFG.total_rows, 64)).astype(np.float32)
    return pos, table


def test_layout_matches_jax():
    np.testing.assert_array_equal(T_CFG.scalings(), J_CFG.scalings())
    np.testing.assert_array_equal(T_CFG.blocked_level_rows(), J_CFG.blocked_level_rows())
    assert T_CFG.blocked_row_width == J_CFG.blocked_row_width == 64
    assert the._dense_level_count(T_CFG) == jhe._dense_level_count(J_CFG) == 3


def test_keys_and_fracs_match_jax():
    pos, _ = _inputs(0)
    jk, *jow = jhe._blocked_keys_fracs(jnp.asarray(pos), J_CFG)
    tk, *tow = the._blocked_keys_fracs(torch.from_numpy(pos), T_CFG)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for (jo, jw), (to, tw) in zip(jow, tow):
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def _pallas_args(pos, table):
    keys, o, w = combine.keys_fracs(
        torch.from_numpy(pos), the.levels_for(T_CFG, "cpu")
    )
    rows = table[keys.reshape(-1).numpy()]  # (L*n, 64), level-major
    e = [(o[d].float() + w[d]).reshape(-1).numpy() for d in range(3)]
    return keys, rows, e


@pytest.mark.parametrize("seed", [0, 1])
def test_fwd_plain_matches_pallas_combine(seed):
    pos, table = _inputs(seed)
    n, L = pos.shape[0], T_CFG.num_levels
    _, rows, e = _pallas_args(pos, table)
    want = np.asarray(pallas_combine.combine(jnp.asarray(rows), *map(jnp.asarray, e), 2))
    want = want.reshape(2, L, n).transpose(2, 1, 0).reshape(n, L * 2)
    got = combine.encode_fwd(
        torch.from_numpy(pos), torch.from_numpy(table), the.levels_for(T_CFG, "cpu")
    )
    # P1 re-encodes (o, w) as e = o + w, which loses bits of w when o = 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_bwd_plain_matches_pallas_dw_and_scatter(seed):
    pos, table = _inputs(seed)
    n, L = pos.shape[0], T_CFG.num_levels
    g = np.random.default_rng(seed + 10).standard_normal((n, L * 2)).astype(np.float32)
    keys, rows, e = _pallas_args(pos, table)
    gfm = g.reshape(n, L, 2).transpose(2, 1, 0).reshape(2, L * n)
    dw = np.asarray(pallas_combine.combine_bwd_dw(
        jnp.asarray(rows), jnp.asarray(gfm), *map(jnp.asarray, e), 2))
    scal = T_CFG.scalings().astype(np.float32)[:, None]
    want_dpos = np.stack([(dw[d].reshape(L, n) * scal).sum(0) for d in range(3)], 1)

    dpos, dtable = combine.encode_bwd(
        torch.from_numpy(pos), torch.from_numpy(table), torch.from_numpy(g),
        the.levels_for(T_CFG, "cpu"),
    )
    # A position clipped to the top cell (w == 1 at even parity) sits on a
    # kink of the trilinear weights. P2 decodes e = o + w = 1 as (o=1, w=0),
    # the same weights but the other one-sided derivative; the port keeps
    # (o, w) as the JAX xla arm does, so those samples are held to that arm.
    _, o, w = combine.keys_fracs(torch.from_numpy(pos), the.levels_for(T_CFG, "cpu"))
    kink = np.zeros(n, bool)
    for d in range(3):
        kink |= ((o[d] == 0) & (w[d] == 1.0)).any(0).numpy()
    assert kink[1] and kink.sum() < 8
    np.testing.assert_allclose(dpos.numpy()[~kink], want_dpos[~kink],
                               rtol=1e-4, atol=1e-5)
    xla_dpos = jax.grad(
        lambda p: (jhe.hash_encode(jnp.asarray(table), p, J_CFG) * g).sum()
    )(jnp.asarray(pos))
    np.testing.assert_allclose(dpos.numpy(), np.asarray(xla_dpos),
                               rtol=1e-4, atol=1e-4)

    # table gradient: the rank-1 update w27 x g of every sample-level, by a
    # numpy loop over the updates
    u = [combine._slot_weights(o[d], w[d]).numpy() for d in range(3)]
    want_tab = np.zeros_like(table)
    k = keys.numpy()
    for li in range(L):
        for i in range(n):
            w27 = np.einsum("a,b,c->abc", u[0][li, i], u[1][li, i], u[2][li, i])
            want_tab[k[li, i], :54] += np.outer(w27.reshape(27), g[i, 2 * li : 2 * li + 2]).reshape(54)
    np.testing.assert_allclose(dtable.numpy(), want_tab, rtol=1e-5, atol=1e-5)
    assert not dtable[:, 54:].any()


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A wrapper given a non-CPU tensor launches its kernel or raises; it
    never falls back to the plain version."""
    called = []
    monkeypatch.setattr(combine, "encode_fwd_plain", lambda *a: called.append(1))
    pos = torch.zeros((4, 3), device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        combine.encode_fwd(pos, torch.zeros((8, 64), device="meta"),
                           the.levels_for(T_CFG, "cpu"))
    assert not called
