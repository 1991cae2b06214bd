"""The port's appearance embeddings (lsenerf_tpu_torch/models/embeddings.py)
and the field's per-ray codes (field.appearance_codes) against the JAX
package on the CPU: the global and per-frame (evs_emb) lookups and their
table gradients, the eval modes zero, mean and param, init_test_params,
and the is_eval switch. Tables and ids are numpy arrays from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.models import embeddings as jemb
from lsenerf_tpu_torch.models import embeddings as temb
from lsenerf_tpu_torch.models import field as tfield

ROWS, DIM = 30, 8


def _configs(**kw):
    kw = dict(emb_dim=DIM, **kw)
    return jemb.EmbeddingConfig(**kw), temb.EmbeddingConfig(**kw)


def _table(rows=ROWS):
    return np.random.default_rng(0).standard_normal((rows, DIM)).astype(np.float32)


def _lookup(jc, tc, jp, tp, ids, train, w):
    """Both lookups' values, and the gradients of sum(codes * w) with
    respect to each table leaf."""

    def jf(p):
        return (jemb.apply_embedding(p, jc, jnp.asarray(ids), train=train) * w).sum()

    jval = np.asarray(jemb.apply_embedding(jp, jc, jnp.asarray(ids), train=train))
    jg = jax.grad(jf)(jp)
    tp = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True) for k, v in tp.items()}
    out = temb.apply_embedding(tp, tc, torch.from_numpy(ids), train=train)
    if out.requires_grad:  # the zero mode's codes hang on no parameter
        (out * torch.from_numpy(w)).sum().backward()
    return jval, out.detach().numpy(), jg, tp


def test_registries_match():
    assert temb.EMBEDDING_TYPES == jemb.EMBEDDING_TYPES
    assert temb.EVAL_MODES == jemb.EVAL_MODES
    assert temb.EmbeddingConfig() == temb.EmbeddingConfig(
        embedding_type="global_emb", emb_dim=32, eval_mode="zero", test_init_row=21, is_eval=False)


@pytest.mark.parametrize("emb_type", list(jemb.EMBEDDING_TYPES))
def test_init_rows(emb_type):
    jc, tc = _configs(embedding_type=emb_type)
    jt = jemb.init_embedding(jax.random.PRNGKey(0), jc, 12)["table"]
    tt = temb.init_embedding(torch.Generator().manual_seed(0), tc, 12)["table"]
    assert tt.shape == jt.shape == ((1 if emb_type == "global_emb" else 12), DIM)
    # N(0, 1) rows
    big = temb.init_embedding(torch.Generator().manual_seed(1), temb.EmbeddingConfig("evs_emb"), 4000)
    assert abs(float(big["table"].mean())) < 0.01 and abs(float(big["table"].std()) - 1) < 0.01


@pytest.mark.parametrize("emb_type", list(jemb.EMBEDDING_TYPES))
@pytest.mark.parametrize("train", [True, False])
def test_lookup_and_table_gradient_match(emb_type, train):
    """Train mode indexes the table (global: row 0 for every id) and adds
    the codes' cotangents into it; eval mode's default `zero` gives zeros
    and no gradient (global: still row 0)."""
    jc, tc = _configs(embedding_type=emb_type)
    table = _table(1 if emb_type == "global_emb" else ROWS)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, table.shape[0], 500).astype(np.int32)
    w = rng.standard_normal((500, DIM)).astype(np.float32)
    jp = {"table": jnp.asarray(table)}
    jval, tval, jg, tp = _lookup(jc, tc, jp, {"table": table}, ids, train, w)
    np.testing.assert_array_equal(tval, jval)
    g = tp["table"].grad
    g = np.zeros_like(table) if g is None else g.numpy()
    np.testing.assert_allclose(g, np.asarray(jg["table"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", list(jemb.EVAL_MODES))
@pytest.mark.parametrize("is_eval", [False, True])
def test_eval_modes_match(mode, is_eval):
    """zero, mean and param in eval, and in training steps of an eval run
    (is_eval): values and the gradients of the table and the test row."""
    jc, tc = _configs(embedding_type="evs_emb", eval_mode=mode, is_eval=is_eval)
    table = _table()
    jp = jemb.init_test_params({"table": jnp.asarray(table)}, jc)
    tp = temb.init_test_params({"table": torch.from_numpy(table)}, tc)
    assert set(tp) == set(jp) == {"table", "test_table"}
    np.testing.assert_array_equal(tp["test_table"].numpy(), table[21:22])
    rng = np.random.default_rng(2)
    ids = rng.integers(0, ROWS, 64).astype(np.int32)
    w = rng.standard_normal((64, DIM)).astype(np.float32)
    for train in (True, False):
        jval, tval, jg, tl = _lookup(jc, tc, jp, {k: v.numpy() for k, v in tp.items()},
                                     ids, train, w)
        np.testing.assert_allclose(tval, jval, rtol=1e-6, atol=1e-7)
        for k in jp:
            g = tl[k].grad
            g = np.zeros(tl[k].shape, np.float32) if g is None else g.numpy()
            np.testing.assert_allclose(g, np.asarray(jg[k]), rtol=1e-5, atol=1e-5, err_msg=k)


def test_init_test_params_rules():
    """No test row for a one-row table; an existing one is kept; the row is
    clipped to the table; param mode without it raises."""
    _, tc = _configs(embedding_type="evs_emb", eval_mode="param")
    one = {"table": torch.zeros((1, DIM))}
    assert temb.init_test_params(one, tc) is one
    small = {"table": torch.arange(5 * DIM, dtype=torch.float32).reshape(5, DIM)}
    seeded = temb.init_test_params(small, tc)
    assert torch.equal(seeded["test_table"], small["table"][4:5])
    assert temb.init_test_params(seeded, tc) is seeded
    with pytest.raises(ValueError, match="init_test_params"):
        temb.apply_embedding(small, tc, torch.zeros(3, dtype=torch.long), train=False)


@pytest.mark.parametrize("emb_type", list(jemb.EMBEDDING_TYPES))
def test_per_ray_codes_match_per_sample_lookup(emb_type):
    """appearance_codes with one id a ray of k samples gives JAX's lookup of
    the id broadcast to every sample, and the same table gradient."""
    jc, tc = _configs(embedding_type=emb_type)
    table = _table(1 if emb_type == "global_emb" else ROWS)
    rng = np.random.default_rng(3)
    n, k = 40, 16
    ids = rng.integers(0, table.shape[0], n).astype(np.int32)
    w = rng.standard_normal((n * k, DIM)).astype(np.float32)

    def jf(t):
        return (jemb.apply_embedding({"table": t}, jc, jnp.asarray(np.repeat(ids, k))) * w).sum()

    jg = jax.grad(jf)(jnp.asarray(table))
    cfg = tfield.FieldConfig(embedding=tc)
    tt = torch.from_numpy(table).requires_grad_(True)
    codes = tfield.appearance_codes({"appearance": {"table": tt}}, torch.from_numpy(ids), n * k, cfg)
    (codes * torch.from_numpy(w)).sum().backward()
    rows = np.repeat(ids, k) if emb_type == "evs_emb" else np.zeros(n * k, int)
    np.testing.assert_array_equal(codes.detach().numpy(), table[rows])
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
