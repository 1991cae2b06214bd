"""The port's mappers and losses (lsenerf_tpu_torch/models/mappers.py,
losses.py) against the JAX package on the CPU: the five mappers' values
and gradients on JAX's own parameters, the identity pretrain
on its own from the same initial weights, enerf_norm_loss, and the learned
and gt RGB-to-one reducers. Inputs are numpy arrays from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.models import losses as jloss
from lsenerf_tpu.models import mappers as jmap
from lsenerf_tpu.models import mlp as jmlp
from lsenerf_tpu_torch import convert
from lsenerf_tpu_torch.engine.trainer import tree_leaves
from lsenerf_tpu_torch.models import losses as tloss
from lsenerf_tpu_torch.models import mappers as tmap
from lsenerf_tpu_torch.models import mlp as tmlp

# the port's and JAX's identity pretrains start from the same weights and
# take the same Adam steps: 10 steps agree to ~6e-6 on the linspace. At
# lr 5e-2 the rounding differences of torch Adam and optax grow chaotically
# from ~100 steps on (0.018 apart at 100 steps, 0.012 and 0.008 at 5000 for
# the 1->1 and 3->3 nets), so the full fits are held to each other and to
# the identity in absolute terms on the linspace
SHORT_ATOL = 2e-5
PRETRAIN_ATOL = 2e-2
IDENTITY_ATOL = 2.5e-2


def _torch_leaves(tree):
    t = convert.tree_to_torch(jax.tree.map(np.asarray, tree))
    for _, v in tree_leaves(t):
        v.requires_grad_(True)
    return t


def test_mapper_registry_matches():
    assert tmap.MAPPERS == jmap.MAPPERS
    assert tloss.EVENT_LOSSES == jloss.EVENT_LOSSES


@pytest.mark.parametrize("name", list(jmap.MAPPERS))
def test_mapper_values_and_grads_match(name):
    """Each mapper on JAX's parameters (the MLPs as drawn, before their
    pretrain, which test_identity_pretrain_matches_jax holds): its values
    and the gradients of a probe loss with respect to the input and to
    every parameter."""
    d = 3 if name == "rgb_mlp" else 1
    jp = jmap.init_mapper(name, jax.random.PRNGKey(3)) if "mlp" not in name else {
        "mlp": jmlp.init_mlp(jax.random.PRNGKey(3), d, 4, 16, d)}
    if name == "powpow":
        jp = {"pow_coeff": jnp.asarray([0.8], jnp.float32)}
    rng = np.random.default_rng(4)
    x = rng.uniform(1e-5, 1.0, (200, d)).astype(np.float32)
    w = rng.standard_normal((200, d)).astype(np.float32)

    def jf(p, v):
        return (jmap.apply_mapper(name, p, v) * w).sum()

    (jgp, jgx) = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = _torch_leaves(jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tmap.apply_mapper(name, tp, tx)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jmap.apply_mapper(name, jp, x)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-6)
    for path, g in tree_leaves(jax.tree.map(np.asarray, jgp)):
        leaf = dict(tree_leaves(tp))[path]
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=1e-4, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("in_dim", [1, 3])
@pytest.mark.parametrize("steps", [10, 5000])
def test_identity_pretrain_matches_jax(in_dim, steps):
    """The Adam(5e-2) identity fit, alone, from JAX's initial weights: 10
    steps agree within SHORT_ATOL on the 100-point linspace; the full 5000
    within PRETRAIN_ATOL, each within IDENTITY_ATOL of the identity."""
    init = jmlp.init_mlp(jax.random.PRNGKey(7), in_dim, 4, 16, in_dim)
    jfit = jmap._identity_pretrain(init, in_dim, steps)
    tfit = tmap.identity_pretrain(convert.tree_to_torch(jax.tree.map(np.asarray, init)),
                                  in_dim, steps)
    lins = np.repeat(np.linspace(0, 1, 100, dtype=np.float32)[:, None], in_dim, 1)
    jout = np.asarray(jmlp.apply_mlp(jfit, jnp.asarray(lins), out_activation=jax.nn.sigmoid))
    tout = tmap.apply_mapper("mlp", {"mlp": tfit}, torch.from_numpy(lins)).numpy()
    gap = np.abs(tout - jout).max()
    if steps == 10:
        assert gap < SHORT_ATOL, gap
        return
    assert gap < PRETRAIN_ATOL, gap
    assert np.abs(tout - lins).max() < IDENTITY_ATOL
    assert np.abs(jout - lins).max() < IDENTITY_ATOL


def test_init_mapper_pretrains_on_its_generator(monkeypatch):
    """init_mapper draws the MLP from its generator and returns the fitted
    weights, detached, a 4 x 16 net: 300 steps of the pretrain (the full
    5000 are held above) bring it nearer the identity than its draw."""
    monkeypatch.setattr(tmap, "PRETRAIN_STEPS", 300)
    p = tmap.init_mapper("rgb_mlp", torch.Generator().manual_seed(0))
    drawn = tmlp.init_mlp(torch.Generator().manual_seed(0), 3, 4, 16, 3)
    assert sorted(p["mlp"]) == ["b0", "b1", "b2", "b3", "w0", "w1", "w2", "w3"]
    assert p["mlp"]["w0"].shape == (3, 16) and not p["mlp"]["w0"].requires_grad
    x = torch.linspace(0, 1, 100)[:, None].expand(100, 3)
    err = (tmap.apply_mapper("rgb_mlp", p, x) - x).abs().max()
    assert err < 0.1 and err < (tmap.apply_mapper("rgb_mlp", {"mlp": drawn}, x) - x).abs().max()
    assert tmap.init_mapper("gt") == {} and tmap.init_mapper("identity") == {}
    with pytest.raises(ValueError):
        tmap.init_mapper("cubic")


@pytest.mark.parametrize("channels", [1, 3])
def test_enerf_norm_loss_matches(channels):
    rng = np.random.default_rng(channels)
    n = 300
    prev = rng.uniform(0.05, 1.0, (n, channels)).astype(np.float32)
    nxt = rng.uniform(0.05, 1.0, (n, channels)).astype(np.float32)
    evs = (rng.standard_normal((n, channels)) * 0.3).astype(np.float32)
    thresh = np.full((n, 1), 0.2, np.float32)
    jl, (jgp, jgn, jge) = jax.value_and_grad(jloss.enerf_norm_loss, argnums=(1, 2, 0))(
        jnp.asarray(evs), jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(thresh))
    tp, tn, te = (torch.from_numpy(a).requires_grad_(True) for a in (prev, nxt, evs))
    tl = tloss.enerf_norm_loss(te, tp, tn, torch.from_numpy(thresh))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(jgn), rtol=1e-4, atol=1e-9)
    # the event side is under stop_gradient
    assert not np.asarray(jge).any() and te.grad is None


@pytest.mark.parametrize("kind", ["learned", "gt", None])
def test_rgb_to_one_matches(kind):
    """The reducers' values and gradients, the learned one also at weights
    moved off its 1/3 init."""
    jp = jloss.init_rgb_to_one(kind)
    tp = tloss.init_rgb_to_one(kind)
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    if kind == "learned":
        jp = {"weights": jnp.asarray([[0.5, -0.2, 0.1]], jnp.float32)}
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    w = rng.standard_normal((64, 1 if kind else 3)).astype(np.float32)

    def jf(p, v):
        return (jloss.apply_rgb_to_one(kind, p, v) * w).sum()

    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = _torch_leaves(jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tloss.apply_rgb_to_one(kind, tp, tx)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jloss.apply_rgb_to_one(kind, jp, x)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-7)
    if kind == "learned":
        np.testing.assert_allclose(tp["weights"].grad.numpy(), np.asarray(jgp["weights"]),
                                   rtol=1e-5, atol=1e-7)
