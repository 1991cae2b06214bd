"""The port's blocked hash encode (lsenerf_tpu_torch/ops/hash_encoding.py)
against the JAX `hash_encode` with layout="blocked",
blocked_backward="factored" and combine_impl="pallas" (the Pallas kernels
in interpret mode on the CPU): values, table gradient and position
gradient, in an f32 arm and a bf16 arm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.ops import hash_encoding as jhe
from lsenerf_tpu_torch.ops import hash_encoding as the

import torch_parity


def _run(dtype, seed, n=301):
    jcfg, tcfg = torch_parity.hash_configs(dtype)
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)).astype(np.float32)
    table = (rng.uniform(-1, 1, (tcfg.total_rows, 64)) * 1e-2).astype(np.float32)
    probe = rng.standard_normal((n, tcfg.out_dim)).astype(np.float32)
    # the JAX hashed-level gradient drops updates past its window cap: hold
    # the port to it only on inputs where nothing is dropped
    assert int(jhe.blocked_overflow_count(jnp.asarray(pos), jcfg)) == 0

    def jloss(t, p):
        return (jhe.hash_encode(t, p, jcfg) * probe).sum()

    jout = np.asarray(jhe.hash_encode(jnp.asarray(table), jnp.asarray(pos), jcfg))
    jdt, jdp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(pos))

    tt = torch.from_numpy(table).requires_grad_(True)
    tp = torch.from_numpy(pos).requires_grad_(True)
    tout = the.hash_encode(tt, tp, tcfg)
    (tout * torch.from_numpy(probe)).sum().backward()
    return (jout, np.asarray(jdt), np.asarray(jdp)), (
        tout.detach().numpy(), tt.grad.numpy(), tp.grad.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_arm_matches_jax(seed):
    (jout, jdt, jdp), (tout, tdt, tdp) = _run("float32", seed)
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tdt, jdt, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tdp, jdp, rtol=1e-4, atol=1e-5)
    assert np.abs(jdt).max() > 0


def test_bf16_arm_matches_jax():
    """bf16 gather on both sides. JAX also rounds the table-gradient factors
    to bf16, the port keeps them f32, hence the 0.03 x max tolerance of
    tests/test_blocked_hash.py for the table gradient."""
    (jout, jdt, jdp), (tout, tdt, tdp) = _run("bfloat16", 2)
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tdp, jdp, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tdt, jdt, atol=0.03 * np.abs(jdt).max())


def test_encode_is_the_kernel_wrappers():
    """The autograd.Function's forward and backward go through the K1/K2
    wrappers (which on CPU tensors run the plain versions)."""
    from lsenerf_tpu_torch.ops import combine

    _, tcfg = torch_parity.hash_configs()
    calls = []
    fwd, bwd = combine.encode_fwd, combine.encode_bwd
    try:
        combine.encode_fwd = lambda *a: calls.append("fwd") or fwd(*a)
        combine.encode_bwd = lambda *a: calls.append("bwd") or bwd(*a)
        t = the.init_hash_table(tcfg, torch.Generator().manual_seed(0)).requires_grad_(True)
        p = torch.rand((17, 3), generator=torch.Generator().manual_seed(1))
        the.hash_encode(t, p, tcfg).sum().backward()
    finally:
        combine.encode_fwd, combine.encode_bwd = fwd, bwd
    assert calls == ["fwd", "bwd"]
    assert t.grad.shape == (tcfg.total_rows, 64)
