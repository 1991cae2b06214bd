"""K1 and K2 (lsenerf_tpu_torch/ops/combine.py) against their plain PyTorch
versions on the card, in an f32-table and a bf16-table arm.

This file imports neither JAX nor the JAX package, so a machine with the
card and without JAX runs it on its own, skipping the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_card.py -q

Without a card the test skips: the kernels have no CPU mode."""

import numpy as np
import pytest
import torch

from lsenerf_tpu_torch.ops import combine
from lsenerf_tpu_torch.ops import hash_encoding as the

# 5 levels, res 4..64: levels 0-2 dense, 3-4 hashed (2^10 rows)
T_CFG = the.HashEncodingConfig(num_levels=5, base_res=4, max_res=64, blocked_rows_log2=10)


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
