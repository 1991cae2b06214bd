"""The rate probe (lsenerf_tpu_torch/l2_atomic_probe.py) runs only on the
card: without one it raises and builds nothing."""

import pytest
import torch

from lsenerf_tpu_torch import l2_atomic_probe


def test_probe_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(l2_atomic_probe.cuda_build, "build",
                        lambda *a: pytest.fail("built without a card"))
    with pytest.raises(RuntimeError, match="CUDA"):
        l2_atomic_probe.main()


def test_probe_names_each_kernel_of_its_source():
    """One case name per kernel that the source's entries dispatch to: the
    atomics' and the loads' tables, and the shared-memory kernel's two
    instances (random rows, neighbouring rows)."""
    src = l2_atomic_probe.SOURCE
    assert "{f4, f2, f1, row, st4}" in src
    assert "{ld_line, ld_group8, ld_group4w, ld_row512}" in src
    assert "which ? sm_read<false> : sm_read<true>" in src
    assert len(l2_atomic_probe.ATOMIC_CASES) == 5
    assert len(l2_atomic_probe.LOAD_CASES) == 4
    assert len(l2_atomic_probe.SMEM_CASES) == 2
    assert src.count("__global__") == 5 + 4 + 1
    assert l2_atomic_probe.CASES == (l2_atomic_probe.ATOMIC_CASES + l2_atomic_probe.LOAD_CASES
                                     + l2_atomic_probe.SMEM_CASES)
