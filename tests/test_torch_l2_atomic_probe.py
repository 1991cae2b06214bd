"""The L2 atomic-rate probe (lsenerf_tpu_torch/l2_atomic_probe.py) runs
only on the card: without one it raises and builds nothing."""

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
    """One case name per kernel that the source's `probe` dispatches to."""
    assert "{f4, f2, f1, row, st4}" in l2_atomic_probe.SOURCE
    assert l2_atomic_probe.SOURCE.count("__global__") == len(l2_atomic_probe.CASES) == 5
