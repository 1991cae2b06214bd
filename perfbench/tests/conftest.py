"""The benchmark's tests run from the root of a checkout: the repo root
on the path, so that `perfbench` and the port import."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


import argparse  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402

TINY_SCENE = dict(n_cams=8, h=24, w=32, focal=0.9 * 32, texture_freq=24.0, n_val=2)


@pytest.fixture
def tiny():
    """(config, traffic) of a cell cut to a size the CPU runs in seconds:
    its configuration's model and protocol on an 8-frame 32x24 scene with
    256 rays a step, chunks of 4 steps."""
    from perfbench.harness import manifest

    def make(cell: str):
        man = manifest.manifest()
        w = manifest.cell(cell, man)
        cfg = dict(manifest.config(w["config"], man), rays_per_batch=256, scene=TINY_SCENE)
        tr = dict(manifest.traffic(w["traffic"]), scan_steps=4, warm_chunks=2, trace_chunks=1)
        return cfg, tr

    return make


@pytest.fixture
def run_tiny(tiny):
    """One run of a cell at the tiny size on the CPU (core.run_cell)."""
    import torch

    from perfbench.harness import core

    def run(cell: str, trace: int = 0, seed: int = 2**31 + 11, seconds: float = 0.3):
        cfg, tr = tiny(cell)
        args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
        return core.run_cell(args, time.perf_counter(), device=torch.device("cpu"), config=cfg,
                             traffic=tr)

    return run
