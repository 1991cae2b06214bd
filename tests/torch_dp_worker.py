"""A rank of the data-parallel CPU tests (tests/test_torch_parallel.py),
spawned with torch.multiprocessing: it imports the port alone. Each case
builds the small parity trainer from picklable configs and numpy params,
then takes one step on its share of a fixed global batch and background,
or runs one occupancy update on given cells; rank r saves what it got to
<out_dir>/rank<r>.pt."""

from __future__ import annotations

import os

import numpy as np
import torch

from lsenerf_tpu_torch import convert
from lsenerf_tpu_torch.data.datamanager import MultiCamDataManager
from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene
from lsenerf_tpu_torch.engine.trainer import Trainer, tree_leaves
from lsenerf_tpu_torch.parallel import ddp


def make_trainer(case: dict, dp=None) -> Trainer:
    """The case's trainer (on the CPU) with its params and grid."""
    torch.set_num_threads(2)
    col, evs = make_synthetic_scene(**case["scene"])
    if case["dm"].rgb_frac >= 1.0:
        evs = None
    dm = MultiCamDataManager(case["dm"], col, evs)
    tr = Trainer(case["trainer"], case["model"], dm, device="cpu", dp=dp)
    p = case["params"]
    tr.setup(params=convert.params_from_numpy(p["model"], p["camera_opt"], hash_layout="blocked"),
             occ=convert.occ_state_from_numpy(*case["occ"]))
    return tr


def run_case(case: dict, dp=None, rank: int = 0, world: int = 1) -> dict:
    """One step on the rank's share (or an occupancy update): the loss, the
    params after the step (or the grid)."""
    tr = make_trainer(case, dp)
    if "cells" in case:
        ids, pos = (torch.from_numpy(np.asarray(a)) for a in case["cells"])
        tr.occ_update(ids, pos)
        return {"occs": tr.occ.occs.clone(), "binaries": tr.occ.binaries.clone()}
    batch = case["batch"]
    bg = torch.from_numpy(np.asarray(case["bg"]))
    sizes = tr.bundle_sizes(batch)
    m = tr.step(ddp.shard_batch(batch, rank, world), bg_color=ddp.shard_rays(bg, sizes, rank, world),
                update_occ=False)
    return {"loss": float(m["loss"]), "metrics": {k: float(v) for k, v in m.items()},
            "params": {k: v.detach().clone() for k, v in tree_leaves(tr.params)}}


def main(rank: int, world: int, port: int, cases: dict, out_dir: str) -> None:
    """A rank that joins its group as a torchrun-launched process does,
    from RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT (ddp.from_env)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dp = ddp.from_env("gloo")
    assert (dp.rank, dp.world_size) == (rank, world)
    try:
        out = {name: run_case(case, dp, rank, world) for name, case in cases.items()}
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        ddp.shutdown()
