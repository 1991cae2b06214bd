"""Data parallelism in the port (lsenerf_tpu_torch/parallel/ddp.py): two
gloo ranks on the CPU, spawned once for the fixed-batch cases and once for
the CLI, against the port's single-process step and JAX's step on a
2-device mesh (conftest.py's 8 CPU devices), mirroring
tests/test_parallel.py and tests/test_multihost.py. Tolerances are JAX's
own for its mesh step: loss rel 1e-5, params rtol 2e-5 / atol 2e-6.

Each case is tests/torch_parity.py's small configuration with JAX's params
carried across, one step on a fixed global batch of 64 RGB + 2 x 16 event
rays with a fixed background, each rank on its half (tests/torch_dp_worker.py,
whose ranks join their group from torchrun's environment variables):
log_loss, and enerf_norm_loss, whose norms over the batch the ranks sum
through an autograd-aware all-reduce. The sharded occupancy update must
give both ranks the same grid bit for bit."""

import os
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from lsenerf_tpu.parallel import mesh as mesh_lib
from lsenerf_tpu_torch import train
from lsenerf_tpu_torch.data.synthetic import write_reference_scene
from lsenerf_tpu_torch.engine.trainer import tree_leaves
from lsenerf_tpu_torch.ops import occupancy as tocc
from lsenerf_tpu_torch.parallel import ddp

import torch_dp_worker
import torch_parity
from test_torch_cli import TINY_MODEL
from test_torch_config import train_argv

WORLD = 2
LOSSES = {"log_loss": None, "enerf_norm_loss": dict(event_loss_type="enerf_norm_loss")}


def _step_case(model):
    """(worker case, JAX mesh step's (loss, params), port single-process
    step's result)."""
    jt, state, tt = torch_parity.trainers(model=model)
    batch = jt.dm.next_train(0)
    assert len(batch["col_indices"]) == 64 and len(batch["evs_indices"]) == 16
    n = tt.num_rays(batch)
    bg = np.asarray(jax.random.uniform(jax.random.split(state.rng)[1], (n, 3)))  # the step's draw
    p = jax.tree.map(np.asarray, state.params)
    case = dict(scene=torch_parity.SCENE, dm=tt.dm.config, trainer=tt.config, model=tt.model_config,
                params=p, occ=(np.asarray(state.occ.occs), np.asarray(state.occ.binaries)),
                batch=batch, bg=bg)
    single = torch_dp_worker.run_case(case)

    mesh = mesh_lib.make_mesh(WORLD)
    try:
        new, metrics = jt.make_train_step()(mesh_lib.replicate(state, mesh),
                                            mesh_lib.shard_batch(batch, mesh))
        jax_out = (float(metrics["loss"]), dict(tree_leaves(jax.tree.map(np.asarray, new.params))))
    finally:
        mesh_lib.deactivate()
    return case, jax_out, single


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both loss cases and an occupancy update, on two spawned gloo ranks;
    their results per rank, JAX's and the single process's."""
    cases, jax_out, single = {}, {}, {}
    for name, model in LOSSES.items():
        cases[name], jax_out[name], single[name] = _step_case(model)
    occ_case = dict(cases["log_loss"])
    del occ_case["batch"], occ_case["bg"]
    gcfg = occ_case["model"].grid
    ids, pos = tocc.sample_update_positions(torch.Generator().manual_seed(7), gcfg,
                                            tocc.num_update_cells(gcfg))
    occ_case["cells"] = (ids.numpy(), pos.numpy())
    cases["occ"] = occ_case
    single["occ"] = torch_dp_worker.run_case(occ_case)
    out = tmp_path_factory.mktemp("dp")
    ddp.spawn(torch_dp_worker.main, WORLD, (WORLD, ddp.free_port(), cases, str(out)))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]
    return ranks, jax_out, single


def _params_close(got: dict, want: dict, what: str):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float32), np.asarray(v, np.float32),
                                   rtol=2e-5, atol=2e-6, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("loss", list(LOSSES))
def test_dp_step_matches_single_process(runs, loss):
    ranks, _, single = runs
    for r in ranks:
        assert r[loss]["loss"] == pytest.approx(single[loss]["loss"], rel=1e-5)
        _params_close(r[loss]["params"], single[loss]["params"], "single process")
    # the all-reduced gradients and Adam leave the ranks' params equal
    for k, v in ranks[0][loss]["params"].items():
        assert torch.equal(v, ranks[1][loss]["params"][k]), k
    assert ranks[0][loss]["metrics"] == ranks[1][loss]["metrics"]


@pytest.mark.parametrize("loss", list(LOSSES))
def test_dp_step_matches_jax_mesh_step(runs, loss):
    ranks, jax_out, _ = runs
    jloss, jparams = jax_out[loss]
    assert ranks[0][loss]["loss"] == pytest.approx(jloss, rel=1e-5)
    _params_close(ranks[0][loss]["params"], jparams, "JAX mesh step")


def test_sharded_occupancy_update(runs):
    """Each rank evaluates half the cells; the MAX all-reduce gives both
    the same grid, bit for bit, and the single process's."""
    ranks, _, single = runs
    a, b = ranks[0]["occ"], ranks[1]["occ"]
    assert torch.equal(a["occs"], b["occs"]) and torch.equal(a["binaries"], b["binaries"])
    np.testing.assert_allclose(a["occs"].numpy(), single["occ"]["occs"].numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(a["binaries"], single["occ"]["binaries"])


def test_round_rays_and_rank_sampling():
    """The global budgets round down to the ranks and each rank samples its
    half with its own seed, as JAX's round_rays_to_mesh / per-host seeds."""
    from lsenerf_tpu_torch.data.datamanager import DataManagerConfig, MultiCamDataManager
    from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene

    cfg = ddp.round_rays(DataManagerConfig(train_num_rays_per_batch=101, rgb_frac=0.66), WORLD)
    assert (cfg.train_num_col_rays_per_batch, cfg.train_num_evs_rays_per_batch) == (66, 16)
    col, evs = make_synthetic_scene(**torch_parity.SCENE)
    b = [MultiCamDataManager(cfg, col, evs, seed=3 + r).next_train(0) for r in range(WORLD)]
    assert [len(x["col_indices"]) for x in b] == [33, 33]
    assert [len(x["evs_indices"]) for x in b] == [8, 8]
    assert not np.array_equal(b[0]["col_indices"], b[1]["col_indices"])
    big = {"a": np.arange(8), "b": np.arange(16).reshape(8, 2)}
    halves = [ddp.shard_batch(big, r, WORLD) for r in range(WORLD)]
    np.testing.assert_array_equal(np.concatenate([h["b"] for h in halves]), big["b"])
    x = torch.arange(12)
    assert ddp.shard_rays(x, [8, 2, 2], 1, WORLD).tolist() == [4, 5, 6, 7, 9, 11]


def test_cli_two_ranks(tmp_path):
    """--machine.num-devices 2 on the CPU: two gloo ranks train, rank 0
    writes the run dir, the checkpoint (with both ranks' background
    generators) and the eval; a resume from it on two ranks runs on."""
    data = str(tmp_path / "scene")
    write_reference_scene(data, n_cams=8, h=16, w=16, focal=20.0, n_val=2, with_prevnext=True,
                          with_full_camera=True, texture_freq=3.0)
    argv = train_argv("lsenerf", data) + [
        "--max-num-iterations", "6", "--steps-per-save", "3", "--steps-per-eval-batch", "3",
        "--steps-per-eval-image", "3", "--steps-per-eval-all-images", "6",
        "--output-dir", str(tmp_path / "out"), "--machine.num-devices", "2",
        # chunks of 3 steps end on the cadence's own steps
        "--machine.scan-steps", "3"] + TINY_MODEL
    run = train.main(argv + ["--device", "cpu"])
    assert sorted(os.listdir(osp.join(run, "checkpoints"))) == ["step-000000002", "step-000000005"]
    assert osp.exists(osp.join(run, "eval_mean.json"))
    ckpt = torch.load(osp.join(run, "checkpoints", "step-000000005"), weights_only=True)
    bg = ckpt["rng"]["bg"]
    assert bg.shape[0] == 2 and not torch.equal(bg[0], bg[1])
    run2 = train.main(argv + ["--load-checkpoint", osp.join(run, "checkpoints", "step-000000005"),
                              "--max-num-iterations", "3", "--device", "cpu"])
    assert "step-000000008" in os.listdir(osp.join(run2, "checkpoints"))
