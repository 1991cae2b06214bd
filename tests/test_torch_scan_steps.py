"""scan_steps, k train steps a call (lsenerf_tpu_torch/engine/trainer.py
make_train_step_multi, engine/chunk_graph.py, data/datamanager.py
next_train_stack), on the CPU against the JAX package and against k eager
steps:
  - next_train_stack equals JAX's for the same seed and k, bit for bit;
  - make_train_step_multi(3) equals three Trainer.step calls bit for bit,
    and so does ChunkGraph's body (what the card captures, here run
    eagerly: the staged batches, the lr table and the camera gates as
    device values), over a chunk in which a delayed camera gate switches
    on and an lr schedule that moves;
  - that body makes no host sync and no copy from host data: the ops that
    would end a CUDA-graph capture (a scalar read, nonzero, a tensor made
    from host data) are listed by a dispatch mode on the CPU;
  - make_train_step_multi(2) against JAX's on the same converted params
    and batches: the last step's loss and metrics within rtol 1e-4 (f32
    sums in other orders over two steps), the params within rtol 1e-3 /
    atol 1e-6 (the one-step gradient tolerance: Adam's eps of 1e-15 turns
    rounding noise into steps of up to lr);
  - the CLI at --machine.scan-steps 4 writes the checkpoint that
    --machine.scan-steps 1 writes, bit for bit."""

import os
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lsenerf_tpu.data import datamanager as jdm
from lsenerf_tpu.data import synthetic as jsyn
from lsenerf_tpu_torch.data import datamanager as tdm
from lsenerf_tpu_torch.data import synthetic as tsyn
from lsenerf_tpu_torch.data.synthetic import write_reference_scene
from lsenerf_tpu_torch.engine import trainer as ttr
from lsenerf_tpu_torch.engine.chunk_graph import ChunkGraph
from lsenerf_tpu_torch.engine.trainer import tree_leaves
from lsenerf_tpu_torch.models import field as tfield
from lsenerf_tpu_torch.models import lsenerf as tmodel
from lsenerf_tpu_torch.ops import hash_encoding as the
from lsenerf_tpu_torch.ops import occupancy as tocc

import torch_parity
from test_torch_cli import TINY_MODEL
from test_torch_config import ROOT, train_argv


@pytest.mark.parametrize("rgb_loss_mode", ["mse", "deblur"])
def test_next_train_stack_matches_jax(rgb_loss_mode):
    cfg = dict(train_num_rays_per_batch=96, rgb_frac=0.66, rgb_loss_mode=rgb_loss_mode)
    jcol, jevs = jsyn.make_synthetic_scene(**torch_parity.SCENE)
    tcol, tevs = tsyn.make_synthetic_scene(**torch_parity.SCENE)
    jd = jdm.MultiCamDataManager(jdm.DataManagerConfig(**cfg), jcol, jevs, seed=7)
    td = tdm.MultiCamDataManager(tdm.DataManagerConfig(**cfg), tcol, tevs, seed=7)
    for step, k in ((0, 4), (4, 3)):
        j, t = jd.next_train_stack(step, k), td.next_train_stack(step, k)
        assert set(j) == set(t)
        for key in j:
            assert t[key].shape[0] == k and t[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)


def _trainer(delay=4):
    """A small port trainer: RGB and events, SO3xR3 deltas on both cameras,
    the RGB ones delayed (on from step delay + 1), a random background,
    the occupancy update every 4 steps and an lr that decays over 10."""
    col, evs = tsyn.make_synthetic_scene(n_cams=4, h=16, w=16, focal=20.0)
    dm = tdm.MultiCamDataManager(tdm.DataManagerConfig(train_num_rays_per_batch=64), col, evs,
                                 seed=3)
    mcfg = tmodel.ModelConfig(
        field=tfield.FieldConfig(hash=the.HashEncodingConfig(num_levels=4, base_res=4, max_res=32,
                                                              layout="blocked", blocked_rows_log2=8)),
        grid=tocc.OccGridConfig(resolution=16, levels=1, update_interval=4),
        max_samples=16, max_candidates=64, hierarchical_march=False)
    cfg = ttr.TrainerConfig(
        col_cam_opt=ttr.CameraOptConfig(mode="SO3xR3", scheme="delayed", delay_cnt=delay),
        evs_cam_opt=ttr.CameraOptConfig(mode="SO3xR3"),
        fields_optimizer=ttr.OptimizerGroupConfig(lr=1e-2, lr_final=1e-3, max_steps=10))
    tr = ttr.Trainer(cfg, mcfg, dm, device="cpu")
    tr.setup()
    return tr


def _state(tr) -> dict:
    """Everything a chunk moves: params, Adam's moments and counts, the
    step and update counts and both generators."""
    return dict(params={p: t.detach().clone() for p, t in tree_leaves(tr.params)},
                adam=tr.adam_state(), counts=(tr.step_count, tr.opt_count),
                occ=tr.occ.occs.clone(), rng=(tr._gen.get_state(), tr._bg_gen.get_state()))


def _assert_same(a: dict, b: dict):
    assert a["counts"] == b["counts"]
    assert all(torch.equal(x, y) for x, y in zip(a["rng"], b["rng"]))
    assert torch.equal(a["occ"], b["occ"])
    assert set(a["params"]) == set(b["params"])
    for p in a["params"]:
        assert torch.equal(a["params"][p], b["params"][p]), p
    assert set(a["adam"]) == set(b["adam"]) and a["adam"]
    for p in a["adam"]:
        for k in a["adam"][p]:
            assert torch.equal(a["adam"][p][k], b["adam"][p][k]), (p, k)


def _same_metrics(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k].reshape(()), b[k].reshape(())), k


K, CHUNKS = 3, 2


def _chunk_run(tr, stacked, run):
    """CHUNKS chunks of K steps through run(tr, chunk), with the occupancy
    update before each chunk that covers a multiple of its interval, as
    the training loop runs them."""
    from lsenerf_tpu_torch.engine.loop import _covered

    out = None
    for c in range(CHUNKS):
        if _covered(c * K, tr.model_config.grid.update_interval, K):
            tr.occ_update()
        out = run(tr, {key: v[c * K:(c + 1) * K] for key, v in stacked.items()})
    return out


def test_chunks_equal_eager_steps_bit_for_bit():
    """Steps 0-5 (the RGB gate switches on at step 5, inside the second
    chunk; the lr moves every step): eager steps, make_train_step_multi(3)
    and ChunkGraph's body give the same bits."""
    eager, multi, body = _trainer(), _trainer(), _trainer()
    stacked = eager.dm.next_train_stack(0, K * CHUNKS)
    for t in (multi, body):
        t.dm.next_train_stack(0, K * CHUNKS)
    assert eager.step_count == 0 and [ttr.pose_opt.activation_gate(s, "delayed", 4)
                                      for s in range(6)] == [0, 0, 0, 0, 0, 1]

    def eager_chunk(tr, st):
        out = [tr.step({key: v[j] for key, v in st.items()}, update_occ=False) for j in range(K)]
        return out[-1], torch.stack([m["loss"] for m in out])

    m_eager, l_eager = _chunk_run(eager, stacked, eager_chunk)
    fn = multi.make_train_step_multi(K)
    m_multi = _chunk_run(multi, stacked, lambda tr, st: fn(st))
    _same_metrics(m_eager, m_multi)
    assert torch.equal(multi.chunk_losses, l_eager)
    _assert_same(_state(eager), _state(multi))

    graphs = {}

    def body_chunk(tr, st):
        cg = graphs.setdefault("cg", ChunkGraph(tr, K, st))
        cg.load(st)
        cg.refresh_occ()
        cg.body()
        tr.step_count += K
        tr.opt_count += K
        n = len(cg.names)
        return {name: cg.out[i] for i, name in enumerate(cg.names)}, cg.out[n:]

    m_body, l_body = _chunk_run(body, stacked, body_chunk)
    _same_metrics(m_eager, m_body)
    assert torch.equal(l_body, l_eager)
    _assert_same(_state(eager), _state(body))
    # the graph's grid is its own copy; the trainer's states stay as they were
    assert graphs["cg"].occ is not body.occ and torch.equal(graphs["cg"].occ.occs, body.occ.occs)


# ops that end a CUDA-graph capture, or make a capture read stale host data
SYNCS = {"_local_scalar_dense", "item", "nonzero", "unique", "_unique", "_unique2",
         "unique_consecutive", "unique_dim", "masked_select", "lift_fresh", "lift_fresh_copy",
         "_linalg_check_errors", "bincount", "histc"}


class _HostSyncs(TorchDispatchMode):
    """Lists the SYNCS ops dispatched while `on`, and boolean-mask indexing
    (its output size is read on the host)."""

    def __init__(self):
        super().__init__()
        self.on, self.seen = True, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        bool_index = name in ("index", "index_put", "index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] if len(args) > 1 and isinstance(args[1], (list, tuple)) else ()))
        if self.on and (name in SYNCS or bool_index):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def test_chunk_body_makes_no_host_sync(monkeypatch):
    """ChunkGraph's body, what the card captures, dispatches none of SYNCS
    outside the kernels' plain versions (the card runs the kernels) and
    Adam's step (capturable on the card: its counts stay on the device).
    The flagship's branches (torch_parity: co_map, the hierarchical march,
    the proposal), the production's spline with deblur x4, and
    lsenerf_emb's per-frame embedding."""
    from lsenerf_tpu_torch.ops import combine, composite, march, ngp

    mode = _HostSyncs()

    def quiet(fn):
        def wrapped(*a, **kw):
            was, mode.on = mode.on, False
            try:
                return fn(*a, **kw)
            finally:
                mode.on = was
        return wrapped

    for mod, name in ((combine, "encode_fwd_plain"), (combine, "encode_bwd_plain"),
                      (ngp, "encode_fwd_plain"), (ngp, "encode_bwd_plain"),
                      (march, "march_ts_plain"), (composite, "composite_fwd_plain"),
                      (composite, "composite_bwd_plain")):
        monkeypatch.setattr(mod, name, quiet(getattr(mod, name)))
    monkeypatch.setattr(torch.optim.Adam, "step", quiet(torch.optim.Adam.step))

    spline = dict(mode="SO3xR3", optim_type="spline")
    for kw in (dict(), dict(col_cam=spline, deblur=True), dict(emb="evs_emb")):
        _, _, tr = torch_parity.trainers(**kw)
        stacked = tr.dm.next_train_stack(0, 2)
        cg = ChunkGraph(tr, 2, stacked)
        cg.load(stacked)
        cg.refresh_occ()
        cg.body()  # the warm-up: caches built
        cg.load(stacked)
        with mode:
            cg.body()
        assert mode.seen == [], (kw, mode.seen)


def test_chunk_matches_jax_make_train_step_multi():
    """Two steps in one chunk from the same converted params, grid and
    batches (a white background: no random draws), against JAX's
    make_train_step_multi(2) (a lax.scan; the Pallas combine in interpret
    mode)."""
    jt, state, tt = torch_parity.trainers(model=dict(background_color="white"))
    stacked = jt.dm.next_train_stack(0, 2)
    tstacked = tt.dm.next_train_stack(0, 2)
    for key in stacked:
        np.testing.assert_array_equal(tstacked[key], stacked[key])
    before = dict(tree_leaves(jax.tree.map(np.array, state.params)))  # the call donates state
    jstate, jm = jt.make_train_step_multi(2)(state, {k: jnp.asarray(v) for k, v in stacked.items()})
    tm = tt.make_train_step_multi(2)(tstacked)
    assert int(jstate.step) == tt.step_count == 2 and tt.opt_count == 2
    for k in ("loss", "rgb_loss", "event_loss", "psnr", "num_samples_per_ray"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    jp = dict(tree_leaves(jax.tree.map(np.asarray, jstate.params)))
    moved = 0
    for p, t in tree_leaves(tt.params):
        np.testing.assert_allclose(t.detach().numpy(), jp[p], rtol=1e-3, atol=1e-6, err_msg=p)
        moved += int(np.abs(jp[p] - before[p]).max() > 0)
    assert moved > 0


def _cli(argv, cwd):
    out = subprocess.run([sys.executable, "-m", "lsenerf_tpu_torch.train"] + argv + ["--device", "cpu"],
                         cwd=cwd, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    run = [line.split("run dir: ", 1)[1] for line in out.stdout.splitlines() if "run dir: " in line]
    return osp.join(cwd, run[0])


def test_cli_scan_steps_4_writes_the_scan_steps_1_checkpoint(tmp_path):
    """22 steps of train_lse_data.sh's lsenerf run at the tiny width: at
    --machine.scan-steps 4 (five chunks, the occupancy update before the
    chunks at 0 and 16, two single steps after) the final checkpoint's
    params, Adam state, grid and generators equal those of
    --machine.scan-steps 1, bit for bit."""
    data = str(tmp_path / "scene")
    write_reference_scene(data, n_cams=8, h=16, w=16, focal=20.0, n_val=2, with_prevnext=True,
                          with_msk=True, with_full_camera=True, texture_freq=3.0)
    n = 22
    argv = train_argv("lsenerf", data) + [
        "--max-num-iterations", str(n), "--steps-per-save", "1000", "--steps-per-eval-batch", "1000",
        "--steps-per-eval-image", "1000", "--steps-per-eval-all-images", "1000"] + TINY_MODEL
    got = {}
    for k in (4, 1):
        run = _cli(argv + ["--output-dir", str(tmp_path / f"scan{k}"), "--machine.scan-steps", str(k)],
                   str(tmp_path))
        got[k] = torch.load(osp.join(run, "checkpoints", f"step-{n - 1:09d}"), weights_only=True)

    def flat(x, prefix=""):
        if isinstance(x, dict):
            out = {}
            for key, v in x.items():
                out.update(flat(v, f"{prefix}/{key}"))
            return out
        return {prefix: x}

    a, b = flat(got[4]), flat(got[1])
    assert set(a) == set(b)
    assert got[4]["opt"]["adam"] and "bg" in got[4]["rng"]
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert torch.equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key
