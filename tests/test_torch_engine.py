"""The port's engine against the JAX package's, on the CPU: the warmup
schedule, the run modes' frozen groups (one EVAL, PRETRAIN and RENDER step
each against JAX's), checkpoints with exact resume, and the training
loop's cadences on a resumed start."""

import dataclasses
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.engine import schedules as jsched
from lsenerf_tpu.engine import trainer as jtr
from lsenerf_tpu.models import embeddings as jemb
from lsenerf_tpu_torch import train as ttrain
from lsenerf_tpu_torch.data.datamanager import DataManagerConfig, MultiCamDataManager
from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene
from lsenerf_tpu_torch.engine import checkpoints as ckpt
from lsenerf_tpu_torch.engine import schedules as tsched
from lsenerf_tpu_torch.engine import trainer as ttr
from lsenerf_tpu_torch.engine.trainer import tree_leaves
from lsenerf_tpu_torch.models import field as tfield
from lsenerf_tpu_torch.models import lsenerf as tmodel
from lsenerf_tpu_torch.ops import hash_encoding as the
from lsenerf_tpu_torch.ops import occupancy as tocc

import torch_parity


@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_with_warmup_matches_jax(warmup):
    j = jsched.exponential_decay(1e-2, 1e-4, 6, warmup)
    t = tsched.exponential_decay(1e-2, 1e-4, 6, warmup)
    for step in range(8):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-7, err_msg=str(step))


def _flat(tree):
    return dict(tree_leaves(jax.tree.map(np.asarray, tree)))


def _set_mode(jt, state, tt, mode, param_eval=False):
    """Both trainers in `mode` (fresh optimizers), at step 1 (no occupancy
    update); with param_eval the eval-mode param embedding and the grafted
    test row, as an emb_eval run has them."""
    if param_eval:
        for t in (jt, tt):
            f = t.model_config.field
            emb = dataclasses.replace(f.embedding, eval_mode="param", is_eval=True)
            t.model_config = dataclasses.replace(t.model_config,
                                                 field=dataclasses.replace(f, embedding=emb))
        app = state.params["model"]["field"]["appearance"]
        app = jemb.init_test_params(app, jt.model_config.field.embedding)
        field = dict(state.params["model"]["field"], appearance=app)
        state = state.replace(params=dict(state.params, model=dict(state.params["model"], field=field)))
        ttrain.graft_test_embedding(tt)
        np.testing.assert_array_equal(
            tt.params["model"]["field"]["appearance"]["test_table"].detach().numpy(),
            np.asarray(app["test_table"]))
    jt.config.mode = mode
    jt._tx = jtr.build_optimizer(jt.config, state.params)
    jt._train_step = jt.make_train_step()
    state = state.replace(opt_state=jt._tx.init(state.params), step=jnp.int32(1))
    tt.config.mode = mode
    tt.rebuild_optimizer()
    tt.step_count = 1
    return state


@pytest.mark.parametrize("mode", [ttr.RunMode.EVAL, ttr.RunMode.PRETRAIN, ttr.RunMode.RENDER])
def test_run_mode_step_matches_jax(mode):
    """One step in each mode: the frozen leaves stay bit for bit (in both
    packages), the trained ones move as JAX's do (rtol 1e-3)."""
    pretrain = mode == ttr.RunMode.PRETRAIN
    jt, state, tt = torch_parity.trainers(model=dict(background_color="white"),
                                          emb="evs_emb" if pretrain else "global_emb")
    state = _set_mode(jt, state, tt, mode, param_eval=pretrain)
    before = {p: t.detach().clone() for p, t in tree_leaves(tt.params)}
    jbefore = _flat(state.params)
    batch = jt.dm.next_train(0)
    new, _ = jt._train_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    tt.step(tt.dm.next_train(0))
    jafter = _flat(new.params)
    moved = 0
    for p, t in tree_leaves(tt.params):
        t = t.detach()
        if ttr.trainable(mode, p):
            np.testing.assert_allclose(t.numpy(), jafter[p], rtol=1e-3, atol=1e-6, err_msg=p)
            moved += int(not torch.equal(t, before[p]))
        else:
            assert torch.equal(t, before[p]), p
            np.testing.assert_array_equal(jafter[p], jbefore[p], err_msg=p)
    assert moved == (0 if mode == ttr.RunMode.RENDER else moved) and (
        mode == ttr.RunMode.RENDER or moved > 0)
    if pretrain:
        assert [p for p, _ in tree_leaves(tt.params) if ttr.trainable(mode, p)] == [
            "model/field/appearance/test_table"]


def _tiny_trainer(seed=0, rgb_frac=1.0):
    """A small port trainer on a 16x16 scene with the occupancy update
    every 4 steps."""
    col, evs = make_synthetic_scene(n_cams=4, h=16, w=16, focal=20.0)
    dm = MultiCamDataManager(DataManagerConfig(train_num_rays_per_batch=64, rgb_frac=rgb_frac),
                             col, None if rgb_frac >= 1 else evs, seed=3)
    mcfg = tmodel.ModelConfig(
        field=tfield.FieldConfig(hash=the.HashEncodingConfig(num_levels=4, base_res=4, max_res=32,
                                                              layout="blocked", blocked_rows_log2=8)),
        grid=tocc.OccGridConfig(resolution=16, levels=1, update_interval=4),
        max_samples=16, max_candidates=64, hierarchical_march=False)
    tr = ttr.Trainer(ttr.TrainerConfig(seed=seed, col_cam_opt=ttr.CameraOptConfig(mode="SO3xR3")),
                     mcfg, dm, device="cpu")
    tr.setup()
    return tr


def test_exact_resume_is_bit_for_bit(tmp_path):
    """8 steps straight equal 4 steps, a save, a load into a trainer of
    another seed and 4 more, bit for bit: params, Adam moments and count,
    occupancy grid (updated at steps 0 and 4) and the generator; the
    random background's draws included. A --load-dir style restore keeps
    a fresh optimizer."""
    tr = _tiny_trainer()
    batches = [tr.dm.next_train(i) for i in range(8)]
    init = {p: t.detach().clone() for p, t in tree_leaves(tr.params)}
    for b in batches:
        tr.step(b)
    straight = tr

    half = _tiny_trainer()
    for p, t in tree_leaves(half.params):
        assert torch.equal(t, init[p])
    for b in batches[:4]:
        half.step(b)
    d = str(tmp_path / "ckpts")
    path = ckpt.save_checkpoint(d, 3, half)
    assert path.endswith("step-000000003") and ckpt.latest_step(d) == 3
    assert set(torch.load(path, weights_only=True)) == {"step", "params", "occ", "opt", "rng"}

    resumed = _tiny_trainer(seed=99)
    step, params, occ, opt, rng = ckpt.load_checkpoint_full(d)
    ckpt.restore_into_state(resumed, params, occ, step, opt=opt, rng=rng)
    assert resumed.step_count == 4 and resumed.opt_count == 4
    for b in batches[4:]:
        resumed.step(b)
    a, b = dict(tree_leaves(straight.params)), dict(tree_leaves(resumed.params))
    assert set(a) == set(b)
    for p in a:
        assert torch.equal(a[p], b[p]), p
    sa, sb = straight.adam_state(), resumed.adam_state()
    assert set(sa) == set(sb) and sa
    for p in sa:
        for k in sa[p]:
            assert torch.equal(sa[p][k], sb[p][k]), (p, k)
    assert torch.equal(straight.occ.occs, resumed.occ.occs)
    assert torch.equal(straight._gen.get_state(), resumed._gen.get_state())

    weights_only = _tiny_trainer(seed=5)
    step, params, occ = ckpt.load_checkpoint(d)
    ckpt.restore_into_state(weights_only, params, occ, step)
    assert weights_only.adam_state() == {} and weights_only.opt_count == 0
    assert weights_only.step_count == 4
    stripped = ckpt.load_checkpoint(d, strip_cameras=True)[1]
    assert float(stripped["camera_opt"]["col"]["pose_adjustment"].abs().max()) == 0.0


def test_restore_merges_only_the_fresh_trees_keys(tmp_path):
    """A checkpoint key the fresh tree lacks is dropped, a leaf of another
    shape keeps its init, and a fresh key the checkpoint lacks keeps its
    init (load_state_dict(strict=False))."""
    tr = _tiny_trainer()
    d = str(tmp_path / "c")
    ckpt.save_checkpoint(d, 0, tr)
    _, params, occ = ckpt.load_checkpoint(d)
    params["model"]["extra"] = torch.ones(3)
    params["model"]["field"]["base_mlp"]["w0"] = torch.ones(2, 2)
    del params["model"]["field"]["color_mlp"]
    other = _tiny_trainer(seed=7)
    fresh = {p: t.detach().clone() for p, t in tree_leaves(other.params)}
    ckpt.restore_into_state(other, params, occ, 0)
    for p, t in tree_leaves(other.params):
        want = fresh[p] if ("base_mlp/w0" in p or "color_mlp" in p) else dict(tree_leaves(tr.params))[p]
        assert torch.equal(t, want), p
    assert "extra" not in other.params["model"]


# -- the loop's cadences -------------------------------------------------------

CADENCE = dict(steps_per_save=7, steps_per_eval_batch=5, steps_per_eval_image=6,
               steps_per_eval_all_images=11)
START, STEPS = 37, 30


def _jax_loop_events(monkeypatch, scan_steps=1, loss=0.0, via_train=False, **loop_kwargs):
    """The absolute steps at which JAX's run_training_loop fires each
    cadence, with a stub trainer whose step (and k-step chunk, at
    scan_steps k) only counts and gives `loss`; `loop_kwargs` go to the
    loop (through JAX's Trainer.train with `via_train`)."""
    from lsenerf_tpu.engine import checkpoints as jckpt
    from lsenerf_tpu.engine import evaluation as jeval
    from lsenerf_tpu.engine import loop as jloop
    from lsenerf_tpu.engine import renderer as jren

    ev = {k: [] for k in ("occ", "eval_batch", "eval_image", "save", "eval_all")}
    cur = [None]

    @dataclasses.dataclass
    class State:
        step: int
        params: dict
        occ: object = None
        opt_state: object = None
        rng: object = None

        def replace(self, **kw):
            return dataclasses.replace(self, **kw)

    def train_step(state, batch):
        cur[0] = int(state.step)
        return state.replace(step=state.step + 1), {"loss": jnp.float32(loss)}

    def occ_update(state):
        ev["occ"].append(int(state.step))
        return state

    def make_train_step_multi(k):
        def train_steps(state, batches):
            cur[0] = int(state.step) + k - 1
            return state.replace(step=state.step + k), {"loss": jnp.float32(loss)}
        return train_steps

    trainer = types.SimpleNamespace(
        config=jtr.TrainerConfig(grad_overflow_every=0, **CADENCE),
        model_config=types.SimpleNamespace(grid=types.SimpleNamespace(update_interval=4)),
        dm=types.SimpleNamespace(next_train=lambda it: {}, next_train_stack=lambda it, k: {}),
        _train_step=train_step, _occ_update=occ_update, make_train_step_multi=make_train_step_multi,
        make_eval_batch_fn=lambda cams: lambda *a: (ev["eval_batch"].append(cur[0]), {})[1],
    )
    eval_ds = types.SimpleNamespace(
        cameras=types.SimpleNamespace(height=4, width=4), images=np.zeros((2, 4, 4, 3), np.float32),
        appearance_ids=np.zeros(2, np.int32), __len__=None)
    eval_ds = _Sized(eval_ds, 2)
    monkeypatch.setattr(jren, "render_image", lambda *a, **k: (
        ev["eval_image"].append(cur[0]), {"rgb": np.ones((4, 4, 3), np.float32)})[1])
    monkeypatch.setattr(jeval, "average_eval_metrics", lambda *a, **k: (
        ev["eval_all"].append(cur[0]), {})[1])
    monkeypatch.setattr(jckpt, "save_checkpoint", lambda d, step, *a, **k: ev["save"].append(step))
    run = functools.partial(jtr.Trainer.train, trainer) if via_train else functools.partial(
        jloop.run_training_loop, trainer)
    run(State(step=START, params={"model": {}}), num_steps=STEPS, eval_ds=eval_ds,
        ckpt_dir="unused", base_dir="unused", scan_steps=scan_steps, **loop_kwargs)
    return ev


class _Sized:
    def __init__(self, ns, n):
        self.__dict__.update(vars(ns))
        self._n = n

    def __len__(self):
        return self._n


def test_loop_cadences_fire_on_jax_steps(monkeypatch):
    """On a resumed start (step 37, 30 steps): the occupancy update, the
    eval batch, the eval image, the saves (the final one included) and the
    full eval fire at the same absolute steps as in JAX's loop."""
    from lsenerf_tpu_torch.engine import evaluation as teval
    from lsenerf_tpu_torch.engine import loop as tloop
    from lsenerf_tpu_torch.engine import renderer as tren

    want = _jax_loop_events(monkeypatch)
    ev = {k: [] for k in want}
    tr = _tiny_trainer()
    for k, v in CADENCE.items():
        setattr(tr.config, k, v)
    tr.step_count = START
    real_step = tr.step

    def step(batch, bg_color=None):
        ev["_cur"] = tr.step_count
        return real_step(batch, bg_color)

    tr.step = step
    tr.occ_update = lambda *a, **k: ev["occ"].append(tr.step_count)
    tr._loss_backward = lambda batch, *a, **k: (torch.zeros(()), {})
    tr.eval_batch = lambda *a: (ev["eval_batch"].append(ev["_cur"]), {})[1]
    monkeypatch.setattr(tren, "render_image", lambda *a, **k: (
        ev["eval_image"].append(ev["_cur"]), {"rgb": np.ones((16, 16, 3), np.float32)})[1])
    monkeypatch.setattr(teval, "average_eval_metrics", lambda *a, **k: (
        ev["eval_all"].append(ev["_cur"]), {})[1])
    monkeypatch.setattr(ckpt, "save_checkpoint", lambda d, step, *a, **k: ev["save"].append(step))
    eval_ds = tr.dm.col
    tloop.run_training_loop(tr, num_steps=STEPS, eval_ds=eval_ds, ckpt_dir="unused",
                            base_dir="unused")
    ev.pop("_cur")
    assert tr.step_count == START + STEPS
    assert ev == want
    assert want["occ"] == [40, 44, 48, 52, 56, 60, 64] and want["save"][-1] == START + STEPS - 1


@pytest.mark.parametrize("scan_steps", [4, 12, 16])
def test_loop_cadences_fire_on_jax_steps_in_chunks(monkeypatch, scan_steps):
    """At scan_steps k (chunks of k from the resumed start 37, the last one
    trimmed to single steps): the occupancy updates, eval batches, eval
    images, saves (the final one included) and full evals fire on the same
    absolute steps as in JAX's chunked loop, each after its chunk's last
    step; Trainer.make_train_step_multi runs the chunks (on the CPU, k
    eager steps) with no occupancy update inside them."""
    from lsenerf_tpu_torch.engine import evaluation as teval
    from lsenerf_tpu_torch.engine import loop as tloop
    from lsenerf_tpu_torch.engine import renderer as tren

    want = _jax_loop_events(monkeypatch, scan_steps)
    ev = {k: [] for k in want}
    tr = _tiny_trainer()
    for k, v in CADENCE.items():
        setattr(tr.config, k, v)
    tr.step_count = START
    real_step = tr.step
    seen = []

    def step(batch, bg_color=None, **kw):
        ev["_cur"] = tr.step_count
        seen.append((tr.step_count, kw.get("update_occ", True)))
        return real_step(batch, bg_color, **kw)

    tr.step = step
    tr.occ_update = lambda *a, **k: ev["occ"].append(tr.step_count)
    tr._loss_backward = lambda batch, *a, **k: (torch.zeros(()), {})
    tr.eval_batch = lambda *a: (ev["eval_batch"].append(ev["_cur"]), {})[1]
    monkeypatch.setattr(tren, "render_image", lambda *a, **k: (
        ev["eval_image"].append(ev["_cur"]), {"rgb": np.ones((16, 16, 3), np.float32)})[1])
    monkeypatch.setattr(teval, "average_eval_metrics", lambda *a, **k: (
        ev["eval_all"].append(ev["_cur"]), {})[1])
    monkeypatch.setattr(ckpt, "save_checkpoint", lambda d, step, *a, **k: ev["save"].append(step))
    tloop.run_training_loop(tr, num_steps=STEPS, eval_ds=tr.dm.col, ckpt_dir="unused",
                            base_dir="unused", scan_steps=scan_steps)
    ev.pop("_cur")
    assert tr.step_count == START + STEPS
    assert seen == [(s, False) for s in range(START, START + STEPS)]
    assert ev == want
    assert want["save"][-1] == START + STEPS - 1


# -- the loop's hooks: log_every, print_every, callback, fail_fast ------------


class _Logger:
    def __init__(self):
        self.logged = []

    def log(self, step, scalars):
        self.logged.append((step, dict(scalars)))


def _hooked_trainer(loss=0.0):
    """_tiny_trainer at the resumed start with CADENCE, its loss and
    backward (Trainer._loss_backward), the occupancy update and the evals
    stubbed, each step's loss `loss`."""
    tr = _tiny_trainer()
    for k, v in CADENCE.items():
        setattr(tr.config, k, v)
    tr.step_count = START
    tr.occ_update = lambda *a, **k: None
    tr._loss_backward = lambda batch, *a, **k: (torch.tensor(float(loss)), {})
    tr.eval_batch = lambda *a: {}
    return tr


def _stub_evals(monkeypatch):
    from lsenerf_tpu_torch.engine import evaluation as teval
    from lsenerf_tpu_torch.engine import renderer as tren

    monkeypatch.setattr(tren, "render_image",
                        lambda *a, **k: {"rgb": np.ones((16, 16, 3), np.float32)})
    monkeypatch.setattr(teval, "average_eval_metrics", lambda *a, **k: {})
    monkeypatch.setattr(ckpt, "save_checkpoint", lambda *a, **k: None)


def _run_port(tr, scan_steps, via_train=False, **loop_kwargs):
    from lsenerf_tpu_torch.engine import loop as tloop

    kw = dict(num_steps=STEPS, eval_ds=tr.dm.col, ckpt_dir="unused", base_dir="unused",
              scan_steps=scan_steps, **loop_kwargs)
    return tr.train(**kw) if via_train else tloop.run_training_loop(tr, **kw)


@pytest.mark.parametrize("scan_steps", [1, 16])
@pytest.mark.parametrize("log_every", [5, 50])
def test_loop_callback_fires_on_jax_steps(monkeypatch, scan_steps, log_every):
    """callback(step, scalars) fires on the steps of JAX's loop, at
    scan_steps 1 and in chunks of 16 (the last trimmed to single steps),
    with the logged scalars; of steps 37..66 log_every 50 covers step 50,
    which logs after step 50 at scan_steps 1 and after its chunk's last
    step, 52, at 16."""
    want = []
    _jax_loop_events(monkeypatch, scan_steps, log_every=log_every,
                     callback=lambda step, scal: want.append(step))
    _stub_evals(monkeypatch)
    tr = _hooked_trainer()
    got, logger = [], _Logger()
    _run_port(tr, scan_steps, log_every=log_every, logger=logger,
              callback=lambda step, scal: got.append((step, scal)))
    assert [s for s, _ in got] == want and tr.step_count == START + STEPS
    assert got == [(s, d) for s, d in logger.logged if "loss" in d]  # the evals log too
    assert all(d["loss"] == 0.0 for _, d in got)
    if log_every == 5:
        assert len(want) >= 2
    else:
        assert want == ([52] if scan_steps == 16 else [50])


@pytest.mark.parametrize("scan_steps", [1, 16])
def test_loop_prints_every_print_every(monkeypatch, capsys, scan_steps):
    """With a logger, the logged scalars are printed where print_every
    falls, as JAX's loop prints them."""
    jlog = _Logger()
    _jax_loop_events(monkeypatch, scan_steps, log_every=2, print_every=10, logger=jlog)
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    _stub_evals(monkeypatch)
    logger = _Logger()
    _run_port(_hooked_trainer(), scan_steps, log_every=2, print_every=10, logger=logger)
    got = [ln.split(":")[0] for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    assert got == [ln.split(":")[0] for ln in want] and len(got) >= 2
    assert ([s for s, d in logger.logged if "loss" in d]
            == [s for s, d in jlog.logged if "loss" in d])


@pytest.mark.parametrize("scan_steps", [1, 16])
def test_loop_fail_fast_both_ways(monkeypatch, scan_steps):
    """A non-finite loss stops the run at the first logged step with
    fail_fast (the default), as in JAX; with fail_fast=False it is logged
    and handed to the callback, and the run goes on to its end."""
    with pytest.raises(RuntimeError, match="non-finite loss"):
        _jax_loop_events(monkeypatch, scan_steps, loss=float("nan"), log_every=5)
    want = []
    _jax_loop_events(monkeypatch, scan_steps, loss=float("nan"), log_every=5, fail_fast=False,
                     callback=lambda step, scal: want.append(step))
    _stub_evals(monkeypatch)
    tr = _hooked_trainer(float("nan"))
    with pytest.raises(RuntimeError, match="non-finite loss"):
        _run_port(tr, scan_steps, log_every=5)
    tr, got = _hooked_trainer(float("nan")), []
    last = _run_port(tr, scan_steps, log_every=5, fail_fast=False,
                     callback=lambda step, scal: got.append((step, scal["loss"])))
    assert [s for s, _ in got] == want and tr.step_count == START + STEPS
    assert all(math.isnan(v) for _, v in got) and math.isnan(last["loss"])


@pytest.mark.parametrize("scan_steps", [1, 16])
def test_trainer_train_is_the_loop(monkeypatch, scan_steps):
    """Trainer.train(num_steps, log_every, callback, **loop_kwargs) runs the
    loop from the trainer's step and returns the last step's metrics; its
    callback fires where JAX's Trainer.train fires it."""
    want = []
    _jax_loop_events(monkeypatch, scan_steps, via_train=True, log_every=7,
                     callback=lambda step, scal: want.append(step))
    _stub_evals(monkeypatch)
    tr, got = _hooked_trainer(), []
    out = _run_port(tr, scan_steps, via_train=True, log_every=7,
                    callback=lambda step, scal: got.append(step))
    assert got == want and len(got) >= 2
    assert tr.step_count == START + STEPS and out["loss"] == 0.0

