"""The march (K3) and the composite (K5a/K5b) of the port on the CPU: their
wrappers run the plain versions for CPU tensors; composite_bwd_plain, the
composite's backward written out, equals autograd through the chain in f64
and JAX's gradient in f32; the wrappers refuse inputs their kernels do not
take; the supergrid is built once a grid state; the grad_overflow count
and its sentinel against JAX's; and a checkpoint in the format written
before the background had its own generator resumes. The kernels
themselves are held to the plain versions on the card
(tests/test_torch_kernels_card.py, chip_smoke.py phase 3d)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.cameras.rays import RaySamples as JSamples
from lsenerf_tpu.engine import loop as jloop
from lsenerf_tpu.engine import trainer as jtr
from lsenerf_tpu.ops import composite as jcomp
from lsenerf_tpu.ops import hash_encoding as jhe
from lsenerf_tpu_torch.cameras.rays import RaySamples as TSamples
from lsenerf_tpu_torch.engine import checkpoints as ckpt
from lsenerf_tpu_torch.engine import loop as tloop
from lsenerf_tpu_torch.engine.trainer import RunMode
from lsenerf_tpu_torch.ops import composite as tcomp
from lsenerf_tpu_torch.ops import hash_encoding as the
from lsenerf_tpu_torch.ops import march as tmarch
from lsenerf_tpu_torch.ops import occupancy as tocc

import torch_parity

TG = tocc.OccGridConfig(**torch_parity.GRID)
BASE = tmarch.MarchConfig(render_step_size=2 * 3**0.5 / 1000, max_samples=16,
                          max_candidates=256, proposal_samples=8)
MARCHES = {
    "packed": BASE,
    "unpacked": dataclasses.replace(BASE, packed_phase2=False),
    "flat": dataclasses.replace(BASE, hierarchical=False),
    "cone_0": dataclasses.replace(BASE, cone_angle=0.0),
    "no_proposal": dataclasses.replace(BASE, proposal_samples=0, max_samples=48),
}


def _rays(seed, n=200):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = (-o + rng.normal(0, 0.5, (n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8] = -d[:8]  # pointing away: some miss the aabb
    return torch.from_numpy(o), torch.from_numpy(d)


def _state(seed=0):
    occs, binaries = torch_parity.sparse_grid(seed=seed)
    return tocc.OccGridState(occs=torch.from_numpy(occs), binaries=torch.from_numpy(binaries))


@pytest.mark.parametrize("name", sorted(MARCHES))
def test_march_wrapper_on_cpu_is_the_plain_version(name):
    """K3's wrapper on CPU tensors gives the plain version's bits and
    launches nothing; with nears/fars too."""
    cfg = MARCHES[name]
    o, d = _rays(1)
    st = _state()
    nears = torch.full((o.shape[0],), 0.5)
    fars = torch.full((o.shape[0],), 4.0)
    before = tmarch.K3.launches
    for nf in ((None, None), (nears, fars)):
        got = tmarch.march_ts(o, d, *nf, st, TG, cfg)
        want = tmarch.march_ts_plain(o, d, *nf, st, TG, cfg)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        m = cfg.proposal_samples or cfg.max_samples
        assert got[0].shape == (o.shape[0], m) and got[2].dtype == torch.bool
    assert got[2].any() and not got[2].all()
    assert tmarch.K3.launches == before


def test_march_refuses_what_its_kernel_does_not_take():
    o, d = _rays(2, n=4)
    st = _state()
    sc = tmarch._scalars(TG, BASE)
    with pytest.raises(ValueError, match="CUDA"):
        tmarch._check(o, d, None, None, st, sc)
    with pytest.raises(ValueError, match="dtype"):
        tmarch._check(o.double(), d, None, None, st, sc)
    with pytest.raises(ValueError, match="shape"):
        tmarch._check(o, d[:3], None, None, st, sc)
    with pytest.raises(ValueError, match="nears"):
        tmarch._check(o, d, torch.zeros(4, 1), None, st, sc)
    with pytest.raises(ValueError, match="binaries"):
        tmarch._check(o, d, None, None, tocc.OccGridState(st.occs, st.binaries.float()), sc)
    # past the static layout's 64 slots and 64 rounds a config takes the
    # wide one, in shared memory, and past a block's shared memory in the
    # global workspace; a coarse_factor past 32 runs in the layout its
    # rounds fit (tests/test_torch_march_wide_segments.py compares results)
    assert tmarch._scalars(TG, BASE)["wide"] == tmarch.STATIC
    assert tmarch._scalars(TG, dataclasses.replace(BASE, max_samples=96))["wide"] == tmarch.SHARED
    assert tmarch._scalars(TG, dataclasses.replace(BASE, hierarchical=False,
                                                   max_candidates=4096))["wide"] == tmarch.SHARED
    assert tmarch._scalars(TG, dataclasses.replace(BASE, max_samples=20_000))["wide"] == tmarch.GLOBAL
    one = tocc.OccGridConfig(resolution=128, levels=1)
    sc = tmarch._scalars(one, dataclasses.replace(BASE, coarse_factor=64, max_candidates=4096))
    assert sc["hier"] and sc["cf"] == 64 and sc["wide"] == tmarch.STATIC


def test_supergrid_is_built_once_a_state():
    """OccGridState.super_binaries is build_super_binaries of its binaries,
    built once; the occupancy update and a restore make new states, whose
    supergrid follows their binaries."""
    jt, state, tt = torch_parity.trainers()
    first = tt.occ.super_binaries(8)
    assert torch.equal(first, tocc.build_super_binaries(tt.occ.binaries, 8))
    assert tt.occ.super_binaries(8) is first
    old = tt.occ
    tt.occ_update()
    assert tt.occ is not old and not torch.equal(tt.occ.binaries, old.binaries)
    assert torch.equal(tt.occ.super_binaries(8), tocc.build_super_binaries(tt.occ.binaries, 8))
    stale = tt.occ
    ckpt.restore_into_state(tt, {}, {"occs": old.occs, "binaries": old.binaries}, 0)
    assert tt.occ is not stale
    assert torch.equal(tt.occ.super_binaries(8), first)


# -- the composite ------------------------------------------------------------


def _samples(seed, n=64, k=16):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.01, 0.2, (n, k)).astype(np.float32)
    t_ends = np.cumsum(dt, 1).astype(np.float32)
    t_starts = (t_ends - dt).astype(np.float32)
    mask = rng.random((n, k)) < 0.8
    dens = rng.exponential(3.0, (n, k, 1)).astype(np.float32)
    dens[0, 3, 0] = np.inf  # a hardened surface
    dens[1, 2, 0] = np.inf
    mask[1, 2] = False  # a masked-out inf
    dens[2, :, 0] = 0.04  # culled at alpha_thre 0.01
    dens[3, :, 0] = 500.0  # opaque at once: early stop
    rgb = rng.random((n, k, 3)).astype(np.float32)
    cot = [rng.standard_normal(s).astype(np.float32) for s in ((n, 3), (n, 1), (n, 1))]
    bg = rng.random((n, 3)).astype(np.float32)
    return [t_starts, t_ends, mask, dens, rgb, bg] + cot


BACKGROUNDS = ["linear", "black", "white", "last_sample", "random"]
THRESHOLDS = {"none": 0.0, "float": 0.01, "tensor": "tensor"}


def _thre(kind, dtype=torch.float32):
    v = THRESHOLDS[kind]
    return torch.tensor(0.01, dtype=dtype) if v == "tensor" else v


@pytest.mark.parametrize("background", BACKGROUNDS)
@pytest.mark.parametrize("thre", sorted(THRESHOLDS))
def test_composite_bwd_plain_equals_autograd_in_f64(background, thre):
    """The backward written out equals autograd through the chain
    (composite_fwd_plain) in f64, with inf densities, culled samples and an
    early stop in the batch, for every background and both threshold
    forms."""
    ts, te, mask, dens, rgb, bg, g_rgb, g_d, g_a = (torch.from_numpy(a) for a in _samples(3))
    ts, te, dens, rgb, bg = (x.double() for x in (ts, te, dens, rgb, bg))
    g_rgb, g_d, g_a = (x.double() for x in (g_rgb, g_d, g_a))
    at = _thre(thre, torch.float64)
    bgc = bg if background == "random" else None
    d = dens.clone().requires_grad_(True)
    c = rgb.clone().requires_grad_(True)
    out = tcomp.composite_fwd_plain(d, c, ts, te, mask, at, 1e-4, bgc, background)
    sum((o * g).sum() for o, g in zip(out, (g_rgb, g_d, g_a))).backward()
    gd, gc = tcomp.composite_bwd_plain(dens, rgb, ts, te, mask, at, 1e-4, bgc, background,
                                       g_rgb, g_d, g_a)
    assert torch.isfinite(gd).all() and torch.isfinite(d.grad).all()
    np.testing.assert_allclose(gd.numpy(), d.grad.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(gc.numpy(), c.grad.numpy(), rtol=1e-9, atol=1e-12)
    # a cotangent that is None counts as zeros
    gd0, _ = tcomp.composite_bwd_plain(dens, rgb, ts, te, mask, at, 1e-4, bgc, background,
                                       g_rgb, None, torch.zeros_like(g_a))
    gd1, _ = tcomp.composite_bwd_plain(dens, rgb, ts, te, mask, at, 1e-4, bgc, background,
                                       g_rgb, torch.zeros_like(g_d), None)
    assert torch.equal(gd0, gd1)


@pytest.mark.parametrize("k", [16, 96])
@pytest.mark.parametrize("alpha_thre", [0.0, 0.01])
def test_composite_function_matches_jax_grad(alpha_thre, k):
    """`composite` (the autograd Function: composite_fwd_plain forward,
    composite_bwd_plain backward on the CPU) against jax.grad of the JAX
    chain, values and gradients, on the inf-density inputs of
    test_torch_field_composite.py with the random background, at 16 and
    96 samples a ray (K5a/K5b take any k, as JAX does)."""
    ts, te, mask, dens, rgb, bg, g_rgb, g_d, g_a = _samples(3, k=k)
    n, k = mask.shape
    z3 = np.zeros((n, k, 3), np.float32)

    def jf(d, c):
        s = JSamples(positions=z3, directions=z3, t_starts=jnp.asarray(ts),
                     t_ends=jnp.asarray(te), mask=jnp.asarray(mask))
        w = jcomp.render_weights(s, d, jnp.float32(alpha_thre) if alpha_thre else 0.0, 1e-4)
        acc = jcomp.render_accumulation(w)
        out = jcomp.accumulate(w, c) + jnp.asarray(bg) * (1.0 - acc)
        depth = jcomp.render_depth(w, s)
        return ((out * g_rgb).sum() + (depth * g_d).sum() + (acc * g_a).sum(), (out, depth, acc))

    (_, jout), (jgd, jgc) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(dens), jnp.asarray(rgb))
    d = torch.from_numpy(dens).requires_grad_(True)
    c = torch.from_numpy(rgb).requires_grad_(True)
    s = TSamples(positions=None, directions=None, t_starts=torch.from_numpy(ts),
                 t_ends=torch.from_numpy(te), mask=torch.from_numpy(mask))
    thre = torch.tensor(alpha_thre) if alpha_thre else 0.0
    out = tcomp.composite(d, c, s, thre, 1e-4, torch.from_numpy(bg), "random")
    sum((o * torch.from_numpy(g)).sum() for o, g in zip(out, (g_rgb, g_d, g_a))).backward()
    for o, j in zip(out, jout):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    assert np.isfinite(d.grad.numpy()).all()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jgd), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jgc), rtol=1e-5, atol=1e-7)


def test_composite_wrappers_on_cpu_are_the_plain_versions():
    ts, te, mask, dens, rgb, bg, g_rgb, g_d, g_a = (torch.from_numpy(a) for a in _samples(4))
    before = (tcomp.K5A.launches, tcomp.K5B.launches)
    args = (dens, rgb, ts, te, mask, torch.tensor(0.01), 1e-4, None, "last_sample")
    for got, want in zip(tcomp.composite_fwd(*args), tcomp.composite_fwd_plain(*args)):
        assert torch.equal(got, want)
    for got, want in zip(tcomp.composite_bwd(*args, g_rgb, g_d, g_a),
                         tcomp.composite_bwd_plain(*args, g_rgb, g_d, g_a)):
        assert torch.equal(got, want)
    assert (tcomp.K5A.launches, tcomp.K5B.launches) == before


def test_composite_refuses_what_its_kernels_do_not_take():
    ts, te, mask, dens, rgb, bg, g_rgb, g_d, g_a = (torch.from_numpy(a) for a in _samples(5))
    ok = dict(density=dens, rgb=rgb, t_starts=ts, t_ends=te, mask=mask, alpha_thre=0.01,
              early_stop_eps=1e-4, bg_color=bg, background="random")

    def check(match, **bad):
        with pytest.raises(ValueError, match=match):
            tcomp._checked(**dict(ok, **bad))

    check("CUDA")
    check("density", density=dens.double())
    check("rgb", rgb=rgb[:, :, :2])
    check("mask", mask=mask.float())
    check("bg_color", bg_color=bg[:3])
    check("alpha_thre", alpha_thre=torch.tensor([0.01]))
    check("g_depth", g_depth=g_d[:, 0])
    check("g_rgb", g_rgb=g_rgb[:, :2])
    check("random background needs", bg_color=None)
    check("must be contiguous", t_ends=te.t().contiguous().t())
    # no limit on the samples a ray: 96 of them fail only for the device
    big = torch.zeros(2, 96)
    check("CUDA", density=big[..., None], rgb=torch.zeros(2, 96, 3), t_starts=big, t_ends=big,
          mask=big.bool(), bg_color=torch.zeros(2, 3))


# -- grad_overflow --------------------------------------------------------------


OVERFLOW_CASES = {
    # about one point: every update of a hashed level in one of its 32
    # windows, far past the cap of 3 x the mean a window
    "clustered": (lambda rng: np.full((6000, 3), 0.37, np.float32) + rng.normal(
        0, 1e-4, (6000, 3)).astype(np.float32), dict(blocked_rows_log2=14)),
    "uniform": (lambda rng: rng.random((20000, 3)).astype(np.float32), {}),
    # too few updates to fill any window's cap
    "sparse": (lambda rng: rng.random((300, 3)).astype(np.float32), {}),
    "window_2_6": (lambda rng: np.full((6000, 3), 0.6, np.float32) + rng.normal(
        0, 1e-4, (6000, 3)).astype(np.float32), dict(level_lo=2, blocked_rows_log2=14)),
    "no_dense_grad": (lambda rng: rng.random((8000, 3)).astype(np.float32),
                      dict(dense_grad_rows=0)),
}


@pytest.mark.parametrize("case", sorted(OVERFLOW_CASES))
def test_blocked_overflow_count_equals_jax(case):
    """The port's grad_overflow count is JAX's integer, where it is
    nonzero and where it is 0, in and out of a level window."""
    make, over = OVERFLOW_CASES[case]
    pos = np.clip(make(np.random.default_rng(7)), 0.0, 1.0)
    # dense_grad_rows=64: with 2^10 rows a level the last three levels are
    # hashed and counted (JAX's default, 4096, makes every level exact)
    kw = dict(torch_parity.HASH, layout="blocked", dense_grad_rows=64)
    kw.update(over)
    jcfg = jhe.HashEncodingConfig(**kw)
    tcfg = the.HashEncodingConfig(**kw)
    want = int(jhe.blocked_overflow_count(jnp.asarray(pos), jcfg))
    got = the.blocked_overflow_count(torch.from_numpy(pos), tcfg)
    assert got.dtype == torch.int64 and int(got) == want
    if case in ("clustered", "window_2_6"):
        assert want > 0
    if case == "sparse":
        assert want == 0


def test_overflow_probe_and_telemetry_equal_jax():
    """Trainer.overflow_count (the sentinel's probe) equals JAX's
    make_overflow_probe on the same batch and state, and with
    grad_overflow_telemetry the step's grad_overflow metric equals JAX's."""
    jt, state, tt = torch_parity.trainers(model=dict(grad_overflow_telemetry=True))
    batch = jt.dm.next_train(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = int(jt.make_overflow_probe()(state.params, state.occ, jb, jnp.int32(0)))
    assert int(tt.overflow_count(batch)) == want
    rng = jax.random.PRNGKey(5)
    _, metrics = jt._build_loss_fn()(state.params, state.occ, jb, jnp.int32(0), rng)
    tb = tt.batch_to_device(batch)
    bg = torch.from_numpy(np.asarray(jax.random.uniform(rng, (tt.num_rays(tb), 3))))
    _, tmetrics, _ = tt.grads(tb, bg_color=bg)
    assert float(tmetrics["grad_overflow"]) == float(metrics["grad_overflow"])
    ngp = torch_parity.trainers(layout="ngp")[2]
    assert ngp.overflow_count(ngp.dm.next_train(0)) is None


def _jax_sentinel_steps(start, steps, every):
    """The steps after which JAX's run_training_loop runs the sentinel's
    probe, with a stub trainer."""
    fired = []

    @dataclasses.dataclass
    class State:
        step: int
        params: dict
        occ: object = None

        def replace(self, **kw):
            return dataclasses.replace(self, **kw)

    def probe(params, occ, batch, step):
        fired.append(int(step) - 1)
        return jnp.int32(3)

    trainer = types.SimpleNamespace(
        config=jtr.TrainerConfig(grad_overflow_every=every, steps_per_save=0,
                                 steps_per_eval_batch=0),
        model_config=types.SimpleNamespace(grid=types.SimpleNamespace(update_interval=1000)),
        dm=types.SimpleNamespace(next_train=lambda it: {}),
        _train_step=lambda s, b: (s.replace(step=s.step + 1), {"loss": jnp.float32(0.0)}),
        _occ_update=lambda s: s, make_overflow_probe=lambda: probe,
    )
    jloop.run_training_loop(trainer, State(step=start, params={}), num_steps=steps, scan_steps=1)
    return fired


@pytest.mark.parametrize("mode", [RunMode.TRAIN, RunMode.EVAL])
def test_overflow_sentinel_fires_on_jax_steps(mode):
    """The port's loop runs the probe after the same steps as JAX's loop
    (resumed at step 37, every 8), logs grad_overflow there and returns it
    with the last metrics; in an EVAL run, as in JAX, it never fires."""
    start, steps, every = 37, 30, 8
    want = _jax_sentinel_steps(start, steps, every) if mode == RunMode.TRAIN else []
    assert mode != RunMode.TRAIN or want == [39, 47, 55, 63]
    _, _, tt = torch_parity.trainers()
    tt.config = dataclasses.replace(tt.config, grad_overflow_every=every, mode=mode,
                                    steps_per_save=0, steps_per_eval_batch=0)
    tt.step_count = start
    fired, logged = [], []
    tt.step = lambda batch, bg_color=None, update_occ=True: (
        setattr(tt, "step_count", tt.step_count + 1), {"loss": torch.zeros(())})[1]
    tt.overflow_count = lambda batch: (fired.append(tt.step_count - 1), torch.tensor(3))[1]
    logger = types.SimpleNamespace(log=lambda it, scal: logged.append((it, dict(scal))))
    last = tloop.run_training_loop(tt, num_steps=steps, logger=logger)
    assert fired == want
    assert [it for it, s in logged if "grad_overflow" in s] == want
    assert ("grad_overflow" in last) == (start + steps - 1 in want)


# -- checkpoints -----------------------------------------------------------------


def test_checkpoint_with_one_generator_state_resumes(tmp_path):
    """A checkpoint as the port wrote it before the background had its own
    generator ("rng": one generator state tensor, which drew both the
    occupancy cells and the background) resumes: both generators continue
    from that state, and Adam's state and the step come back."""
    _, _, tt = torch_parity.trainers(model=dict(background_color="random"))
    for i in range(2):
        tt.step(tt.dm.next_train(i))
    payload = {
        "step": 1,
        "params": ckpt._cpu_tree(tt.params),
        "occ": {"occs": tt.occ.occs.cpu(), "binaries": tt.occ.binaries.cpu()},
        "opt": {"count": int(tt.opt_count), "adam": tt.adam_state()},
        "rng": tt._gen.get_state(),
    }
    d = tmp_path / "ckpts"
    d.mkdir()
    torch.save(payload, d / "step-000000001")
    other = torch_parity.trainers(model=dict(background_color="random"), dm_seed=3)[2]
    step, params, occ, opt, rng = ckpt.load_checkpoint_full(str(d))
    assert isinstance(rng, torch.Tensor)
    assert ckpt.restore_into_state(other, params, occ, step, opt=opt, rng=rng)
    assert other.step_count == 2 and other.opt_count == tt.opt_count
    assert torch.equal(other._gen.get_state(), payload["rng"])
    assert torch.equal(other._bg_gen.get_state(), payload["rng"])
    metrics = other.step(tt.dm.next_train(2))
    assert np.isfinite(float(metrics["loss"]))
