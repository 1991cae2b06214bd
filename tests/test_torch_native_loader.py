"""The port's binding of the native C++ sampler and prefetcher
(lsenerf_tpu_torch/data/native_loader.py) against the JAX package's
(lsenerf_tpu/data/native_loader.py), mirroring tests/test_native_loader.py.
Both bind native/fastloader.cpp, so one seed gives the same arrays: every
test holds the port's output equal, array for array, to JAX's. The port
builds its own copy of the library under lsenerf_tpu_torch/_build/ (the
JAX package builds native/libfastloader.so)."""

import os.path as osp

import numpy as np
import pytest

from lsenerf_tpu.data import datamanager as jdm
from lsenerf_tpu.data import dataset as jds
from lsenerf_tpu.data import native_loader as jnl
from lsenerf_tpu.data import synthetic as jsyn
from lsenerf_tpu_torch.data import datamanager as tdm
from lsenerf_tpu_torch.data import dataset as tds
from lsenerf_tpu_torch.data import native_loader as tnl
from lsenerf_tpu_torch.data import synthetic as tsyn

SCENE = dict(n_cams=6, h=16, w=16, focal=20.0)


@pytest.fixture(autouse=True)
def jax_library():
    if not jnl.native_available():
        pytest.fail("the JAX package's native library did not build (g++ is needed)")


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
    else:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


def test_library_builds_under_the_port():
    path = tnl.build_library()
    assert path.parent == tnl.BUILD_DIR and path.exists()
    assert osp.samefile(tnl.SOURCE, osp.join(osp.dirname(jnl._LIB_PATH), "fastloader.cpp"))


@pytest.mark.parametrize("seed", [1, 7])
def test_sample_rgb_equals_jax(seed):
    imgs = (np.random.default_rng(0).uniform(size=(4, 8, 8, 3)) * 255).astype(np.uint8)
    idx, val = tnl.sample_rgb(imgs, seed=seed, n_rays=64)
    _same((idx, val), jnl.sample_rgb(imgs, seed=seed, n_rays=64))
    assert (idx[:, 0] < 4).all() and (idx[:, 1:] < 8).all()
    np.testing.assert_allclose(val, imgs[idx[:, 0], idx[:, 1], idx[:, 2]] / 255.0, atol=1e-6)


def test_sample_events_equals_jax():
    ev = np.random.default_rng(1).normal(size=(6, 8, 8, 1)).astype(np.float32)
    idx, val = tnl.sample_events(ev, seed=2, n_rays=64, img_limit=3, e_thresh=0.25)
    _same((idx, val), jnl.sample_events(ev, seed=2, n_rays=64, img_limit=3, e_thresh=0.25))
    assert (idx[:, 0] < 3).all()
    np.testing.assert_allclose(val, ev[idx[:, 0], idx[:, 1], idx[:, 2]] * 0.25, rtol=1e-6)


def test_prefetcher_equals_jax():
    imgs = (np.random.default_rng(0).uniform(size=(4, 8, 8, 3)) * 255).astype(np.uint8)
    ev = np.random.default_rng(1).normal(size=(3, 8, 8, 1)).astype(np.float32)
    t = tnl.NativePrefetcher(imgs, 32, ev, 16, 2, 0.25, seed=7)
    j = jnl.NativePrefetcher(imgs, 32, ev, 16, 2, 0.25, seed=7)
    try:
        batches = [t.next() for _ in range(3)]
        for b in batches:
            _same(b, j.next())
        assert not np.array_equal(batches[0]["col_indices"], batches[1]["col_indices"])
    finally:
        t.close()
        j.close()


def test_prefetcher_memmap_i16_equals_jax(tmp_path):
    """The int16 memmap and frame-map form reads only the sampled pages
    and gives JAX's batches."""
    raw = np.random.default_rng(3).integers(-7, 7, size=(10, 8, 8)).astype(np.int16)
    f = str(tmp_path / "eimgs.npy")
    np.save(f, raw)
    sel = np.asarray([1, 3, 4, 7, 8], np.int64)
    t = tnl.NativePrefetcher(None, 0, np.load(f, mmap_mode="r"), 16, len(sel), e_thresh=0.25,
                             seed=5, evs_sel=sel)
    j = jnl.NativePrefetcher(None, 0, np.load(f, mmap_mode="r"), 16, len(sel), e_thresh=0.25,
                             seed=5, evs_sel=sel)
    try:
        b = t.next()
        _same(b, j.next())
        i = b["evs_indices"]
        want = raw[sel[i[:, 0]], i[:, 1], i[:, 2], None].astype(np.float32) * 0.25
        np.testing.assert_allclose(b["evs_values"], want, rtol=1e-6)
        assert isinstance(t._evs, np.memmap)
    finally:
        t.close()
        j.close()


def _lazy_events(lib_ds, evs, tmp_path, name):
    """The event dataset again over an int16 memmap of its frames."""
    raw = np.asarray(evs.eimgs)[..., 0].astype(np.int16)
    f = str(tmp_path / f"{name}.npy")
    np.save(f, raw)
    lazy = lib_ds.LazyFrameArray(np.load(f, mmap_mode="r"), np.arange(len(raw)))
    return lib_ds.EventFrameDataset(eimgs=lazy, cameras=evs.cameras, e_thresh=evs.e_thresh,
                                    appearance_ids=evs.appearance_ids)


@pytest.mark.parametrize("events", ["eager", "memmap"])
@pytest.mark.parametrize("rgb_frac,mode", [(0.5, "mse"), (0.66, "deblur")])
def test_datamanager_native_batches_equal_jax(events, rgb_frac, mode, tmp_path):
    """MultiCamDataManager with use_native gives JAX's batches (keys,
    dtypes, values) over an eager or a memmapped event stack, under the
    mse and the deblur budgets, and keeps the memmap."""
    jcol, jevs = jsyn.make_synthetic_scene(**SCENE)
    tcol, tevs = tsyn.make_synthetic_scene(**SCENE)
    if events == "memmap":
        jevs = _lazy_events(jds, jevs, tmp_path, "j")
        tevs = _lazy_events(tds, tevs, tmp_path, "t")
    cfg = dict(train_num_rays_per_batch=64, rgb_frac=rgb_frac, rgb_loss_mode=mode, use_native=True)
    j = jdm.MultiCamDataManager(jdm.DataManagerConfig(**cfg), jcol, jevs, seed=4)
    t = tdm.MultiCamDataManager(tdm.DataManagerConfig(**cfg), tcol, tevs, seed=4)
    assert j.native is not None and t.native is not None
    if events == "memmap":
        assert isinstance(t.native._evs, np.memmap)
    for step in range(3):
        _same(t.next_train(step), j.next_train(step))


def test_datamanager_native_splits_the_budget_over_ranks():
    """num_hosts = 2 (a rank of two): the prefetcher samples half of each
    budget, as JAX's does for a host of two."""
    tcol, tevs = tsyn.make_synthetic_scene(**SCENE)
    jcol, jevs = jsyn.make_synthetic_scene(**SCENE)
    cfg = dict(train_num_rays_per_batch=64, rgb_frac=0.5, use_native=True, num_hosts=2)
    t = tdm.MultiCamDataManager(tdm.DataManagerConfig(**cfg), tcol, tevs, seed=9).next_train(0)
    j = jdm.MultiCamDataManager(jdm.DataManagerConfig(**cfg), jcol, jevs, seed=9).next_train(0)
    _same(t, j)
    assert len(t["col_indices"]) == 16 and len(t["evs_indices"]) == 8


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """No silent fallback: with no library built and no g++, use_native
    raises where JAX would sample with numpy."""
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(tnl.shutil, "which", lambda name: None)
    tnl.get_library.cache_clear()
    try:
        tcol, tevs = tsyn.make_synthetic_scene(**SCENE)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            tdm.MultiCamDataManager(tdm.DataManagerConfig(train_num_rays_per_batch=64,
                                                          use_native=True), tcol, tevs)
    finally:
        tnl.get_library.cache_clear()
