"""The port's scene parser, reference-scene writer, PNG codec and lens
undistort against the JAX package's, on the CPU.

Both packages write the reference scene (6 cameras at 16x16, prev/next
event cameras, masks, the full camera trajectory); each package's parser
reads both scenes, and every output must agree: cameras (poses to atol
1e-6, the rest exactly), images, event frames, masks, appearance ids,
dM, color_train_ts and all_color_cameras.
"""

import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

from lsenerf_tpu.cameras import cameras as jcams
from lsenerf_tpu.data import parser as jparser
from lsenerf_tpu.data import synthetic as jsyn
from lsenerf_tpu_torch.cameras import cameras as tcams
from lsenerf_tpu_torch.data import dataset as tds
from lsenerf_tpu_torch.data import imageio
from lsenerf_tpu_torch.data import parser as tparser
from lsenerf_tpu_torch.data import synthetic as tsyn

SCENE = dict(n_cams=6, h=16, w=16, focal=20.0, n_val=2, with_prevnext=True, with_msk=True,
             with_full_camera=True, texture_freq=3.0)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    j = jsyn.write_reference_scene(str(root / "jax"), **SCENE)
    t = tsyn.write_reference_scene(str(root / "port"), **SCENE)
    return {"jax": j, "port": t}


def _np(x):
    return None if x is None else np.asarray(x)


def _same_cameras(a, b, atol=1e-6):
    np.testing.assert_allclose(_np(a.camera_to_worlds), _np(b.camera_to_worlds), rtol=0, atol=atol)
    for f in ("fx", "fy", "cx", "cy", "width", "height"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("times", "distortion_params"):
        va, vb = _np(getattr(a, f)), _np(getattr(b, f))
        assert (va is None) == (vb is None), f
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=f)


def _same_color(j, t):
    np.testing.assert_array_equal(j.images, t.images)
    np.testing.assert_array_equal(j.appearance_ids, t.appearance_ids)
    np.testing.assert_array_equal(_np(j.msk), _np(t.msk))
    assert j.data_idxs == t.data_idxs
    assert (j.dM is None) == (t.dM is None)
    if j.dM is not None:
        np.testing.assert_allclose(j.dM, t.dM, rtol=0, atol=1e-6)
    _same_cameras(j.cameras, t.cameras)


def test_writers_write_the_same_scene(scenes):
    """Every JSON and .npy file is byte-identical; the PNG frames decode to
    the same pixels (PIL's encoder and the port's differ in bytes)."""
    j, t = scenes["jax"], scenes["port"]
    files = sorted(osp.relpath(osp.join(d, f), j) for d, _, fs in os.walk(j) for f in fs)
    assert files == sorted(osp.relpath(osp.join(d, f), t) for d, _, fs in os.walk(t) for f in fs)
    from PIL import Image

    for f in files:
        a, b = osp.join(j, f), osp.join(t, f)
        if f.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(a)), imageio.read_png(b))
            np.testing.assert_array_equal(imageio.read_png(a), np.asarray(Image.open(b)))
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), f


@pytest.mark.parametrize("written_by", ["jax", "port"])
@pytest.mark.parametrize("is_eval,do_pretrain", [(False, False), (True, False), (True, True)])
def test_parse_color_matches_jax(scenes, written_by, is_eval, do_pretrain):
    """Train split in train mode, the eval run's val swap, and the
    emb_eval pretrain's train split; and the val split."""
    root = scenes[written_by]
    jp, tp = jparser.SceneParser(root), tparser.SceneParser(root)
    _same_color(jp.parse_color("train", is_eval=is_eval, do_pretrain=do_pretrain),
                tp.parse_color("train", is_eval=is_eval, do_pretrain=do_pretrain))
    _same_color(jp.parse_color("val"), tp.parse_color("val"))
    np.testing.assert_array_equal(jp.color_train_ts(), tp.color_train_ts())
    _same_cameras(jp.all_color_cameras(), tp.all_color_cameras())
    assert jp.max_appearance_id() == tp.max_appearance_id()


@pytest.mark.parametrize("written_by", ["jax", "port"])
def test_parse_events_matches_jax(scenes, written_by):
    root = scenes[written_by]
    j = jparser.SceneParser(root).parse_events()
    t = tparser.SceneParser(root).parse_events()
    assert j.e_thresh == t.e_thresh
    np.testing.assert_array_equal(np.asarray(j.eimgs), np.asarray(t.eimgs))
    np.testing.assert_array_equal(j.appearance_ids, t.appearance_ids)
    np.testing.assert_array_equal(_np(j.msk), _np(t.msk))
    for f in ("cameras", "prev_cameras", "next_cameras"):
        _same_cameras(getattr(j, f), getattr(t, f))
    rng = np.random.default_rng(0)
    idx = tuple(rng.integers(0, n, 40) for n in t.eimgs.shape[:3])
    np.testing.assert_array_equal(j.get_scaled(idx), t.get_scaled(idx))


def test_event_frames_stay_memmapped(scenes):
    """The event frames are a view over the memmapped .npy: a batch
    gather reads the same values as the eager array, and long recordings
    drop their last 8 frames without a copy."""
    ds = tparser.SceneParser(scenes["port"]).parse_events()
    assert isinstance(ds.eimgs, tds.LazyFrameArray)
    assert isinstance(ds.eimgs.src, np.memmap)
    eager = np.load(osp.join(scenes["port"], "ecam_set", "eimgs", "eimgs_1x.npy"))
    c, y, x = np.array([0, 3, 4]), np.array([1, 7, 15]), np.array([2, 0, 9])
    np.testing.assert_array_equal(ds.eimgs[(c, y, x)][:, 0], eager[c, y, x])
    src = np.arange(1200 * 4, dtype=np.int16).reshape(1200, 2, 2)
    long = tds.EventFrameDataset(eimgs=tds.LazyFrameArray(src, np.arange(1200)), cameras=None,
                                 e_thresh=0.1, appearance_ids=np.zeros(1200, np.int32))
    assert isinstance(long.eimgs, tds.LazyFrameArray) and len(long) == 1192


def test_dM_from_rel_cam_matches_jax(scenes, tmp_path):
    """rel_cam.json and colmap_scale give the rigid RGB-to-event extrinsic."""
    import shutil

    root = str(tmp_path / "scene")
    shutil.copytree(scenes["port"], root)
    col = osp.join(root, "colcam_set")
    meta = json.load(open(osp.join(col, "metadata.json")))
    meta["colmap_scale"] = 0.5
    json.dump(meta, open(osp.join(col, "metadata.json"), "w"))
    c, s = np.cos(0.2), np.sin(0.2)
    json.dump({"R": [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], "T": [0.1, -0.05, 0.02]},
              open(osp.join(root, "rel_cam.json"), "w"))
    cfg = dict(scale_factor=0.08)
    j = jparser.SceneParser(root, jparser.ParserConfig(**cfg)).parse_color("train")
    t = tparser.SceneParser(root, tparser.ParserConfig(**cfg)).parse_color("train")
    assert t.dM is not None
    _same_color(j, t)


def test_png_codec_round_trips_and_reads_pil(tmp_path):
    """write_png -> read_png is exact for gray, RGB and RGBA; read_png
    decodes PIL-written files (PIL picks its own row filters, the
    optimised encoder all five), palette files included."""
    from PIL import Image

    rng = np.random.default_rng(0)
    smooth = np.cumsum(rng.integers(0, 4, (23, 31, 4)), axis=1).astype(np.uint8)
    for img in (smooth[..., 0], smooth[..., :3], smooth):
        p = str(tmp_path / "a.png")
        imageio.write_png(p, img)
        np.testing.assert_array_equal(imageio.read_png(p), img)
        np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
        for kw in ({}, {"optimize": True}):
            Image.fromarray(img).save(p, **kw)
            np.testing.assert_array_equal(imageio.read_png(p), img)
        noisy = rng.integers(0, 256, img.shape, dtype=np.uint8)
        Image.fromarray(noisy).save(p)
        np.testing.assert_array_equal(imageio.read_png(p), noisy)
    Image.fromarray(smooth[..., :3]).convert("P", palette=Image.ADAPTIVE).save(str(tmp_path / "p.png"))
    pal = Image.open(str(tmp_path / "p.png"))
    np.testing.assert_array_equal(imageio.read_png(str(tmp_path / "p.png")),
                                  np.asarray(pal.convert("RGB")))
    np.testing.assert_array_equal(imageio.read_image(str(tmp_path / "p.png")),
                                  np.asarray(pal.convert("RGB")))


DIST = np.array([-0.21, 0.07, -0.01, 0.0, 0.003, -0.002], np.float32)


def test_undistort_and_generate_rays_match_jax():
    """The Newton undistort and the rays of distorted cameras, to atol 1e-5."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    coords = rng.uniform(-0.8, 0.8, (3, 50, 2)).astype(np.float32)
    j = jcams.radial_and_tangential_undistort(jnp.asarray(coords), jnp.asarray(DIST))
    t = tcams.radial_and_tangential_undistort(torch.from_numpy(coords), torch.from_numpy(DIST))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)

    c2w = np.array(jsyn.orbit_cameras(4, h=24, w=32, focal=30.0).camera_to_worlds)
    kw = dict(fx=30.0, fy=30.0, cx=16.0, cy=12.0, width=32, height=24)
    jc = jcams.Cameras(camera_to_worlds=jnp.asarray(c2w), distortion_params=jnp.asarray(DIST),
                       times=jnp.arange(4.0), **kw)
    tc = tcams.Cameras(camera_to_worlds=torch.from_numpy(c2w), distortion_params=torch.from_numpy(DIST),
                       times=torch.arange(4.0), **kw)
    idx = rng.integers(0, 4, 64)
    pix = np.stack([rng.integers(0, 24, 64), rng.integers(0, 32, 64)], 1)
    jb = jcams.generate_rays(jc, jnp.asarray(idx), jnp.asarray(pix))
    tb = tcams.generate_rays(tc, torch.from_numpy(idx), torch.from_numpy(pix))
    for f in ("origins", "directions", "pixel_area", "times"):
        np.testing.assert_allclose(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
    # the distortion moves the rays: the same cameras without it differ
    plain = tcams.generate_rays(tcams.Cameras(camera_to_worlds=torch.from_numpy(c2w), **kw),
                                torch.from_numpy(idx), torch.from_numpy(pix))
    assert float((plain.directions - tb.directions).abs().max()) > 1e-3


def _filtered_png(path, img, ftype):
    """An RGB PNG whose every row carries PNG filter `ftype` (0-4)."""
    import struct
    import zlib

    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        cur, prev = rows[y], rows[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(np.concatenate([[ftype], (cur - pred) & 0xFF]).astype(np.uint8))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reader_takes_each_row_filter(tmp_path, ftype):
    """Each of the five row filters decodes exactly (PIL agrees on the file)."""
    from PIL import Image

    img = np.random.default_rng(ftype).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    p = str(tmp_path / f"f{ftype}.png")
    _filtered_png(p, img, ftype)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    np.testing.assert_array_equal(imageio.read_png(p), img)


def test_gray_frames_and_eval_image_match_jax(scenes):
    """use_gray's Rec.601 frames and the data manager's full-view eval
    batch (next_eval_image) equal JAX's."""
    from lsenerf_tpu.data import datamanager as jdm
    from lsenerf_tpu_torch.data import datamanager as tdm

    root = scenes["port"]
    j = jparser.SceneParser(root, jparser.ParserConfig(use_gray=True)).parse_color("train")
    t = tparser.SceneParser(root, tparser.ParserConfig(use_gray=True)).parse_color("train")
    _same_color(j, t)
    assert np.ptp(t.images[..., 0] - t.images[..., 2]) == 0
    jd = jdm.MultiCamDataManager(jdm.DataManagerConfig(), j)
    td = tdm.MultiCamDataManager(tdm.DataManagerConfig(), t)
    for idx in (0, len(t) - 1):
        a, b = jd.next_eval_image(idx), td.next_eval_image(idx)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_jpeg_frames_read_as_pil_reads_them(tmp_path):
    """A *.jpg frame goes through PIL (imported only for it)."""
    from PIL import Image

    img = np.random.default_rng(3).integers(0, 256, (12, 20, 3), dtype=np.uint8)
    p = str(tmp_path / "000000.jpg")
    Image.fromarray(img).save(p, quality=95)
    np.testing.assert_array_equal(imageio.read_image(p), np.asarray(Image.open(p).convert("RGB")))
