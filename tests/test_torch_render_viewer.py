"""The port's render and viewer entry points (lsenerf_tpu_torch/render.py,
viewer.py, engine/viewer.py) against the JAX package's, mirroring
tests/test_viewer.py: the orbit math and scaled_cameras, the viewer's
renders on the same weights (tests/torch_parity.py's small model with JAX's
params carried across), the HTTP surface in both image formats, and
`python -m lsenerf_tpu_torch.render` and `--is_render True` end to end on a
port checkpoint, on the CPU."""

import http.client
import io
import json
import os
import os.path as osp
import threading

import numpy as np
import pytest
import torch

from lsenerf_tpu.engine import viewer as jview
from lsenerf_tpu_torch import render as trender
from lsenerf_tpu_torch import train
from lsenerf_tpu_torch.data.imageio import decode_png, read_png
from lsenerf_tpu_torch.data.parser import ParserConfig, SceneParser
from lsenerf_tpu_torch.data.synthetic import write_reference_scene
from lsenerf_tpu_torch.engine import checkpoints as ckpt_lib
from lsenerf_tpu_torch.engine import renderer as tren
from lsenerf_tpu_torch.engine import viewer as tview

import torch_parity
from test_torch_cli import TINY_MODEL
from test_torch_config import train_argv

RES = (8, 16)


@pytest.fixture(scope="module")
def sessions():
    """(JAX session, port session) over the same weights and grid: the
    small parity model without mapping, with the white background blended
    in, renders in chunks of 100 rays."""
    jt, state, tt = torch_parity.trainers(model=dict(use_mapping=False, background_color="white"))
    j = jview.ViewerSession(state.params["model"], jt.dm.col.cameras, state.occ, jt.model_config,
                            appearance_id=1, resolutions=RES, chunk=100)
    t = tview.ViewerSession(tt.params["model"], tt.col_cams, tt.occ, tt.model_config,
                            appearance_id=1, resolutions=RES, chunk=100, image_format="png")
    return j, t


def test_scaled_cameras_match_jax():
    jt, _, tt = torch_parity.trainers()
    for max_dim in (5, 8, 16, 33):
        j = jview.scaled_cameras(jt.dm.col.cameras, max_dim)
        t = tview.scaled_cameras(tt.col_cams, max_dim)
        assert (t.width, t.height) == (j.width, j.height)
        assert max(t.width, t.height) == max_dim
        for k in ("fx", "fy", "cx", "cy"):
            assert getattr(t, k) == pytest.approx(float(getattr(j, k)), rel=1e-6), k
        assert torch.equal(t.camera_to_worlds, tt.col_cams.camera_to_worlds)


def test_orbit_c2w_matches_jax_and_inverts():
    """The same matrix as JAX's orbit_c2w, an orthonormal right-handed
    basis looking at the target from `radius`, and the page's fromC2w()
    formulas (written out here) recover the orbit."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        theta, phi, radius = rng.uniform(-np.pi, np.pi), rng.uniform(-1.4, 1.4), rng.uniform(0.3, 5)
        target = rng.uniform(-1, 1, 3)
        m = tview.orbit_c2w(theta, phi, radius, target)
        np.testing.assert_array_equal(m, jview.orbit_c2w(theta, phi, radius, target))
        r = m[:, :3].astype(np.float64)
        np.testing.assert_allclose(r.T @ r, np.eye(3), atol=1e-5)
        assert np.linalg.det(r) > 0
        np.testing.assert_allclose(m[:, 3] - radius * m[:, 2], target, atol=1e-5)
        z = m[:, 2]
        np.testing.assert_allclose([np.arctan2(z[1], z[0]), np.arcsin(np.clip(z[2], -1, 1))],
                                   [theta, phi], atol=1e-5)
    # straight down the z axis: any horizontal x
    np.testing.assert_array_equal(tview.orbit_c2w(0.3, np.pi / 2, 2.0),
                                  jview.orbit_c2w(0.3, np.pi / 2, 2.0))


def test_session_info_matches_jax(sessions):
    j, t = sessions
    ji, ti = j.info(), t.info()
    assert ti.pop("image_format") == "png"
    assert set(ti) == set(ji)
    for k in ("resolutions", "width", "height", "outputs", "appearance_id"):
        assert ti[k] == ji[k], k
    np.testing.assert_allclose(ti["init_c2w"], ji["init_c2w"], atol=1e-6)
    np.testing.assert_allclose(ti["target"], ji["target"], rtol=1e-5, atol=1e-6)
    assert ti["radius"] == pytest.approx(ji["radius"], rel=1e-5)


def test_session_render_matches_jax(sessions):
    """Each output at each resolution, at the first camera's pose and at an
    orbit pose: the port's uint8 image within one level of JAX's (the
    float renders agree to ~1e-5, so a value on a rounding edge may round
    the other way), and exactly the quantised render_image of its pose."""
    j, t = sessions
    poses = [t.init_c2w, tview.orbit_c2w(0.7, 0.3, t.radius, t.target)]
    for c2w in poses:
        for res in RES:
            for out in tview.ViewerSession.OUTPUTS:
                ti, ji = t.render(c2w, res, out), j.render(c2w, res, out)
                cams = t._cams[res]
                assert ti.shape == ji.shape == (cams.height, cams.width, 3) and ti.dtype == np.uint8
                assert np.abs(ti.astype(int) - ji.astype(int)).max() <= 1, (res, out)
            direct = tren.render_image(t.model_params, t._cams[res], 0, t.occ_state, t.config,
                                       appearance_id=t.appearance_id, chunk=t.chunk,
                                       c2w_override=c2w)
            np.testing.assert_array_equal(
                t.render(c2w, res, "rgb"),
                (np.clip(direct["rgb"], 0, 1) * 255.0 + 0.5).astype(np.uint8))
    assert t.render(poses[1], 16, "accumulation").std() > 0
    with pytest.raises(ValueError):
        t.render(poses[0], 8, "nope")


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_http_surface(sessions, fmt):
    """GET /, GET /info, POST /render at each resolution and output (a PNG
    reply decodes to exactly session.render's array; JPEG through PIL to
    its size), a malformed request answered 400, an unknown path 404."""
    _, t = sessions
    t.image_format = fmt
    srv = tview.make_server(t, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
        conn.request("GET", "/")
        r = conn.getresponse()
        assert r.status == 200 and b"lsenerf_tpu_torch" in r.read()
        conn.request("GET", "/info")
        r = conn.getresponse()
        info = json.loads(r.read())
        assert r.status == 200 and info["resolutions"] == list(RES)
        assert info["image_format"] == fmt
        for res in RES:
            for out in tview.ViewerSession.OUTPUTS:
                body = json.dumps({"c2w": info["init_c2w"], "max_dim": res, "output": out, "seq": 7})
                conn.request("POST", "/render", body=body)
                r = conn.getresponse()
                data = r.read()
                assert r.status == 200 and r.getheader("X-Seq") == "7"
                assert float(r.getheader("X-Render-Ms")) > 0
                assert r.getheader("Content-Type") == f"image/{fmt}"
                want = t.render(info["init_c2w"], res, out)
                if fmt == "png":
                    np.testing.assert_array_equal(decode_png(data), want)
                else:
                    from PIL import Image

                    im = Image.open(io.BytesIO(data))
                    assert im.size == (want.shape[1], want.shape[0])
        conn.request("POST", "/render", body="{bad json")
        r = conn.getresponse()
        r.read()
        assert r.status == 400
        conn.request("GET", "/nope")
        r = conn.getresponse()
        r.read()
        assert r.status == 404
    finally:
        srv.shutdown()
        srv.server_close()
        t.image_format = "png"


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """A 10-step lsenerf run of the tiny model on a 16x16 reference scene
    (the CLI in process, on the CPU)."""
    work = tmp_path_factory.mktemp("render")
    data = str(work / "scene")
    write_reference_scene(data, n_cams=8, h=16, w=16, focal=20.0, n_val=2, with_prevnext=True,
                          with_full_camera=True, texture_freq=3.0)
    run = train.main(train_argv("lsenerf", data) + [
        "--max-num-iterations", "10", "--steps-per-save", "10", "--steps-per-eval-batch", "100",
        "--steps-per-eval-image", "100", "--steps-per-eval-all-images", "100",
        "--output-dir", str(work / "out")] + TINY_MODEL + ["--device", "cpu"])
    return work, data, run


@pytest.mark.parametrize("traj", ["train", "full"])
def test_render_cli_writes_each_frame(trained_run, traj):
    """`python -m lsenerf_tpu_torch.render` renders every camera of the
    trajectory; each written img/NNN.png is render_image's rgb of that
    view, quantised as LSEWriter writes it, and depth/NNN.png its depth
    over its max."""
    work, data, run = trained_run
    out_dir = str(work / f"renders_{traj}")
    trender.main(["--load-dir", osp.join(run, "checkpoints"), "--load-config",
                  osp.join(run, "config.yml"), "--output-dir", out_dir, "--traj", traj,
                  "--chunk", "100", "--device", "cpu"])
    trainer, col, sp, step = trender.load_trained(osp.join(run, "checkpoints"),
                                                  osp.join(run, "config.yml"), device="cpu")
    assert step == 9 and trainer.config.mode == "render" and trainer.optimizer is None
    cams = sp.all_color_cameras() if traj == "full" else col.cameras
    n = len(cams)
    assert n == (len(SceneParser(data, ParserConfig()).all_color_cameras()) if traj == "full"
                 else len(col.cameras))
    frames = sorted(os.listdir(osp.join(out_dir, "eval_results", "img")))
    assert frames == [f"{i:03d}.png" for i in range(n)]
    for i in range(n):
        out = tren.render_image(trainer.params["model"], cams, i, trainer.occ,
                                trainer.model_config, appearance_id=int(col.appearance_ids[
                                    min(i, len(col.appearance_ids) - 1)]), chunk=100)
        img = read_png(osp.join(out_dir, "eval_results", "img", f"{i:03d}.png"))
        np.testing.assert_array_equal(img, np.clip(out["rgb"] * 255, 0, 255).astype(np.uint8))
        depth = read_png(osp.join(out_dir, "eval_results", "depth", f"{i:03d}.png"))
        want = np.clip(out["depth"] / out["depth"].max() * 255, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(depth, np.tile(want, (1, 1, 3)))


def test_is_render_run_moves_nothing(trained_run):
    """--is_render True on the run: the RENDER mode trains no leaf, and the
    loop runs no occupancy update (the grid is the checkpoint's, bit for
    bit)."""
    work, _, run = trained_run
    ckpt = osp.join(run, "checkpoints")
    rrun = train.main(["lsenerf", "--is_render", "True", "--load-dir", ckpt, "--load-config",
                       osp.join(run, "config.yml"), "--max-num-iterations", "17",
                       "--output-dir", str(work / "render_run"), "--vis", "none",
                       "--device", "cpu"])
    _, p0, occ0 = ckpt_lib.load_checkpoint(ckpt)
    step, p1, occ1 = ckpt_lib.load_checkpoint(osp.join(rrun, "checkpoints"))
    assert step == 9 + 17
    flat0, flat1 = ckpt_lib._cpu_tree(p0), ckpt_lib._cpu_tree(p1)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}") if isinstance(v, dict) else [(f"{prefix}/{k}", v)]

    a, b = dict(leaves(flat0)), dict(leaves(flat1))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(occ0["occs"], occ1["occs"]) and torch.equal(occ0["binaries"], occ1["binaries"])
