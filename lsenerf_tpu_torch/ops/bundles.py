"""The camera rays of a step (the bundles layer) in one kernel each way.

A train step renders up to three bundles: the RGB rays (under deblur 4 a
pixel, on the spline's exposure poses or on the pixel's one pose) and the
prev and next event rays. Each is a `Part`: its cameras, its pose source
(the spline, the event spline through dM, a camera's SO3xR3 or SE3 delta on
its fixed pose, or the fixed pose alone), its batch keys and gate.
`step_rays` makes the step's rays as one bundle, concatenated in that
order: K8a `rays_fwd` forward and K8b `rays_bwd` backward (csrc/bundles.cu,
built and loaded by cuda_build) inside one autograd Function, whose
gradients reach the camera leaves (the knots' tangents, the scale, the
delta tables) and nothing else. `fixed_rays` is K8a alone at fixed poses,
which cameras.generate_rays takes on the card (eval batches, render_image,
render.py, the viewer). The plain version, `part_plain` for each bundle
and their concatenation, is the composition of torch ops the kernels
replace (cameras/pose_opt.py, ops/interp.py, ops/lie.py, cameras/
cameras.py::generate_rays_plain); it runs on any device. The wrappers run
it for CPU tensors only; for CUDA tensors they launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from lsenerf_tpu_torch.cameras import cameras as cam_lib
from lsenerf_tpu_torch.cameras import pose_opt
from lsenerf_tpu_torch.cameras.rays import RayBundle
from lsenerf_tpu_torch.ops import cuda_build, interp
from lsenerf_tpu_torch.ops.cuda_build import Kernel

SOURCE = cuda_build.CSRC / "bundles.cu"
K8A = Kernel("rays_fwd")
K8B = Kernel("rays_bwd")
KERNELS = (K8A, K8B)

# pose sources, as csrc/bundles.cu numbers them
FIXED, PER_RAY, SPLINE, SPLINE_EVS, SO3XR3, SE3 = range(6)
DELTA_POSES = {"SO3xR3": SO3XR3, "SE3": SE3}
_MODES = {SO3XR3: "SO3xR3", SE3: "SE3"}
MAX_PARTS = 4


@dataclass(frozen=True)
class Part:
    """One bundle of a step. `rows` is the batch key of its (pixels, 3)
    int64 [camera, y, x] rows, `app` of its appearance ids (None: none);
    `rep` rays a pixel (4 under deblur, the 4 of a pixel together, each
    with the neighbouring appearance id where `app_deblur`); `cam_offset`
    is added to the pixel's camera (the next event camera of `ns` and the
    event spline); `table` the path in the camera parameters to the dict
    holding the pose source's leaves ("ctrl_tangents" and "scale" of the
    splines, "pose_adjustment" of the deltas); `gate` which of the step's
    two gates (RGB 0, event 1) it takes; `snap`: its camera index is the
    nearest RGB time's (the event bundles' CameraIdxFixer)."""

    cams: cam_lib.Cameras
    pose: int
    rows: str
    app: Optional[str] = None
    rep: int = 1
    cam_offset: int = 0
    table: tuple = ()
    gate: int = 0
    app_deblur: bool = False
    snap: bool = False


def _at(tree: dict, path: tuple) -> dict:
    for key in path:
        tree = tree[key]
    return tree


# -- the plain version -------------------------------------------------------------


def part_plain(part: Part, cam_params: dict, batch: dict, gates, spline=None, rgb_ts=None,
               num_embd: int = 1) -> RayBundle:
    """One bundle of the step by torch ops: the rays, their poses from the
    part's source, its appearance ids and (snap) the nearest RGB camera."""
    gate = gates[part.gate]
    rows = batch[part.rows]
    idx, coords = rows[:, 0], rows[:, 1:].float()
    if part.rep > 1:
        idx_r, coords_r = idx.repeat_interleave(part.rep), coords.repeat_interleave(part.rep, dim=0)
    else:
        idx_r, coords_r = idx, coords
    cam = idx_r + part.cam_offset if part.cam_offset else idx_r
    cams = part.cams
    if part.pose == SPLINE:
        times = cams.times[idx]
        if part.rep > 1:
            c2w = pose_opt.spline_deblur_c2w(_at(cam_params, part.table), spline, times[:, None],
                                             gate)
        else:
            c2w = pose_opt.spline_rgb_c2w(_at(cam_params, part.table), spline, times, gate)
        bundle = cam_lib.generate_rays_plain(cams, cam, coords_r, c2w=c2w)
    elif part.pose == SPLINE_EVS:
        c2w = pose_opt.spline_evs_c2w(_at(cam_params, part.table), spline, cams.times[cam], gate)
        bundle = cam_lib.generate_rays_plain(cams, cam, coords_r, c2w=c2w)
    else:
        bundle = cam_lib.generate_rays_plain(cams, cam, coords_r)
        if part.pose in _MODES:
            bundle = pose_opt.apply_pose_deltas_to_bundle(_at(cam_params, part.table), bundle,
                                                          gate, _MODES[part.pose])
    if part.app is not None:
        app = batch[part.app]
        if part.app_deblur:
            # the exposure rays take the neighbouring appearance ids
            delta = torch.arange(part.rep, device=app.device) - 2
            app = torch.clamp(app[:, None] + delta[None], 0, num_embd - 1).reshape(-1)
        bundle = bundle.replace(metadata={"appearance_id": app})
    if part.snap and rgb_ts is not None and bundle.times is not None:
        fixed = interp.find_closest_idxs(rgb_ts, bundle.times[:, 0])
        bundle = bundle.replace(camera_indices=fixed[:, None].int())
    return bundle


def step_rays_plain(parts, cam_params: dict, batch: dict, gates, spline=None, rgb_ts=None,
                    num_embd: int = 1) -> RayBundle:
    """The parts' bundles by part_plain, concatenated."""
    from lsenerf_tpu_torch.models import lsenerf as model_lib

    bundles = [part_plain(p, cam_params, batch, gates, spline, rgb_ts, num_embd) for p in parts]
    return model_lib.concat_bundles(bundles) if len(bundles) > 1 else bundles[0]


# -- K8a/K8b -----------------------------------------------------------------------


class _Part(ctypes.Structure):
    """csrc/bundles.cu's Part, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "idx", "coords", "dist", "c2w", "times", "gate_ptr", "table", "table_grad", "app")]
        + [(f, ctypes.c_float) for f in ("fx", "fy", "cx", "cy", "gate")]
        + [(f, ctypes.c_int) for f in ("n", "offset", "rep", "pose", "cam_offset", "rows",
                                       "c2w_stride", "app_deblur", "snap")])


class _Target(ctypes.Structure):
    """csrc/bundles.cu's Target, field for field."""

    _fields_ = [("grad", ctypes.c_void_p)] + [(f, ctypes.c_int) for f in (
        "rows", "parts", "first", "pad")]


class _RaysArgs(ctypes.Structure):
    """csrc/bundles.cu's RaysArgs, field for field."""

    _fields_ = ([("parts", _Part * MAX_PARTS), ("targets", _Target * MAX_PARTS)]
                + [(f, ctypes.c_void_p) for f in (
                    "ctrl_ts", "dM", "scale", "scale_grad", "rgb_ts", "origins", "dirs", "area",
                    "cam_out", "times_out", "app_out", "g_origins", "g_dirs", "g_area", "terms",
                    "sterms", "keys")]
                + [(f, ctypes.c_float) for f in ("exp_half", "exp_delta")]
                + [(f, ctypes.c_int) for f in ("m", "n_rgb", "num_embd", "num_parts", "n",
                                               "num_targets", "sum_blocks")])


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load(SOURCE)
    for name in ("rays_fwd", "rays_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_RaysArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _need(name: str, t: torch.Tensor, dtype, shape, dev) -> torch.Tensor:
    """t where K8a/K8b take it as it is (dtype, shape, device, contiguous);
    else raise ValueError naming it."""
    cuda_build.check(name, t, (dtype,), shape, dev)
    return t


def _gate(p: _Part, gate, dev) -> None:
    if isinstance(gate, torch.Tensor):
        _need("gate", gate, torch.float32, (), dev)
        p.gate_ptr = gate.data_ptr()
    else:
        p.gate = float(gate)


class _Call:
    """One call's arguments: the struct with everything but the gradients,
    the tensors it points at (kept alive to the backward), the leaves in
    the Function's order and, for each part and the scale, its leaf."""

    def __init__(self, parts, cam_params, batch, gates, spline, rgb_ts, num_embd, sizes, dev):
        if not 0 < len(parts) <= MAX_PARTS:
            raise ValueError(f"K8a takes 1 to {MAX_PARTS} bundles, got {len(parts)}")
        a = self.args = _RaysArgs(num_parts=len(parts), num_embd=num_embd)
        keep, leaves, self.part_leaf, self.scale_leaf = [], [], [], None

        def leaf(t, name, shape):
            _need(name, t, torch.float32, shape, dev)
            for i, x in enumerate(leaves):
                if x is t:
                    return i
            leaves.append(t)
            return len(leaves) - 1

        with_times = parts[0].cams.times is not None
        with_app = parts[0].app is not None
        offset = 0
        for k, (part, n) in enumerate(zip(parts, sizes)):
            p, cams = a.parts[k], part.cams
            if (cams.times is not None) != with_times or (part.app is not None) != with_app:
                raise ValueError("the bundles of a step must all have times and appearance "
                                 "ids, or none")
            rows = batch[part.rows]
            _need(part.rows, rows, torch.int64, (n // part.rep, 3), dev)
            c2w = _need("camera_to_worlds", cams.camera_to_worlds, torch.float32,
                        (len(cams), 3, 4), dev)
            p.idx, p.c2w, p.rows = rows.data_ptr(), c2w.data_ptr(), 1
            keep += [rows, c2w]
            if cams.times is not None:
                p.times = _need("times", cams.times, torch.float32, (len(cams),), dev).data_ptr()
                keep.append(cams.times)
            if cams.distortion_params is not None:
                dist = _need("distortion_params", cams.distortion_params, torch.float32, (6,), dev)
                p.dist = dist.data_ptr()
                keep.append(dist)
            if part.app is not None:
                app = _need(part.app, batch[part.app], torch.int64, (n // part.rep,), dev)
                p.app = app.data_ptr()
                keep.append(app)
            p.fx, p.fy, p.cx, p.cy = cams.fx, cams.fy, cams.cx, cams.cy
            p.n, p.offset, p.rep, p.pose, p.cam_offset = n, offset, part.rep, part.pose, part.cam_offset
            p.app_deblur, p.snap = int(part.app_deblur), int(part.snap and rgb_ts is not None
                                                             and cams.times is not None)
            _gate(p, gates[part.gate], dev)
            table_leaf = None
            if part.pose in (SPLINE, SPLINE_EVS):
                tree = _at(cam_params, part.table)
                m = spline.ctrl_ts.shape[0]
                table_leaf = leaf(tree["ctrl_tangents"], "ctrl_tangents", (m, 6))
                a.ctrl_ts = _need("ctrl_ts", spline.ctrl_ts, torch.float32, (m,), dev).data_ptr()
                a.m = m
                keep.append(spline.ctrl_ts)
                if part.rep > 1:
                    if part.rep != spline.n_deblur_rays:
                        raise ValueError(f"{part.rep} rays a pixel on a spline of "
                                         f"{spline.n_deblur_rays} exposure poses")
                    a.exp_half = float(np.float32(spline.exp_t / 2.0))
                    a.exp_delta = float(np.float32(spline.exp_t / (spline.n_deblur_rays - 1)))
                if part.pose == SPLINE_EVS:
                    if spline.dM is None:
                        raise ValueError("the event spline needs the RGB -> event extrinsic dM")
                    a.dM = _need("dM", spline.dM, torch.float32, (4, 4), dev).data_ptr()
                    self.scale_leaf = leaf(tree["scale"], "scale", (1,))
                    a.scale = tree["scale"].data_ptr()
                    keep.append(spline.dM)
            elif part.pose in _MODES:
                table_leaf = leaf(_at(cam_params, part.table)["pose_adjustment"],
                                  "pose_adjustment", (len(cams), 6))
            elif part.pose != FIXED:
                raise ValueError(f"a step's bundle takes no pose source {part.pose}")
            if table_leaf is not None:
                p.table = leaves[table_leaf].data_ptr()
            self.part_leaf.append(table_leaf)
            offset += n
        if any(p.snap for p in a.parts[:len(parts)]):
            a.rgb_ts = _need("rgb_ts", rgb_ts, torch.float32, (rgb_ts.shape[0],), dev).data_ptr()
            a.n_rgb = rgb_ts.shape[0]
            keep.append(rgb_ts)
        a.n = offset
        self.keep, self.leaves, self.dev = keep, leaves, dev
        self.with_times, self.with_app = with_times, with_app

    def forward(self) -> tuple:
        """K8a: (origins (n, 3), directions (n, 3), pixel_area (n, 1),
        camera_indices (n, 1) int32, [times (n, 1)], [appearance ids (n,)])."""
        a, n, ref = self.args, self.args.n, self.keep[0]
        o, d, area = (torch.empty((n, c), dtype=torch.float32, device=self.dev) for c in (3, 3, 1))
        cam = torch.empty((n, 1), dtype=torch.int32, device=self.dev)
        outs = [o, d, area, cam]
        a.origins, a.dirs, a.area, a.cam_out = o.data_ptr(), d.data_ptr(), area.data_ptr(), \
            cam.data_ptr()
        if self.with_times:
            outs.append(torch.empty((n, 1), dtype=torch.float32, device=self.dev))
            a.times_out = outs[-1].data_ptr()
        if self.with_app:
            outs.append(torch.empty((n,), dtype=torch.int64, device=self.dev))
            a.app_out = outs[-1].data_ptr()
        K8A.count(_library().rays_fwd(a, cuda_build.stream(ref)))
        return tuple(outs)

    def backward(self, g_o, g_d, g_a, wanted) -> list:
        """K8b: the gradients of the leaves (None where not wanted), from
        the cotangents of origins, directions and pixel_area (None: zeros).
        One buffer holds them all, every element written by K8b, and one
        its scratch (each ray's terms and key)."""
        a = _RaysArgs.from_buffer_copy(self.args)
        n = a.n
        sizes = [t.numel() if w else 0 for t, w in zip(self.leaves, wanted)]
        flat = torch.empty(sum(sizes) + 14 * n, dtype=torch.float32, device=self.dev)
        grads, at = [], 0
        for t, size in zip(self.leaves, sizes):
            grads.append(flat[at:at + size].view(t.shape) if size else None)
            at += size
        a.terms, a.sterms = flat[at:].data_ptr(), flat[at + 12 * n:].data_ptr()
        a.keys = flat[at + 13 * n:].data_ptr()
        blocks = 0
        for li, g in enumerate(grads):
            if g is None or li == self.scale_leaf:
                continue
            mask = sum(1 << k for k, pl in enumerate(self.part_leaf) if pl == li)
            a.targets[a.num_targets] = _Target(grad=g.data_ptr(), rows=g.shape[0], parts=mask,
                                               first=blocks)
            a.num_targets += 1
            blocks += g.shape[0]
            for k in range(len(self.part_leaf)):
                if (mask >> k) & 1:
                    a.parts[k].table_grad = g.data_ptr()
        if self.scale_leaf is not None and grads[self.scale_leaf] is not None:
            a.scale_grad = grads[self.scale_leaf].data_ptr()
            blocks += 1  # the last block sums the scale's terms
        a.sum_blocks = blocks
        cots = []
        for name, g, c in (("g_origins", g_o, 3), ("g_dirs", g_d, 3), ("g_area", g_a, 1)):
            if g is not None:
                g = _need(name, g.contiguous(), torch.float32, (n, c), self.dev)
                setattr(a, name, g.data_ptr())
                cots.append(g)
        if any(g is not None for g in grads):
            K8B.count(_library().rays_bwd(a, cuda_build.stream(flat)))
        return grads


class _StepRays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call, *leaves):
        ctx.set_materialize_grads(False)
        ctx.call = call
        outs = call.forward()
        ctx.mark_non_differentiable(*outs[3:])
        return outs

    @staticmethod
    def backward(ctx, g_o, g_d, g_a, *rest):
        grads = ctx.call.backward(g_o, g_d, g_a, ctx.needs_input_grad[1:])
        ctx.call = None
        return (None, *grads)


def step_rays(parts, cam_params: dict, batch: dict, gates, spline=None, rgb_ts=None,
              num_embd: int = 1):
    """(the step's rays as one bundle, the rays of each part): the parts'
    bundles concatenated in order, with their appearance ids. `gates` are
    the step's (RGB, event) gates, each a float or a 0-dim device tensor;
    `spline` the RGB spline's SplineStatic, `rgb_ts` the RGB cameras' times
    (snap), `num_embd` the appearance rows (deblur's clamp). K8a forward,
    K8b backward on the card; the plain version on the CPU."""
    sizes = [batch[p.rows].shape[0] * p.rep for p in parts]
    dev = batch[parts[0].rows].device
    if dev.type == "cpu":
        return step_rays_plain(parts, cam_params, batch, gates, spline, rgb_ts, num_embd), sizes
    call = _Call(parts, cam_params, batch, gates, spline, rgb_ts, num_embd, sizes, dev)
    outs = _StepRays.apply(call, *call.leaves)
    o, d, area, cam = outs[:4]
    rest = list(outs[4:])
    times = rest.pop(0) if call.with_times else None
    bundle = RayBundle(origins=o, directions=d, pixel_area=area, camera_indices=cam, times=times)
    if call.with_app:
        bundle = bundle.replace(metadata={"appearance_id": rest.pop(0)})
    return bundle, sizes


def fixed_rays(cams: cam_lib.Cameras, camera_indices: torch.Tensor, pixel_coords: torch.Tensor,
               c2w: Optional[torch.Tensor] = None) -> RayBundle:
    """K8a at fixed poses: generate_rays on the card (its poses are the
    cameras' own, or `c2w`, a pose a ray or one pose expanded over the
    rays). No backward: a c2w that needs a gradient is refused."""
    dev = cams.camera_to_worlds.device
    if dev.type != "cuda":
        raise ValueError(f"K8a takes CUDA tensors, got {dev}")
    if camera_indices.dim() != 1:
        raise ValueError("K8a takes (n,) camera indices")
    n = camera_indices.shape[0]
    idx = camera_indices.to(device=dev, dtype=torch.int64).contiguous()
    coords = pixel_coords.to(device=dev, dtype=torch.float32).contiguous()
    _need("pixel_coords", coords, torch.float32, (n, 2), dev)
    a = _RaysArgs(num_parts=1, n=n, num_embd=1)
    p = a.parts[0]
    p.idx, p.coords, p.rows, p.n, p.rep = idx.data_ptr(), coords.data_ptr(), 0, n, 1
    p.fx, p.fy, p.cx, p.cy = cams.fx, cams.fy, cams.cx, cams.cy
    keep = [idx, coords]
    if c2w is None:
        pose = _need("camera_to_worlds", cams.camera_to_worlds, torch.float32, (len(cams), 3, 4),
                     dev)
        p.pose = FIXED
    else:
        if c2w.requires_grad and torch.is_grad_enabled():
            raise ValueError("K8a's fixed poses take no gradient: c2w requires one")
        if c2w.dim() != 3 or c2w.shape[0] not in (1, n) or c2w.shape[1:] != (3, 4):
            raise ValueError(f"c2w has shape {tuple(c2w.shape)}, expected (1, 3, 4) or ({n}, 3, 4)")
        one = c2w.shape[0] == 1 or c2w.stride(0) == 0
        pose = (c2w[:1] if one else c2w).detach().to(torch.float32).contiguous()
        p.pose, p.c2w_stride = PER_RAY, 0 if one else 12
    p.c2w = pose.data_ptr()
    keep.append(pose)
    if cams.times is not None:
        p.times = _need("times", cams.times, torch.float32, (len(cams),), dev).data_ptr()
    if cams.distortion_params is not None:
        p.dist = _need("distortion_params", cams.distortion_params, torch.float32, (6,),
                       dev).data_ptr()
    o, d, area = (torch.empty((n, c), dtype=torch.float32, device=dev) for c in (3, 3, 1))
    cam = torch.empty((n, 1), dtype=torch.int32, device=dev)
    times = torch.empty((n, 1), dtype=torch.float32, device=dev) if cams.times is not None else None
    a.origins, a.dirs, a.area, a.cam_out = o.data_ptr(), d.data_ptr(), area.data_ptr(), \
        cam.data_ptr()
    a.times_out = 0 if times is None else times.data_ptr()
    K8A.count(_library().rays_fwd(a, cuda_build.stream(o)))
    return RayBundle(origins=o, directions=d, pixel_area=area, camera_indices=cam, times=times)
