"""Volume-rendering compositing over dense masked samples.
Port of lsenerf_tpu/ops/composite.py, with its inf-safe masking and the
shifted exclusive cumsum (composite.py:45-75).

render_bundle composites through `composite`: K5a `composite_fwd` and K5b
`composite_bwd` (csrc/composite.cu, built and loaded by cuda_build) inside
one autograd Function. Their plain versions are `composite_fwd_plain`, the
chain render_weights -> render_rgb / render_depth / render_accumulation,
and `composite_bwd_plain`, its backward written out. A wrapper runs the
plain version for CPU tensors only; for CUDA tensors it launches its kernel
or raises."""

from __future__ import annotations

import ctypes
import functools

import torch

from lsenerf_tpu_torch.cameras.rays import RaySamples
from lsenerf_tpu_torch.ops import cuda_build
from lsenerf_tpu_torch.ops.cuda_build import Kernel


def _culls(alpha_thre) -> bool:
    """Does alpha_thre turn culling on (a 0-dim tensor, or a float > 0)?"""
    return not (isinstance(alpha_thre, (int, float)) and alpha_thre <= 0.0)


def render_weights(
    samples: RaySamples, densities: torch.Tensor, alpha_thre=0.0, early_stop_eps: float = 1e-4
) -> torch.Tensor:
    """(n, k, 1) densities -> (n, k) compositing weights.

    alpha_thre is a float (0 turns culling off) or a 0-dim tensor (the
    dynamic min(alpha_thre, occs.mean()) rule)."""
    mask = samples.mask
    zero = torch.zeros((), dtype=densities.dtype, device=densities.device)
    # torch.where, not a product with the mask: a masked-out inf density
    # would give 0 * inf = NaN
    sigma = torch.where(mask, densities[..., 0], zero)
    delta = torch.where(mask, samples.t_ends - samples.t_starts, zero)
    sdt = sigma * delta
    alpha = 1.0 - torch.exp(-sdt)
    if _culls(alpha_thre):
        cull = alpha <= alpha_thre
        sdt = torch.where(cull, zero, sdt)
        alpha = torch.where(cull, zero, alpha)
    # shifted cumsum, not cumsum(sdt) - sdt, which forms inf - inf = NaN
    accum = torch.cumsum(sdt, dim=-1)
    excl = torch.cat([torch.zeros_like(accum[..., :1]), accum[..., :-1]], dim=-1)
    trans = torch.exp(-excl)
    if early_stop_eps > 0.0:
        alpha = torch.where(trans > early_stop_eps, alpha, zero)
    return alpha * trans


def accumulate(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(n, k) weights x (n, k, c) values -> (n, c)."""
    return (weights[..., None] * values).sum(-2)


def render_rgb(
    weights: torch.Tensor, rgbs: torch.Tensor, bg_color: torch.Tensor | None = None,
    background: str = "linear",
) -> torch.Tensor:
    """Weighted RGB with a background blended in by the missing
    accumulation: the colours `bg_color` (n, 3) where given (the random
    background, whose colours the caller draws), else by `background`:
    "linear" (none), "black", "white" or "last_sample" (each ray's last
    sample's colour)."""
    comp = accumulate(weights, rgbs)
    if bg_color is not None:
        bg = bg_color
    elif background == "linear":
        return comp
    elif background == "black":
        bg = torch.zeros_like(comp)
    elif background == "white":
        bg = torch.ones_like(comp)
    elif background == "last_sample":
        bg = rgbs[:, -1, :]
    elif background == "random":
        raise ValueError("the random background needs its colours (bg_color)")
    else:
        raise ValueError(f"unknown background {background}")
    return comp + bg * (1.0 - weights.sum(-1, keepdim=True))


def render_depth(weights: torch.Tensor, samples: RaySamples, eps: float = 1e-10):
    """Expected depth: sum(w * t_mid) / (sum(w) + eps)."""
    t_mid = 0.5 * (samples.t_starts + samples.t_ends)
    acc = weights.sum(-1, keepdim=True)
    return (weights * t_mid).sum(-1, keepdim=True) / (acc + eps)


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    return weights.sum(-1, keepdim=True)


# ---------------------------------------------------------------------------
# K5a/K5b: the composite of render_bundle in one kernel each way
# ---------------------------------------------------------------------------

SOURCE = cuda_build.CSRC / "composite.cu"
K5A = Kernel("composite_fwd")
K5B = Kernel("composite_bwd")
KERNELS = (K5A, K5B)

# the backgrounds by kernel code: None/"linear" none, bg colours, fixed ones
_BG_MODES = {"linear": 0, "random": 1, "black": 2, "white": 3, "last_sample": 4}


def _background_mode(bg_color, background: str) -> int:
    if bg_color is not None:
        return 1
    if background == "random":
        raise ValueError("the random background needs its colours (bg_color)")
    if background not in _BG_MODES:
        raise ValueError(f"unknown background {background}")
    return _BG_MODES[background]


def composite_fwd_plain(density, rgb, t_starts, t_ends, mask, alpha_thre=0.0,
                        early_stop_eps: float = 1e-4, bg_color=None, background: str = "linear"):
    """(n, k, 1) density, (n, k, 3) rgb, (n, k) t_starts, t_ends, mask ->
    (rgb (n, 3), depth (n, 1), accumulation (n, 1)): render_weights, then
    render_rgb with the background, render_depth and render_accumulation."""
    samples = RaySamples(positions=None, directions=None, t_starts=t_starts, t_ends=t_ends,
                         mask=mask)
    w = render_weights(samples, density, alpha_thre, early_stop_eps)
    return (render_rgb(w, rgb, bg_color, background), render_depth(w, samples),
            render_accumulation(w))


def composite_bwd_plain(density, rgb, t_starts, t_ends, mask, alpha_thre, early_stop_eps,
                        bg_color, background, g_rgb, g_depth, g_acc):
    """The composite's backward written out: the cotangents of rgb (n, 3),
    depth (n, 1) and accumulation (n, 1) (None for zeros) -> (d density
    (n, k, 1), d rgb (n, k, 3)). With s_j = sigma_j delta_j, T_j =
    exp(-sum_{i<j} s_i) and w_j = alpha_j T_j,
      dL/ds_i = exp(-s_i) T_i dL/dw_i - sum_{j>i} w_j dL/dw_j
    for a sample that is kept and not culled (0 else; the first term 0
    where early stop zeroes alpha_i), dL/dsigma_i = delta_i dL/ds_i, and
    dL/drgb_i = w_i dL/drgb, plus (1 - acc) dL/drgb for the last sample
    under the last_sample background."""
    zero = torch.zeros((), dtype=density.dtype, device=density.device)
    n, k = mask.shape
    mode = _background_mode(bg_color, background)

    def zeros_if_none(g, c):
        return torch.zeros((n, c), dtype=density.dtype, device=density.device) if g is None else g

    g_rgb, g_depth, g_acc = (zeros_if_none(g, c) for g, c in ((g_rgb, 3), (g_depth, 1), (g_acc, 1)))
    sigma = torch.where(mask, density[..., 0], zero)
    delta = torch.where(mask, t_ends - t_starts, zero)
    s0 = sigma * delta
    alpha = 1.0 - torch.exp(-s0)
    culled = torch.zeros_like(mask)
    if _culls(alpha_thre):
        culled = alpha <= alpha_thre
    s = torch.where(culled, zero, s0)
    alpha = torch.where(culled, zero, alpha)
    accum = torch.cumsum(s, dim=-1)
    trans = torch.exp(-torch.cat([torch.zeros_like(accum[..., :1]), accum[..., :-1]], dim=-1))
    live = trans > early_stop_eps if early_stop_eps > 0.0 else torch.ones_like(mask)
    w = torch.where(live, alpha, zero) * trans
    acc = w.sum(-1, keepdim=True)
    t_mid = 0.5 * (t_starts + t_ends)
    num = (w * t_mid).sum(-1, keepdim=True)
    den = acc + 1e-10
    # dL/dw: rgb's, accumulation's and depth's = num / den's terms
    dw = (g_rgb[:, None, :] * rgb).sum(-1) + g_acc + t_mid * (g_depth / den) \
        - g_depth * num / (den * den)
    if mode:  # the background's term: rgb = comp + bg * (1 - acc)
        if mode == 1:
            bg = bg_color
        elif mode == 4:
            bg = rgb[:, -1, :]
        else:
            bg = torch.full_like(g_rgb, 1.0 if mode == 3 else 0.0)
        dw = dw - (g_rgb * bg).sum(-1, keepdim=True)
    q = w * dw
    # sum over later samples: a reverse cumulative sum, shifted (no subtraction)
    rev = torch.flip(torch.cumsum(torch.flip(q, [-1]), dim=-1), [-1])
    later = torch.cat([rev[..., 1:], torch.zeros_like(rev[..., :1])], dim=-1)
    ds = torch.where(live, dw * trans, zero) * torch.exp(-s0) - later
    ds = torch.where(culled, zero, ds)
    d_density = torch.where(mask, ds * delta, zero)[..., None]
    d_rgb = w[..., None] * g_rgb[:, None, :]
    if mode == 4:
        d_rgb = torch.cat([d_rgb[:, :-1], d_rgb[:, -1:] + ((1.0 - acc) * g_rgb)[:, None]], 1)
    return d_density, d_rgb


class _CompositeArgs(ctypes.Structure):
    """csrc/composite.cu's CompositeArgs, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "density", "rgb", "t_starts", "t_ends", "mask", "bg", "thr_ptr", "g_rgb", "g_depth",
        "g_acc", "out_rgb", "out_depth", "out_acc", "d_density", "d_rgb")]
        + [(f, ctypes.c_int) for f in ("n", "k", "cull", "bg_mode")]
        + [(f, ctypes.c_float) for f in ("thr", "eps")])


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load(SOURCE)
    for name in ("composite_fwd", "composite_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_CompositeArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


MAX_SAMPLES = 64  # k: a lane a sample, two halves of a warp


def _refuse(density, rgb, t_starts, t_ends, mask, alpha_thre, bg_color, mode, outs):
    """Raise ValueError naming the first check the inputs fail: all on one
    CUDA device, f32, the shapes of n rays of k samples. The device's type
    is checked last."""
    dev = density.device
    n, k = mask.shape[0], mask.shape[-1]
    if k > MAX_SAMPLES:
        raise ValueError(f"K5a/K5b take at most {MAX_SAMPLES} samples a ray, got {k}")
    f32 = (torch.float32,)
    cuda_build.check("density", density, f32, (n, k, 1), dev)
    cuda_build.check("rgb", rgb, f32, (n, k, 3), dev)
    cuda_build.check("t_starts", t_starts, f32, (n, k), dev)
    cuda_build.check("t_ends", t_ends, f32, (n, k), dev)
    cuda_build.check("mask", mask, (torch.bool,), (n, k), dev)
    if mode == 1:
        cuda_build.check("bg_color", bg_color, f32, (n, 3), dev)
    if isinstance(alpha_thre, torch.Tensor):
        cuda_build.check("alpha_thre", alpha_thre, f32, (), dev)
    for name, t in outs.items():
        if t is not None:
            cuda_build.check(name, t, f32, _COT_SHAPES[name](n), dev)
    if dev.type != "cuda":
        raise ValueError(f"K5a/K5b take CUDA tensors, got {dev}")
    raise ValueError("the inputs do not fit K5a/K5b")


_COT_SHAPES = {"g_rgb": lambda n: (n, 3), "g_depth": lambda n: (n, 1), "g_acc": lambda n: (n, 1)}


def _f32_on(t, shape, dev: int) -> bool:
    return (t.dtype == torch.float32 and t.shape == shape and t.get_device() == dev
            and t.is_contiguous())


def _args(density, rgb, t_starts, t_ends, mask, alpha_thre, early_stop_eps, bg_color,
          background, **outs) -> _CompositeArgs:
    """The kernels' arguments, where they take these inputs; else raise
    through _refuse. The wrapper's host time is a good part of a call's,
    so the check is one expression over cheap tensor properties."""
    mode = _background_mode(bg_color, background)
    thr_t = alpha_thre if isinstance(alpha_thre, torch.Tensor) else None
    n, k = mask.shape[0], mask.shape[-1]
    dev = density.get_device()
    if not (density.is_cuda and k <= MAX_SAMPLES and mask.dim() == 2
            and _f32_on(density, (n, k, 1), dev) and _f32_on(rgb, (n, k, 3), dev)
            and _f32_on(t_starts, (n, k), dev) and _f32_on(t_ends, (n, k), dev)
            and mask.dtype == torch.bool and mask.get_device() == dev and mask.is_contiguous()
            and (mode != 1 or _f32_on(bg_color, (n, 3), dev))
            and (thr_t is None or _f32_on(thr_t, (), dev))
            and all(t is None or _f32_on(t, _COT_SHAPES[name](n), dev)
                    for name, t in outs.items())):
        _refuse(density, rgb, t_starts, t_ends, mask, alpha_thre, bg_color, mode, outs)
    cull = _culls(alpha_thre)

    def ptr(t):
        return None if t is None else t.data_ptr()

    return _CompositeArgs(
        density=density.data_ptr(), rgb=rgb.data_ptr(), t_starts=t_starts.data_ptr(),
        t_ends=t_ends.data_ptr(), mask=mask.data_ptr(), bg=ptr(bg_color) if mode == 1 else None,
        thr_ptr=ptr(thr_t), n=n, k=k, cull=int(cull), bg_mode=mode,
        thr=0.0 if thr_t is not None or not cull else float(alpha_thre),
        eps=float(early_stop_eps), **{name: ptr(t) for name, t in outs.items()},
    )


def composite_fwd(density, rgb, t_starts, t_ends, mask, alpha_thre=0.0,
                  early_stop_eps: float = 1e-4, bg_color=None, background: str = "linear"):
    """K5a: composite_fwd_plain's (rgb (n, 3), depth (n, 1), acc (n, 1))."""
    if density.device.type == "cpu":
        return composite_fwd_plain(density, rgb, t_starts, t_ends, mask, alpha_thre,
                                   early_stop_eps, bg_color, background)
    args = _args(density, rgb, t_starts, t_ends, mask, alpha_thre, early_stop_eps, bg_color,
                 background)
    n = mask.shape[0]
    out_rgb = torch.empty((n, 3), dtype=torch.float32, device=density.device)
    depth = torch.empty((n, 1), dtype=torch.float32, device=density.device)
    acc = torch.empty((n, 1), dtype=torch.float32, device=density.device)
    if n == 0:
        return out_rgb, depth, acc
    args.out_rgb, args.out_depth, args.out_acc = out_rgb.data_ptr(), depth.data_ptr(), acc.data_ptr()
    K5A.count(_library().composite_fwd(ctypes.byref(args), cuda_build.stream(density)))
    return out_rgb, depth, acc


def composite_bwd(density, rgb, t_starts, t_ends, mask, alpha_thre, early_stop_eps, bg_color,
                  background, g_rgb, g_depth, g_acc):
    """K5b: composite_bwd_plain's (d density (n, k, 1), d rgb (n, k, 3))."""
    if density.device.type == "cpu":
        return composite_bwd_plain(density, rgb, t_starts, t_ends, mask, alpha_thre,
                                   early_stop_eps, bg_color, background, g_rgb, g_depth, g_acc)
    args = _args(density, rgb, t_starts, t_ends, mask, alpha_thre, early_stop_eps, bg_color,
                 background, g_rgb=g_rgb, g_depth=g_depth, g_acc=g_acc)
    d_density = torch.empty_like(density)
    d_rgb = torch.empty_like(rgb)
    if mask.shape[0] == 0:
        return d_density, d_rgb
    args.d_density, args.d_rgb = d_density.data_ptr(), d_rgb.data_ptr()
    K5B.count(_library().composite_bwd(ctypes.byref(args), cuda_build.stream(density)))
    return d_density, d_rgb


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, density, rgb, t_starts, t_ends, mask, alpha_thre, early_stop_eps,
                bg_color, background):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(density, rgb, t_starts, t_ends, mask)
        ctx.rest = (alpha_thre, early_stop_eps, bg_color, background)
        return composite_fwd(density, rgb, t_starts, t_ends, mask, *ctx.rest)

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_acc):
        def c(g):
            return None if g is None else g.contiguous()

        d_density, d_rgb = composite_bwd(*ctx.saved_tensors, *ctx.rest, c(g_rgb), c(g_depth),
                                         c(g_acc))
        return d_density, d_rgb, None, None, None, None, None, None, None


def composite(density, rgb, samples: RaySamples, alpha_thre=0.0, early_stop_eps: float = 1e-4,
              bg_color=None, background: str = "linear"):
    """Differentiable (rgb (n, 3), depth (n, 1), accumulation (n, 1)) of
    (n, k, 1) densities and (n, k, 3) colours at `samples`: K5a forward,
    K5b backward (their plain versions on the CPU). alpha_thre is a float
    (0 turns culling off) or a 0-dim tensor; the background is `bg_color`
    (n, 3) where given, else `background` ("linear": none)."""
    return _Composite.apply(density.contiguous(), rgb.contiguous(), samples.t_starts.contiguous(),
                            samples.t_ends.contiguous(), samples.mask.contiguous(), alpha_thre,
                            early_stop_eps, bg_color, background)
