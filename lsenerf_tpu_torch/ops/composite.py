"""Volume-rendering compositing over dense masked samples.
Port of lsenerf_tpu/ops/composite.py, with its inf-safe masking and the
shifted exclusive cumsum (composite.py:45-75).

render_bundle composites through `composite`: K5a `composite_fwd` and K5b
`composite_bwd` (csrc/composite.cu, built and loaded by cuda_build) inside
one autograd Function, at any number of samples a ray. Their plain
versions are `composite_fwd_plain`, the chain render_weights -> render_rgb
/ render_depth / render_accumulation, and `composite_bwd_plain`, its
backward written out. A wrapper runs the plain version for CPU tensors
only; for CUDA tensors it launches its kernel or raises. A wrapper finds
its launch (the kernels' scalar arguments) by one dict lookup and writes a
call's pointers with one struct.pack_into: its host time is a good part of
a call's."""

from __future__ import annotations

import ctypes
import functools
import struct

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


# early stop keeps a sample where its transmittance T > early_stop_eps: a
# discontinuity. Two f32 sums of the same terms in other orders differ by an
# ulp or two, so where T lies within that of eps (a tie) the kernels and the
# plain versions may decide the sample apart. A tie is decided by the plain
# version at early_stop_eps nudged by this relative amount either way.
TIE = 1e-6


def rays_off_plain(got, plain, args, extra=(), rtol: float = 1e-5, atol: float = 1e-6):
    """(rays whose outputs in `got` differ from plain(*args, *extra) beyond
    rtol / atol, also with early_stop_eps (args[6]) nudged by TIE either
    way; rays that match only with it nudged: the ties), bool (n,) each.
    args are composite_fwd's nine arguments, extra composite_bwd's
    cotangents; got is the kernel's outputs on them."""
    n = args[4].shape[0]

    def off(want):
        bad = torch.zeros(n, dtype=torch.bool, device=got[0].device)
        for g, w in zip(got, want):
            bad |= ~torch.isclose(g, w, rtol=rtol, atol=atol).reshape(n, -1).all(1)
        return bad

    bad = off(plain(*args, *extra))
    eps = args[6]
    if not bad.any() or eps <= 0.0:
        return bad, torch.zeros_like(bad)
    up, down = (off(plain(*args[:6], eps * (1.0 + d * TIE), *args[7:], *extra)) for d in (1, -1))
    return bad & up & down, bad & ~(up & down)


class _CompositeArgs(ctypes.Structure):
    """csrc/composite.cu's CompositeArgs, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "density", "rgb", "t_starts", "t_ends", "mask", "bg", "thr_ptr", "g_rgb", "g_depth",
        "g_acc", "out_rgb", "out_depth", "out_acc", "d_density", "d_rgb")]
        + [(f, ctypes.c_int) for f in ("n", "k", "cull", "bg_mode")]
        + [(f, ctypes.c_float) for f in ("thr", "eps")])


# a call's own fields, written at once: the fifteen pointers, then n
_CALL = struct.Struct("@15Pi")


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load(SOURCE)
    for name in ("composite_fwd", "composite_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_CompositeArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.composite_blocks.argtypes = [ctypes.POINTER(_CompositeArgs)]
    lib.composite_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.composite_blocks.restype = lib.composite_empty.restype = ctypes.c_int
    return lib


def launch_blocks(n: int, k: int) -> int:
    """The blocks of 128 threads that K5a and K5b launch for n rays of k
    samples (csrc/composite.cu picks its layout from k). For timing."""
    return _library().composite_blocks(_CompositeArgs(n=n, k=k))


def launch_empty(blocks: int, like: torch.Tensor) -> None:
    """An empty kernel on `blocks` blocks of 128 threads, on the current
    stream of like's CUDA device: the launch floor that K5a's and K5b's
    device times are read against. For timing; on no path, counted by no
    launch counter."""
    err = _library().composite_empty(blocks, 128, cuda_build.stream(like))
    if err:
        raise RuntimeError(f"the empty kernel's launch failed: cudaError {err}")


_COT_SHAPES = {"g_rgb": lambda n: (n, 3), "g_depth": lambda n: (n, 1), "g_acc": lambda n: (n, 1)}


def _refuse(density, rgb, t_starts, t_ends, mask, alpha_thre, bg_color, mode, outs):
    """Raise ValueError naming the first check the inputs fail: all on one
    CUDA device, f32, the shapes of n rays of k samples. The device's type
    is checked last."""
    dev = density.device
    n, k = mask.shape[0], mask.shape[-1]
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


class _Launch:
    """K5a/K5b's arguments for one (k, background, culling threshold,
    early_stop_eps, device): the scalars filled in; a call writes the
    pointers and n."""

    __slots__ = ("args", "mode", "tensor_thr")

    def __init__(self, k: int, bg_color, background: str, alpha_thre, early_stop_eps: float):
        self.mode = _background_mode(bg_color, background)
        self.tensor_thr = isinstance(alpha_thre, torch.Tensor)
        cull = _culls(alpha_thre)
        self.args = _CompositeArgs(
            k=k, cull=int(cull), bg_mode=self.mode,
            thr=float(alpha_thre) if cull and not self.tensor_thr else 0.0,
            eps=float(early_stop_eps))


# (k, background or None where bg_color is given, the float threshold or
# "tensor", early_stop_eps, device) -> _Launch
_LAUNCHES: dict = {}


def _launch_for(k: int, bg_color, background: str, alpha_thre, early_stop_eps: float,
                dev: int) -> _Launch:
    """The launch of a call, found by one dict lookup: a float threshold's
    value and a tensor threshold are keys apart, as are the backgrounds."""
    key = (k, background if bg_color is None else None,
           "tensor" if isinstance(alpha_thre, torch.Tensor) else alpha_thre, early_stop_eps, dev)
    ln = _LAUNCHES.get(key)
    if ln is None:
        if len(_LAUNCHES) >= 64:
            _LAUNCHES.clear()
        ln = _LAUNCHES[key] = _Launch(k, bg_color, background, alpha_thre, early_stop_eps)
    return ln


def _checked(density, rgb, t_starts, t_ends, mask, alpha_thre, early_stop_eps, bg_color,
             background, g_rgb=None, g_depth=None, g_acc=None):
    """(the call's _Launch, n, its CUDA device) where K5a/K5b take these
    inputs; else raise through _refuse. The wrapper's host time is a good
    part of a call's, so the check is one expression over cheap tensor
    properties, written out."""
    shape = mask.shape
    n, k = shape[0], shape[-1]
    dev = density.get_device()
    ln = _launch_for(k, bg_color, background, alpha_thre, early_stop_eps, dev)
    f32 = torch.float32
    if not (density.is_cuda and len(shape) == 2
            and density.dtype == f32 and density.shape == (n, k, 1) and density.is_contiguous()
            and rgb.dtype == f32 and rgb.shape == (n, k, 3) and rgb.get_device() == dev
            and rgb.is_contiguous()
            and t_starts.dtype == f32 and t_starts.shape == shape
            and t_starts.get_device() == dev and t_starts.is_contiguous()
            and t_ends.dtype == f32 and t_ends.shape == shape and t_ends.get_device() == dev
            and t_ends.is_contiguous()
            and mask.dtype == torch.bool and mask.get_device() == dev and mask.is_contiguous()
            and (ln.mode != 1 or (bg_color.dtype == f32 and bg_color.shape == (n, 3)
                                  and bg_color.get_device() == dev and bg_color.is_contiguous()))
            and (not ln.tensor_thr or (alpha_thre.dtype == f32 and alpha_thre.dim() == 0
                                    and alpha_thre.get_device() == dev))
            and (g_rgb is None or (g_rgb.dtype == f32 and g_rgb.shape == (n, 3)
                                   and g_rgb.get_device() == dev and g_rgb.is_contiguous()))
            and (g_depth is None or (g_depth.dtype == f32 and g_depth.shape == (n, 1)
                                     and g_depth.get_device() == dev and g_depth.is_contiguous()))
            and (g_acc is None or (g_acc.dtype == f32 and g_acc.shape == (n, 1)
                                   and g_acc.get_device() == dev and g_acc.is_contiguous()))):
        _refuse(density, rgb, t_starts, t_ends, mask, alpha_thre, bg_color, ln.mode,
                dict(g_rgb=g_rgb, g_depth=g_depth, g_acc=g_acc))
    return ln, n, dev


def composite_fwd(density, rgb, t_starts, t_ends, mask, alpha_thre=0.0,
                  early_stop_eps: float = 1e-4, bg_color=None, background: str = "linear"):
    """K5a: composite_fwd_plain's (rgb (n, 3), depth (n, 1), acc (n, 1))."""
    if not density.is_cuda and density.device.type == "cpu":
        return composite_fwd_plain(density, rgb, t_starts, t_ends, mask, alpha_thre,
                                   early_stop_eps, bg_color, background)
    ln, n, dev = _checked(density, rgb, t_starts, t_ends, mask, alpha_thre, early_stop_eps,
                          bg_color, background)
    # sizes as ints, not a tuple: the cheapest allocation on the host
    out_rgb, depth, acc = density.new_empty(n, 3), density.new_empty(n, 1), \
        density.new_empty(n, 1)
    if n == 0:
        return out_rgb, depth, acc
    args = _CompositeArgs.from_buffer_copy(ln.args)
    _CALL.pack_into(args, 0, density.data_ptr(), rgb.data_ptr(), t_starts.data_ptr(),
                    t_ends.data_ptr(), mask.data_ptr(), bg_color.data_ptr() if ln.mode == 1 else 0,
                    alpha_thre.data_ptr() if ln.tensor_thr else 0, 0, 0, 0, out_rgb.data_ptr(),
                    depth.data_ptr(), acc.data_ptr(), 0, 0, n)
    # the current stream, read on every call (cuda_build.stream)
    K5A.count(_library().composite_fwd(args, torch._C._cuda_getCurrentRawStream(dev)))
    return out_rgb, depth, acc


def composite_bwd(density, rgb, t_starts, t_ends, mask, alpha_thre, early_stop_eps, bg_color,
                  background, g_rgb, g_depth, g_acc):
    """K5b: composite_bwd_plain's (d density (n, k, 1), d rgb (n, k, 3))."""
    if not density.is_cuda and density.device.type == "cpu":
        return composite_bwd_plain(density, rgb, t_starts, t_ends, mask, alpha_thre,
                                   early_stop_eps, bg_color, background, g_rgb, g_depth, g_acc)
    ln, n, dev = _checked(density, rgb, t_starts, t_ends, mask, alpha_thre, early_stop_eps,
                          bg_color, background, g_rgb, g_depth, g_acc)
    d_density, d_rgb = torch.empty_like(density), torch.empty_like(rgb)
    if n == 0:
        return d_density, d_rgb
    args = _CompositeArgs.from_buffer_copy(ln.args)
    _CALL.pack_into(args, 0, density.data_ptr(), rgb.data_ptr(), t_starts.data_ptr(),
                    t_ends.data_ptr(), mask.data_ptr(), bg_color.data_ptr() if ln.mode == 1 else 0,
                    alpha_thre.data_ptr() if ln.tensor_thr else 0,
                    0 if g_rgb is None else g_rgb.data_ptr(),
                    0 if g_depth is None else g_depth.data_ptr(),
                    0 if g_acc is None else g_acc.data_ptr(), 0, 0, 0, d_density.data_ptr(),
                    d_rgb.data_ptr(), n)
    K5B.count(_library().composite_bwd(args, torch._C._cuda_getCurrentRawStream(dev)))
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
