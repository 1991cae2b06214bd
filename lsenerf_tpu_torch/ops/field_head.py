"""K9a/K9b: the field's MLP head (the field layer after the encode) in one
kernel each way.

The head takes the encode's features, the in-bounds selector, the
directions and the rays' appearance codes to density and rgb: the base MLP
on the features (bf16-rounded where compute_dtype is bfloat16), density =
average_init_density * trunc_exp(h[0]) * selector, then the colour MLP on
[SH(directions), geo = h[1:], the codes] (rounded likewise) and a sigmoid.
Its plain version is models/field.py's `head_plain`, which models/field.py's
`head` runs on CPU tensors; on CUDA tensors it runs this module's `head`:
K9a `head_fwd` forward and K9b `head_bwd` backward (csrc/field_head.cu,
built and loaded by cuda_build) inside one autograd Function, whose
gradients follow `needs_input_grad`: the features' cotangent
(bf16-rounded where the plain chain rounds it), the directions', the
codes' (each ray's k samples summed) and the ten weight and bias
gradients, none of these where the field is frozen.

K9b runs every product on the tensor cores at f32 accuracy: each f32
operand is split into three bf16 pieces that sum back to it exactly
(`split_bf16`), and a product keeps each cross term of 2^-24 of it or
more (KEPT: six bf16 MMAs, or three where an operand is bf16 already, as
the bf16-rounded MLP inputs are). Against f64 on an H100, one 64 -> 64
layer of 56,192 samples reads 4.7e-8 forward and 6.6e-8 for its input
cotangent (cuBLAS in f32: 1.0e-7 and 1.4e-7), 1.1e-7 and 1.2e-7 with
weights and activations spread over six decades; one bf16 product reads
2.3e-3 and TF32 2.7e-4 (PERF.md §6, PR 27). K9a stays f32 FMA in cuBLAS's
order: on the tensor cores its ReLUs fell the other way from the plain
chain's at a few units a step, which no product precision cures. Against
the plain chain the head is held to TOLERANCE.

The kernels take the widths the presets set: hidden 64, geo 15, SH degree
4, and num_levels * F and emb_dim up to MAX_WIDTH where K9b's layout fits a
block's shared memory (`refusal` reads the shapes). For anything else --
a wider input, another hidden width, a dtype other than float32, or a
density-only call that needs a gradient (the occupancy update's has none)
-- `head` raises ValueError naming it: the card never runs the plain
version in their place.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from lsenerf_tpu_torch.ops import cuda_build
from lsenerf_tpu_torch.ops.cuda_build import Kernel

SOURCE = cuda_build.CSRC / "field_head.cu"
K9A = Kernel("head_fwd")
K9B = Kernel("head_bwd")
KERNELS = (K9A, K9B)

HIDDEN, BASE_OUT, COLOR_OUT, SH_LEVELS = 64, 16, 3, 4
SMEM_LIMIT = 232448  # a block's dynamic shared memory on sm_90 (227 KB)
MAX_WIDTH = 64  # the features' and the codes' widest: a tile's inputs in 16 registers a thread
BASE_KEYS = ("w0", "b0", "w1", "b1")
COLOR_KEYS = ("w0", "b0", "w1", "b1", "w2", "b2")


# -- K9a/K9b -----------------------------------------------------------------------


class _HeadArgs(ctypes.Structure):
    """csrc/field_head.cu's HeadArgs, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "feats", "sel", "dirs", "codes", "w0", "b0", "w1", "b1", "v0", "c0", "v1", "c1", "v2",
        "c2", "density", "rgb", "saved", "g_density", "g_rgb", "g_feats", "g_dirs", "g_codes",
        "code_terms", "partials", "g_params")]
        + [("aid", ctypes.c_float)]
        + [(f, ctypes.c_int) for f in ("n", "m", "k", "D", "E", "code_stride", "bf16",
                                       "blocks")])


WEIGHTS = ("w0", "b0", "w1", "b1", "v0", "c0", "v1", "c1", "v2", "c2")
TILE, SAVED_ROWS = 64, 64 + 16 + 64 + 64  # csrc/field_head.cu's kT and kSaved

# the pieces' products K9b's products keep (csrc/field_head.cu's
# `product`): (i, j), A's piece i by B's piece j, about 2^(-8 (i + j)) of
# the product; the dropped ones (ml, lm, ll) are under 2^-24 together
KEPT = ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0))
MMA_FLOPS = 2 * 16 * 8 * 16  # an m16n8k16 MMA's multiply-adds, 2 operations each
BF16_FLOPS = 989e12  # the H100's dense bf16 tensor-core rate
F32_FLOPS = 67e12  # ... and its f32 FMA rate outside the tensor cores


def split_bf16(x: torch.Tensor) -> tuple:
    """float32 x as three bfloat16 pieces (h, m, l), each the remainder
    before it rounded to nearest even, whose sum in f32 is x exactly (for
    |x| above 2^-102): csrc/field_head.cu's split2."""
    h = x.to(torch.bfloat16)
    r = x - h.float()
    m = r.to(torch.bfloat16)
    return h, m, (r - m.float()).to(torch.bfloat16)


def macs(n: int, D: int, E: int, color: bool = True) -> int:
    """The multiply-adds of n samples' forward at their widths (the MLPs'
    products, unpadded); a backward takes as many again for the input
    cotangents and for the weight gradients."""
    per = D * 64 + 64 * 16
    if color:
        per += (31 + E) * 64 + 64 * 64 + 64 * 3
    return n * per


def bounds_ms(n: int, D: int, E: int, bf16: bool, color: bool = True,
              backward: bool = False) -> dict:
    """The least device ms of K9a (f32 FMA) or K9b (every gradient wanted)
    on n samples by operations alone: the multiply-adds at the f32 FMA rate,
    and K9b's MMAs (`mmas`) at the bf16 tensor-core rate."""
    out = {"f32_fma": 2 * macs(n, D, E, color) * (2 if backward else 1) / F32_FLOPS * 1e3}
    if backward:
        out["tensor_cores"] = mmas(n, D, E, bf16) * MMA_FLOPS / BF16_FLOPS * 1e3
    return out


def mmas(n: int, D: int, E: int, bf16: bool, weights: bool = True, features: bool = True) -> int:
    """The m16n8k16 MMAs K9b issues for n samples of D features and E-wide
    codes (the weight gradients where `weights`, the features' cotangent
    where `features`): each product's 16 x 8 output tiles times its depth's
    steps of 16 times its terms (six, or three where an operand is bf16: the
    MLP inputs in bf16), per 64-sample tile, padding included; the bias
    gradients are one more tile column."""
    Dp, Cp = -(-D // 16) * 16, -(-(31 + E) // 16) * 16
    t1 = 3 if bf16 else 6
    tile = 32 * 6 + 32 * 4 * 6 + Cp // 2 * 4 * 6 + 32 * 6
    if weights:
        tile += (8 * 4 * 6 + 4 * 3) + (32 * 4 * 6 + 16 * 3) + (Cp // 2 * 4 * t1 + 16 * 3)
        tile += (8 * 4 * 6 + 4 * 3) + (Dp // 2 * 4 * t1 + 16 * 3)
    if features:
        tile += Dp // 2 * 4 * 6
    return -(-n // TILE) * tile


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load(SOURCE)
    for name in ("head_fwd", "head_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_HeadArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.head_smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.head_smem.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _smem(D: int, E: int) -> int:
    """K9b's shared memory in bytes (K9a's is less)."""
    return _library().head_smem(D, E, 1)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def refusal(base: dict, color: Optional[dict], feats: torch.Tensor, codes,
            sh_levels: int = SH_LEVELS) -> Optional[str]:
    """What of these shapes K9a/K9b do not take, or None where they take
    them all: the base MLP D -> 64 -> 16, the colour MLP (31 + E) -> 64 ->
    64 -> 3 on degree-4 SH, D and E up to MAX_WIDTH, float32 features and
    weights, and K9b's layout within a block's shared memory."""
    D = feats.shape[-1]
    E = 0 if codes is None else codes.shape[-1]
    if D > MAX_WIDTH:
        return f"{D} features a sample (num_levels * features_per_level): at most {MAX_WIDTH}"
    if E > MAX_WIDTH:
        return f"{E}-wide appearance codes (emb_dim): at most {MAX_WIDTH}"
    want = {"w0": (D, HIDDEN), "b0": (HIDDEN,), "w1": (HIDDEN, BASE_OUT), "b1": (BASE_OUT,)}
    got = {k: tuple(t.shape) for k, t in base.items()}
    if got != want:
        return f"a base MLP of shapes {got}: they take {want}"
    tensors = [feats, *base.values()]
    if color is not None:
        if sh_levels != SH_LEVELS:
            return f"SH of {sh_levels} levels: they take {SH_LEVELS}"
        cin = SH_LEVELS**2 + BASE_OUT - 1 + E
        want = {"w0": (cin, HIDDEN), "b0": (HIDDEN,), "w1": (HIDDEN, HIDDEN), "b1": (HIDDEN,),
                "w2": (HIDDEN, COLOR_OUT), "b2": (COLOR_OUT,)}
        got = {k: tuple(t.shape) for k, t in color.items()}
        if got != want:
            return f"a colour MLP of shapes {got}: they take {want}"
        tensors += list(color.values())
    dtypes = sorted({str(t.dtype) for t in tensors} - {str(torch.float32)})
    if dtypes:
        return f"{', '.join(dtypes)} features or weights: they take torch.float32"
    if _smem(D, E) > SMEM_LIMIT:
        return (f"{D} features and {E}-wide codes together: K9b's layout takes {_smem(D, E)} "
                f"bytes of shared memory, past a block's {SMEM_LIMIT}")
    return None


def _need(name: str, t: torch.Tensor, dtype, shape, dev) -> torch.Tensor:
    cuda_build.check(name, t, (dtype,), shape, dev)
    return t


class Call:
    """One prepared call: the struct with the inputs and the tensors it
    points at, kept alive to the backward. `forward` launches K9a,
    `backward` K9b on the activations its forward(save=True) saved (the
    tools time K9b alone on one prepared call)."""

    def __init__(self, base, color, feats, selector, dirs, codes, aid: float, bf16: bool):
        n, D = feats.shape
        dev = feats.device
        a = self.args = _HeadArgs(n=n, D=D, aid=float(aid), bf16=int(bf16), m=n, k=1)
        sel = selector.reshape(n).contiguous()
        keep = [_need("features", feats.contiguous(), torch.float32, (n, D), dev),
                _need("selector", sel, torch.bool, (n,), dev).view(torch.uint8)]
        a.feats, a.sel = keep[0].data_ptr(), keep[1].data_ptr()
        weights = [base[k] for k in BASE_KEYS]
        if dirs is not None:
            weights += [color[k] for k in COLOR_KEYS]
            d = _need("directions", dirs.contiguous(), torch.float32, (n, 3), dev)
            a.dirs = d.data_ptr()
            keep.append(d)
            if codes is not None:
                m, E = codes.shape
                if m == 0 or n % m:
                    raise ValueError(f"{n} samples are not k rays of {m} codes")
                c = codes if codes.stride(1) == 1 else codes.contiguous()
                if c.dtype != torch.float32 or c.device != dev:
                    raise ValueError(f"codes are {c.dtype} on {c.device}, expected float32 on "
                                     f"{dev}")
                a.codes, a.code_stride, a.m, a.k, a.E = c.data_ptr(), c.stride(0), m, n // m, E
                keep.append(c)
        for name, w in zip(WEIGHTS, weights):
            setattr(a, name, _need(name, w, torch.float32, tuple(w.shape), dev).data_ptr())
        self.weights, self.keep, self.dev, self.n = weights, keep, dev, n

    def forward(self, save: bool = False):
        """K9a: (density (n, 1), rgb (n, 3) or None without directions);
        with `save` (a backward follows) it also writes each tile's
        activations for K9b (SAVED_ROWS rows of 64 samples a tile)."""
        a, n = self.args, self.n
        density = torch.empty((n, 1), dtype=torch.float32, device=self.dev)
        a.density = density.data_ptr()
        self.rgb = None
        if a.dirs:
            self.rgb = torch.empty((n, 3), dtype=torch.float32, device=self.dev)
            a.rgb = self.rgb.data_ptr()
            if save:
                self.saved = torch.empty((-(-n // TILE), SAVED_ROWS, TILE), dtype=torch.float32,
                                         device=self.dev)
                a.saved = self.saved.data_ptr()
        if n:
            K9A.count(_library().head_fwd(a, cuda_build.stream(density)))
        return density, self.rgb

    def backward(self, g_density, g_rgb, wanted) -> list:
        """K9b: the gradients of (features, directions, codes, the ten
        weights), None where not wanted; g_density / g_rgb None read
        zeros."""
        a = _HeadArgs.from_buffer_copy(self.args)
        if not a.saved:
            raise ValueError("K9b reads the activations K9a saved: call forward(save=True) first")
        n, D, E, m = a.n, a.D, a.E, a.m
        dev = self.dev
        out = [None] * (3 + len(self.weights))
        bufs = []

        def alloc(shape):
            bufs.append(torch.empty(shape, dtype=torch.float32, device=dev))
            return bufs[-1]

        if wanted[0]:
            out[0] = alloc((n, D))
            a.g_feats = out[0].data_ptr()
        if wanted[1] and a.dirs:
            out[1] = alloc((n, 3))
            a.g_dirs = out[1].data_ptr()
        if wanted[2] and a.codes:
            out[2] = alloc((m, E))
            a.g_codes = out[2].data_ptr()
            if a.k > 1:
                a.code_terms = alloc((n, E)).data_ptr()
        if any(wanted[3:3 + len(self.weights)]):
            sizes = [w.numel() for w in self.weights]
            flat = alloc((sum(sizes),))
            a.g_params = flat.data_ptr()
            at = 0
            for i, (w, size) in enumerate(zip(self.weights, sizes)):
                if wanted[3 + i]:
                    out[3 + i] = flat[at:at + size].view(w.shape)
                at += size
        if all(t is None for t in out) or not n:
            return out
        a.blocks = min(-(-n // TILE), _sms(dev.index if dev.index is not None else 0))
        if a.g_params:
            a.partials = alloc((a.blocks, flat.numel())).data_ptr()
        cots = []
        for name, g, c in (("g_density", g_density, 1), ("g_rgb", g_rgb, 3)):
            if g is not None:
                g = _need(name, g.contiguous(), torch.float32, (n, c), dev)
                setattr(a, name, g.data_ptr())
                cots.append(g)
        K9B.count(_library().head_bwd(a, cuda_build.stream(bufs[0])))
        return out


class _Head(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call, feats, dirs, codes, *weights):
        ctx.set_materialize_grads(False)
        ctx.call = call
        ctx.save_for_backward(feats, dirs, codes, *weights)
        return call.forward(save=True)

    @staticmethod
    def backward(ctx, g_density, g_rgb):
        ctx.saved_tensors  # noqa: B018 (raises if an input was changed in place)
        grads = ctx.call.backward(g_density, g_rgb, ctx.needs_input_grad[1:])
        ctx.call = None
        return (None, *grads)


def head(base: dict, color: Optional[dict], feats, selector, dirs, codes, aid: float, bf16: bool,
         sh_levels: int = SH_LEVELS):
    """models/field.py's head on CUDA tensors, by K9a/K9b: (density (n, 1),
    rgb (n, 3) or None without directions). Raises ValueError where they do
    not take the shapes (`refusal`) or where density alone needs a gradient."""
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (feats, dirs, codes, *base.values(), *(color or {}).values()))
    why = refusal(base, color if dirs is not None else None, feats, codes, sh_levels)
    if why is None and dirs is None and grad:
        why = "density alone with a gradient: K9b runs the colour MLP's backward"
    if why is not None:
        raise ValueError(f"the field head's kernels (K9a/K9b) do not take {why}")
    call = Call(base, color, feats, selector, dirs, codes, aid, bf16)
    if not grad:  # no backward follows: K9a alone, saving nothing
        return call.forward()
    return _Head.apply(call, feats, dirs, codes, *call.weights)


# -- the tools' entry (kernel_compare, chip_smoke, the card tests) -------------------


def run(base: dict, color: Optional[dict], feats, selector, dirs, codes, aid: float, bf16: bool,
        g_density=None, g_rgb=None, plain=None):
    """head's outputs (density, rgb), or, given the cotangents, the
    gradients of (features, directions, codes, the ten weights) under them
    (None where an input is None), by autograd through `head` (K9a, then
    K9a saving its activations and K9b) or through `plain` where given
    (models/field.py's head_plain). Keeps no graph."""
    fn = head if plain is None else plain
    if g_density is None and g_rgb is None:
        with torch.no_grad():
            return fn(base, color, feats, selector, dirs, codes, aid, bf16)
    inputs = [None if t is None else t.detach().requires_grad_(True)
              for t in (feats, dirs, codes)]
    ws = {k: w.detach().requires_grad_(True) for k, w in base.items()}
    cs = {k: w.detach().requires_grad_(True) for k, w in color.items()}
    leaves = [t for t in inputs if t is not None] + [ws[k] for k in BASE_KEYS] + [
        cs[k] for k in COLOR_KEYS]
    with torch.enable_grad():
        density, rgb = fn(ws, cs, inputs[0], selector, inputs[1], inputs[2], aid, bf16)
        grads = iter(torch.autograd.grad((density, rgb), leaves, (g_density, g_rgb)))
    return tuple(None if t is None else next(grads) for t in inputs) + tuple(grads)


# K9a/K9b against the plain version on the card: each output's relative
# error (the norm of the difference over the plain version's norm), a limit
# for the forward and one for the gradients. Set from readings at
# flagship.head_shapes' five shapes over six seeds on an H100 80GB HBM3
# (PERF.md §6), each limit 7-9x above the largest: the forward reads at most
# 2.7e-8 (the density is the plain version's bits; rgb differs by the f32
# sums' order); the gradients 2.1e-6 in f32 (b1's sum over ~10^5 samples)
# and 2.5e-5 where bf16 (a cotangent one f32 ulp apart rounds to the
# neighbouring bf16, 2^-8 relative, at a few samples; the directions').
# The control, the plain version with TF32 products, reads at least 1.2e-5
# forward and 1.9e-2 at its largest gradient: every limit refuses it.
TOLERANCE = {False: (2e-7, 1.5e-5), True: (2e-7, 2e-4)}
OUTPUTS = ("density", "rgb")
GRADIENTS = ("features", "directions", "codes") + WEIGHTS


def errors(got, want, names) -> dict:
    """{name: relative error} of the outputs present on both sides; raises
    where one side has an output the other lacks."""
    out = {}
    for name, g, w in zip(names, got, want):
        if (g is None) != (w is None):
            raise AssertionError(f"{name}: {'no' if g is None else 'an'} output where the plain "
                                 f"version has {'one' if w is not None else 'none'}")
        if w is not None:
            out[name] = float((g.double() - w.double()).norm() / max(float(w.double().norm()),
                                                                      1e-30))
    return out


def off_plain(got, want, bf16: bool, backward: bool) -> dict:
    """{name: (error, limit)} of the outputs past TOLERANCE."""
    limit = TOLERANCE[bool(bf16)][int(backward)]
    errs = errors(got, want, GRADIENTS if backward else OUTPUTS)
    return {k: (e, limit) for k, e in errs.items() if not e <= limit}
