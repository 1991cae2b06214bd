"""Volume compositing in plain PyTorch: the frozen copy of the port's
ops/composite.py without its kernels (K5a/K5b). `composite_fwd` and
`composite_bwd` run the plain versions on any device, under the same
autograd function."""

from __future__ import annotations


import torch

from perfbench.frozen.ref.cameras.rays import RaySamples


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


def composite_fwd(density, rgb, t_starts, t_ends, mask, alpha_thre=0.0,
                  early_stop_eps: float = 1e-4, bg_color=None, background: str = "linear"):
    return composite_fwd_plain(density, rgb, t_starts, t_ends, mask, alpha_thre,
                               early_stop_eps, bg_color, background)


def composite_bwd(density, rgb, t_starts, t_ends, mask, alpha_thre, early_stop_eps, bg_color,
                  background, g_rgb, g_depth, g_acc):
    return composite_bwd_plain(density, rgb, t_starts, t_ends, mask, alpha_thre,
                               early_stop_eps, bg_color, background, g_rgb, g_depth, g_acc)


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
