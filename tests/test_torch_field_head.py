"""The field's MLP head (lsenerf_tpu_torch/ops/field_head.py) on the CPU,
where `head` runs its plain version:
  - field_apply, field_apply_strided, the compact chunks' field_apply and
    density_fn equal the chain of torch ops the port ran before K9a/K9b
    (`_today`, below) bit for bit, outputs and every gradient, in both
    compute dtypes, with and without codes, one code a ray of k > 1
    samples and one a sample (m == n), and density alone;
  - the dispatch: a CPU tensor takes the plain version and builds no
    kernel call; on the card (stood in for) the kernels take the presets'
    widths, and any other hidden width, SH degree, a layout past the card's
    shared memory or a density-only call that needs a gradient raises
    ValueError naming it (the card never runs the plain version instead);
  - the autograd Function asks K9b for the gradients autograd wants
    (`needs_input_grad`): a frozen field asks for no weight gradient, the
    codes' and directions' only where they need one;
  - the split the kernels' tensor-core products take: three bf16 pieces
    that sum back to an f32 bit for bit, and the pieces' products they keep
    (field_head.KEPT) within 2^-23 of the f64 product, which fewer do not
    hold.
K9a/K9b themselves run only on the card: tests/test_torch_kernels_card.py.

This file imports neither JAX nor the JAX package.
"""

import dataclasses

import pytest
import torch

from lsenerf_tpu_torch.models import embeddings as emb_lib
from lsenerf_tpu_torch.models import field as tfield
from lsenerf_tpu_torch.models import mlp
from lsenerf_tpu_torch.ops import field_head as fh
from lsenerf_tpu_torch.ops import hash_encoding as he
from lsenerf_tpu_torch.ops import sh

HASH = he.HashEncodingConfig(num_levels=4, base_res=4, max_res=32, layout="blocked",
                             blocked_rows_log2=8)


# -- the chain before K9a/K9b (models/field.py of the parent commit) ---------------


def _mlp_input(x, config):
    if config.compute_dtype == "bfloat16":
        return x.to(torch.bfloat16).float()
    return x


def _density_head(params, feats, selector, config):
    h = mlp.apply_mlp(params["base_mlp"], _mlp_input(feats, config))
    density_before, geo = h[..., :1], h[..., 1:]
    density = config.average_init_density * tfield.trunc_exp(density_before)
    return density * selector[..., None], geo


def _codes(params, appearance_id, n, config, train):
    ids = appearance_id.reshape(-1)
    emb = emb_lib.apply_embedding(params["appearance"], config.embedding, ids, train=train)
    m = ids.shape[0]
    if m == n:
        return emb
    return emb[:, None, :].expand(m, n // m, emb.shape[1]).reshape(n, emb.shape[1])


def _color(params, geo, directions, appearance_id, config, train):
    pieces = [sh.sh_encode(directions, config.sh_levels), geo]
    if "appearance" in params:
        pieces.append(_codes(params, appearance_id, geo.shape[0], config, train))
    h = torch.cat(pieces, dim=-1)
    return mlp.apply_mlp(params["color_mlp"], _mlp_input(h, config), out_activation=torch.sigmoid)


def _today(params, positions, directions, appearance_id, config, train=True, ts=None):
    if ts is None:
        unit, selector = tfield.contract_positions(positions, config)
        feats = he.hash_encode(params["hash_table"], unit, config.hash)
    else:
        n, k, _ = positions.shape
        unit, selector = tfield.contract_positions(positions.reshape(-1, 3), config)
        feats = tfield._strided_encode(params, unit.reshape(n, k, 3), ts, config, selector)
    density, geo = _density_head(params, feats, selector, config)
    if directions is None:
        return density, None
    return density, _color(params, geo, directions, appearance_id, config, train)


# -- inputs -------------------------------------------------------------------------


def _config(dtype="bfloat16", emb=32, evs=True, **kw):
    return tfield.FieldConfig(
        hash=HASH, compute_dtype=dtype, appearance_embedding_dim=emb,
        embedding=emb_lib.EmbeddingConfig(embedding_type="evs_emb" if evs else "global_emb"),
        average_init_density=0.7, **kw)


def _inputs(config, rays=6, k=8, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = tfield.init_field(gen, config, num_imgs=5)
    params["hash_table"] = torch.rand(params["hash_table"].shape, generator=gen) * 2 - 1
    pos = (torch.rand((rays, k, 3), generator=gen) - 0.5) * 3.0
    dirs = torch.nn.functional.normalize(torch.randn((rays * k, 3), generator=gen), dim=-1)
    ids = torch.randint(0, 5, (rays,), generator=gen)
    ts = torch.cumsum(torch.rand((rays, k), generator=gen) * 0.1 + 0.01, dim=1)
    return params, pos, dirs, ids, ts


def _leaves(params, dirs):
    """Every float leaf of the field, and the directions, requiring grad."""
    out = []
    for tree in (params["base_mlp"], params["color_mlp"], params.get("appearance", {})):
        for key, t in tree.items():
            tree[key] = t.detach().requires_grad_(True)
            out.append(tree[key])
    params["hash_table"] = params["hash_table"].detach().requires_grad_(True)
    return out + [params["hash_table"], dirs.requires_grad_(True)]


def _same(a, b):
    return a.shape == b.shape and torch.equal(a, b)


def _grads_of(fn, params, dirs):
    leaves = _leaves(params, dirs)
    density, rgb = fn()
    loss = (density * torch.linspace(0.5, 1.5, density.numel()).reshape(density.shape)).sum()
    if rgb is not None:
        loss = loss + (rgb * torch.linspace(-1.0, 1.0, rgb.numel()).reshape(rgb.shape)).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return (density, rgb), grads


def _check_bits(got, want):
    (gd, gr), gg = got
    (wd, wr), wg = want
    assert _same(gd, wd)
    assert (gr is None and wr is None) or _same(gr, wr)
    for g, w in zip(gg, wg):
        assert (g is None and w is None) or _same(g, w)


# -- the plain version is today's chain -----------------------------------------------


CASES = {
    "bf16, codes a ray of 8": dict(dtype="bfloat16"),
    "f32, codes a ray of 8": dict(dtype="float32"),
    "bf16, one global code": dict(dtype="bfloat16", evs=False),
    "f32, no codes": dict(dtype="float32", emb=0),
    "bf16, no codes": dict(dtype="bfloat16", emb=0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_field_apply_is_todays_chain(case):
    config = _config(**CASES[case])
    params, pos, dirs, ids, _ = _inputs(config)
    flat = pos.reshape(-1, 3)
    got = _grads_of(lambda: tfield.field_apply(params, flat, dirs, ids, config), params, dirs)
    want = _grads_of(lambda: _today(params, flat, dirs, ids, config), params, dirs)
    _check_bits(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_one_code_a_sample_is_todays_chain(dtype):
    """m == n: the compact chunks' ids, one a sample."""
    config = _config(dtype)
    params, pos, dirs, ids, _ = _inputs(config)
    flat = pos.reshape(-1, 3)
    per_sample = ids[:, None].expand(6, 8).reshape(-1)
    got = _grads_of(lambda: tfield.field_apply(params, flat, dirs, per_sample, config), params,
                    dirs)
    want = _grads_of(lambda: _today(params, flat, dirs, per_sample, config), params, dirs)
    _check_bits(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_strided_field_is_todays_chain(dtype):
    config = dataclasses.replace(_config(dtype), coarse_stride=3, coarse_levels=2)
    params, pos, dirs, ids, ts = _inputs(config)
    got = _grads_of(lambda: tfield.field_apply_strided(params, pos, ts, dirs, ids, config),
                    params, dirs)
    want = _grads_of(lambda: _today(params, pos, dirs, ids, config, ts=ts), params, dirs)
    _check_bits(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_density_alone_is_todays_chain(dtype):
    config = _config(dtype)
    params, pos, dirs, ids, _ = _inputs(config)
    flat = pos.reshape(-1, 3)
    got = _grads_of(lambda: (tfield.density_fn(params, flat, config), None), params, dirs)
    want = _grads_of(lambda: _today(params, flat, None, ids, config), params, dirs)
    _check_bits(got, want)
    with torch.no_grad():
        assert _same(tfield.density_fn(params, flat, config),
                     _today(params, flat, None, ids, config)[0])
        feats, selector = tfield._features(params, flat, config)
        density, rgb = tfield.head_plain(params["base_mlp"], None, feats, selector, None, None,
                                         config.average_init_density,
                                         config.compute_dtype == "bfloat16")
    assert rgb is None and _same(density, _density_head(params, feats, selector, config)[0])


def test_eval_codes_are_todays_chain():
    """An eval render: the mean code, no gradient."""
    config = dataclasses.replace(_config(), embedding=emb_lib.EmbeddingConfig(
        embedding_type="evs_emb", eval_mode="mean"))
    params, pos, dirs, ids, _ = _inputs(config)
    flat = pos.reshape(-1, 3)
    with torch.no_grad():
        got = tfield.field_apply(params, flat, dirs, ids, config, train=False)
        want = _today(params, flat, dirs, ids, config, train=False)
    assert all(_same(g, w) for g, w in zip(got, want))


# -- the dispatch ----------------------------------------------------------------------


class _Recorder:
    """Stands in for the kernels' prepared call: records its arguments and
    what the backward is asked for, and answers with the plain version."""

    calls = []

    def __init__(self, base, color, feats, selector, dirs, codes, aid, bf16):
        self.args = (base, color, feats, selector, dirs, codes, aid, bf16)
        self.weights = [base[k] for k in fh.BASE_KEYS] + (
            [color[k] for k in fh.COLOR_KEYS] if dirs is not None else [])
        self.wanted = None
        _Recorder.calls.append(self)

    def forward(self, save=False):
        self.saved = save
        return fh.run(*self.args, plain=tfield.head_plain)

    def backward(self, g_density, g_rgb, wanted):
        assert self.saved, "K9b reads the activations K9a saves where a backward follows"
        self.wanted = tuple(wanted)
        n = self.args[2].shape[0]
        g_density = torch.zeros((n, 1)) if g_density is None else g_density
        g_rgb = torch.zeros((n, 3)) if g_rgb is None else g_rgb
        grads = fh.run(*self.args, g_density, g_rgb, plain=tfield.head_plain)
        return [g if w else None for g, w in zip(grads, wanted)]


def _stand_in(monkeypatch, smem=199_344):
    """The head as it runs on the card, the kernels' call stood in for."""
    _Recorder.calls = []
    monkeypatch.setattr(tfield, "_on_card", lambda t: True)
    monkeypatch.setattr(fh, "_smem", lambda D, E: smem)
    monkeypatch.setattr(fh, "Call", _Recorder)
    return _Recorder.calls


@pytest.fixture
def on_card(monkeypatch):
    return _stand_in(monkeypatch)


def test_a_cpu_tensor_takes_the_plain_version(monkeypatch):
    def refuse(*a):
        raise AssertionError("a kernel call was built for CPU tensors")

    monkeypatch.setattr(fh, "Call", refuse)
    config = _config()
    params, pos, dirs, ids, _ = _inputs(config)
    tfield.field_apply(params, pos.reshape(-1, 3), dirs, ids, config)
    tfield.density_fn(params, pos.reshape(-1, 3), config)


def test_the_cells_widths_take_the_kernels(on_card):
    for kw in (dict(), dict(dtype="float32"), dict(evs=False), dict(emb=0)):
        config = _config(**kw)
        params, pos, dirs, ids, _ = _inputs(config)
        with torch.no_grad():
            tfield.field_apply(params, pos.reshape(-1, 3), dirs, ids, config)
            tfield.density_fn(params, pos.reshape(-1, 3), config)
    assert len(on_card) == 8
    assert [c.args[4] is None for c in on_card] == [False, True] * 4


OTHER = {"hidden 32": ("base MLP", dict(hidden_dim=32)),
         "colour hidden 128": ("colour MLP", dict(hidden_dim_color=128)),
         "sh degree 3": ("SH of 3 levels", dict(sh_levels=3)),
         "layers 3": ("base MLP", dict(num_layers=3)),
         "past shared memory": ("shared memory", {}),
         "density with a gradient": ("density alone with a gradient", {})}


@pytest.mark.parametrize("width", list(OTHER))
def test_other_widths_take_the_plain_version(monkeypatch, width):
    """On a CPU tensor, today's chain bit for bit; on the card (stood in
    for), a ValueError naming what the kernels do not take, and no call."""
    named, kw = OTHER[width]
    config = _config(**kw)
    params, pos, dirs, ids, _ = _inputs(config)
    flat = pos.reshape(-1, 3)
    if width == "density with a gradient":
        _leaves(params, dirs)
        run = (lambda: tfield.density_fn(params, flat, config))  # noqa: E731
        d = run()
        assert d.requires_grad and _same(d, _today(params, flat, None, ids, config)[0])
    else:
        run = (lambda: tfield.field_apply(params, flat, dirs, ids, config))  # noqa: E731
        with torch.no_grad():
            got, want = run(), _today(params, flat, dirs, ids, config)
        assert all(_same(g, w) for g, w in zip(got, want))
    calls = _stand_in(monkeypatch, fh.SMEM_LIMIT + 4 if width == "past shared memory"
                      else 199_344)
    with torch.no_grad() if width != "density with a gradient" else torch.enable_grad():
        with pytest.raises(ValueError, match="do not take") as e:
            run()
    assert named in str(e.value)
    assert calls == []


def test_fits_reads_the_shapes(monkeypatch):
    """field_head.refusal: None where the kernels take the shapes, else
    what they do not take."""
    monkeypatch.setattr(fh, "_smem", lambda D, E: 199_344 if D <= 48 else fh.SMEM_LIMIT + 4)
    config = _config()
    params = tfield.init_field(torch.Generator().manual_seed(0), config, num_imgs=5)
    base, color = params["base_mlp"], params["color_mlp"]
    feats = torch.zeros((10, config.hash.out_dim))
    codes = torch.zeros((10, 32))
    assert fh.refusal(base, color, feats, codes) is None
    assert fh.refusal(base, None, feats, None) is None
    assert "colour MLP" in fh.refusal(base, color, feats, None)  # 63 inputs
    assert "float64" in fh.refusal(base, color, feats.double(), codes)
    assert "SH of 3 levels" in fh.refusal(base, color, feats, codes, sh_levels=3)
    assert "128 features" in fh.refusal(base, color, torch.zeros((10, 128)), codes)
    assert "80-wide appearance codes" in fh.refusal(base, color, feats, torch.zeros((10, 80)))
    wide = {"w0": torch.zeros((64, 64)), **{k: base[k] for k in ("b0", "w1", "b1")}}
    assert "shared memory" in fh.refusal(wide, color, torch.zeros((10, 64)), codes)


# -- which gradients K9b is asked for ---------------------------------------------------


def _wanted_after_backward(config, freeze_field=False, dirs_grad=True, table_grad=True,
                           codes_grad=False):
    params, pos, dirs, ids, _ = _inputs(config)
    leaves = _leaves(params, dirs)
    if freeze_field:
        for t in leaves[:-2]:
            t.requires_grad_(False)
        params["hash_table"].requires_grad_(table_grad)
        params["appearance"]["table"].requires_grad_(codes_grad)
    dirs.requires_grad_(dirs_grad)
    density, rgb = tfield.field_apply(params, pos.reshape(-1, 3), dirs, ids, config)
    (density.sum() + rgb.sum()).backward()
    (call,) = [c for c in _Recorder.calls if c.wanted is not None]
    return call.wanted, params, dirs


def test_a_training_step_asks_for_every_gradient(on_card):
    wanted, params, dirs = _wanted_after_backward(_config())
    assert wanted == (True,) * 13
    assert params["hash_table"].grad is not None and dirs.grad is not None
    assert params["appearance"]["table"].grad is not None
    assert all(t.grad is not None for t in params["color_mlp"].values())


def test_a_frozen_field_asks_for_no_weight_gradient(on_card):
    """eval.sh's camera-only refinement: the features' and directions'
    cotangents only."""
    wanted, params, dirs = _wanted_after_backward(_config(), freeze_field=True)
    assert wanted == (True, True, False) + (False,) * 10
    assert dirs.grad is not None
    assert all(t.grad is None for t in params["base_mlp"].values())


def test_fixed_directions_and_table_ask_for_no_cotangent_of_theirs(on_card):
    """Only the codes train (emb_eval's test embedding under a frozen field
    and fixed cameras): the codes' cotangent alone."""
    wanted, params, _ = _wanted_after_backward(_config(), freeze_field=True, dirs_grad=False,
                                               table_grad=False, codes_grad=True)
    assert wanted == (False, False, True) + (False,) * 10
    assert params["appearance"]["table"].grad is not None


# -- the split of the kernels' tensor-core products ----------------------------------


def _spread(gen, shape):
    """N(0, 1) times 10^u, u uniform in [-3, 3]: six decades."""
    return torch.randn(shape, generator=gen) * 10 ** (torch.rand(shape, generator=gen) * 6 - 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_pieces_sum_back_bit_for_bit(seed):
    """split_bf16's pieces sum to x in f32 exactly, each at most 2^-8 of
    the one before, over sixty decades and at zero and +-1."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(4096, generator=gen) * 10 ** (torch.rand(4096, generator=gen) * 60 - 30)
    x = torch.cat([x, torch.tensor([0.0, 1.0, -1.0, 3.0e38, -1.5e-30])])
    h, m, l = fh.split_bf16(x)
    assert (h.dtype, m.dtype, l.dtype) == (torch.bfloat16,) * 3
    assert torch.equal((h.float() + m.float()) + l.float(), x)
    assert (m.float().abs() <= x.abs() * 2.0**-8).all()
    assert (l.float().abs() <= x.abs() * 2.0**-16).all()


@pytest.mark.parametrize("shape", [(64, 64, 64), (256, 32, 64), (64, 96, 16)])
@pytest.mark.parametrize("seed", [0, 1])
def test_kept_terms_hold_f32_accuracy(shape, seed):
    """The pieces' products the kernels keep, each exact and summed in f64,
    are within 2^-23 of the f64 product of the f32 operands at every
    element, relative to sum |a||b| (the dropped ml, lm, ll are under
    2^-24 together), on operands spread over six decades; hh alone and hh
    + hm + mh are not. An operand that is bf16 already takes three terms,
    exactly."""
    M, K, N = shape
    gen = torch.Generator().manual_seed(seed)
    a, b = _spread(gen, (M, K)), _spread(gen, (K, N))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    pa, pb = fh.split_bf16(a), fh.split_bf16(b)

    def worst(terms):
        got = sum(pa[i].double() @ pb[j].double() for i, j in terms)
        return float(((got - exact).abs() / scale).max())

    assert worst(fh.KEPT) <= 2.0**-23
    assert worst(((0, 0),)) > 2.0**-23
    assert worst(((0, 0), (0, 1), (1, 0))) > 2.0**-23
    ab = a.bfloat16().double()
    three = sum(ab @ p.double() for p in pb)
    torch.testing.assert_close(three, ab @ b.double(), rtol=0, atol=float(scale.max()) * 2.0**-45)
