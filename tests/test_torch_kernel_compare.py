"""The kernel A/B tool's table (lsenerf_tpu_torch/kernel_compare.py) on the
CPU, where every wrapper runs its plain version:
  - each entry's C entries are defined in its wrapper module's source;
  - each kernel's check holds the package's wrapper at a small shape, and
    refuses a build whose output is off the plain version;
  - `rows` repeats or cuts a shape's rows and leaves the rest;
  - the tool exits 1 without a card, and refuses --wide where an entry has
    no cases past its layout.

This file imports neither JAX nor the JAX package.
"""

import re

import pytest
import torch

from lsenerf_tpu_torch import kernel_compare as kc
from lsenerf_tpu_torch.ops import hash_encoding as he
from lsenerf_tpu_torch.ops import march
from lsenerf_tpu_torch.ops import occupancy as occ_lib

KERNELS = [(entry, k.name) for entry, e in kc.TABLE.items() for k in e.kernels]


def _encode(layout: str, F: int, gen):
    """(positions, table, cotangent, levels) at 2 levels of a small table."""
    hcfg = he.HashEncodingConfig(layout=layout, num_levels=2, features_per_level=F,
                                 log2_hashmap_size=10, blocked_rows_log2=6, base_res=4,
                                 max_res=32)
    pos = torch.rand((64, 3), generator=gen)
    table = torch.rand(hcfg.table_shape, generator=gen) * 2 - 1
    if layout == "blocked":
        table = table.to(torch.bfloat16)
    gfeat = torch.randn((64, hcfg.out_dim), generator=gen)
    return pos, table, gfeat, he.levels_for(hcfg, "cpu")


def _march(gen):
    """march_ts's arguments for 32 rays through a random 16^3 grid, with
    the proposal (which the check takes out)."""
    gcfg = occ_lib.OccGridConfig(resolution=16, levels=1)
    shape = (1, 16, 16, 16)
    state = occ_lib.OccGridState(occs=torch.rand(shape, generator=gen),
                                 binaries=torch.rand(shape, generator=gen) < 0.3)
    cfg = march.MarchConfig(render_step_size=0.05, max_samples=16, max_candidates=64,
                            proposal_samples=8)
    o = (torch.rand((32, 3), generator=gen) - 0.5) * 0.5
    d = torch.nn.functional.normalize(torch.randn((32, 3), generator=gen), dim=1)
    return o, d, None, None, state, gcfg, cfg


def _composite(gen):
    """composite_fwd's 9 arguments (8 rays x 24 samples, a random
    background) and the 3 cotangents."""
    n, k = 8, 24
    dt = 0.01 + 0.2 * torch.rand((n, k), generator=gen)
    te = torch.cumsum(dt, 1)
    dens = 3.0 * torch.rand((n, k, 1), generator=gen)
    mask = torch.rand((n, k), generator=gen) < 0.8
    rgb = torch.rand((n, k, 3), generator=gen)
    bg = torch.rand((n, 3), generator=gen)
    cot = (torch.randn((n, 3), generator=gen), torch.randn((n, 1), generator=gen),
           torch.randn((n, 1), generator=gen))
    return (dens, rgb, te - dt, te, mask, 0.01, 1e-4, bg, "random") + cot


def _head(gen):
    """The field head's 10 arguments in field_head.run's order: 4 rays x 6
    samples, bf16, a code a ray."""
    n, m = 24, 4
    base = {"w0": torch.randn((32, 64), generator=gen) / 6, "b0": torch.randn(64, generator=gen),
            "w1": torch.randn((64, 16), generator=gen) / 8, "b1": torch.randn(16, generator=gen)}
    color = {"w0": torch.randn((63, 64), generator=gen) / 8, "b0": torch.randn(64, generator=gen),
             "w1": torch.randn((64, 64), generator=gen) / 8, "b1": torch.randn(64, generator=gen),
             "w2": torch.randn((64, 3), generator=gen) / 8, "b2": torch.randn(3, generator=gen)}
    dirs = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=-1)
    return (base, color, torch.randn((n, 32), generator=gen), torch.rand(n, generator=gen) < 0.8,
            dirs, torch.randn((m, 32), generator=gen), 0.5, True,
            torch.randn((n, 1), generator=gen), torch.randn((n, 3), generator=gen))


def _small(entry: str):
    """A small shape of the entry's inputs on the CPU."""
    gen = torch.Generator().manual_seed(0)
    return {"K1": lambda: _encode("blocked", 2, gen), "K1g": lambda: _encode("blocked", 4, gen),
            "K7a": lambda: _encode("ngp", 2, gen), "K7ag": lambda: _encode("ngp", 3, gen),
            "K3": lambda: _march(gen), "K5": lambda: _composite(gen),
            "K9": lambda: _head(gen)}[entry]()


def _kernel(entry: str, name: str):
    return next(k for k in kc.TABLE[entry].kernels if k.name == name)


def _off(out):
    """out with its first float tensor moved off by 1e-3 of its scale."""
    out = list(out) if isinstance(out, tuple) else [out]
    t = out[0]
    out[0] = t + 1e-3 * (1.0 + float(t.abs().max()))
    return tuple(out) if len(out) > 1 else out[0]


def test_the_table_covers_every_kernel_the_tools_compared():
    names = [name for _, name in KERNELS]
    assert names == ["K1", "K2", "K1g", "K2g", "K3", "K5a", "K5b", "K7a", "K7b", "K7ag", "K7bg",
                     "K9a", "K9b"]
    assert [e for e, x in kc.TABLE.items() if x.wide] == ["K3"]


@pytest.mark.parametrize("entry", list(kc.TABLE))
def test_each_entry_defines_its_c_entries_in_its_source(entry):
    e = kc.TABLE[entry]
    src = e.module.SOURCE.read_text()
    for name in e.entries:
        assert re.search(rf"\bint {name}\(", src), (entry, name)
    for k in e.kernels:
        assert callable(getattr(e.module, k.wrapper)) and k.way in ("fwd", "bwd")


@pytest.mark.parametrize("entry, name", KERNELS)
def test_check_holds_the_wrapper_on_the_cpu(entry, name):
    k = _kernel(entry, name)
    a = k.args(_small(entry))
    assert a is not None
    fn = getattr(kc.TABLE[entry].module, k.wrapper)
    k.holds({"this": fn, "again": fn}, a, "small")


@pytest.mark.parametrize("entry, name", KERNELS)
def test_check_refuses_a_build_off_the_plain_version(entry, name):
    k = _kernel(entry, name)
    a = k.args(_small(entry))
    fn = getattr(kc.TABLE[entry].module, k.wrapper)
    with pytest.raises(SystemExit, match=f"{name} off at small"):
        k.holds({"this": fn, "off": lambda *x: _off(fn(*x))}, a, "small")


def test_an_encode_backward_runs_only_where_a_shape_has_a_cotangent():
    pos, table, _, lv = _small("K7a")
    for e, fwd, bwd in (("K7a", "K7a", "K7b"), ("K1", "K1", "K2")):
        assert _kernel(e, fwd).args((pos, table, None, lv)) == (pos, table, lv)
        assert _kernel(e, bwd).args((pos, table, None, lv)) is None


def test_rows_repeats_or_cuts_a_shapes_rows():
    a = _small("K5")
    for n in (5, 19):
        got = kc.rows(a, n)
        for t, u in zip(a, got):
            if isinstance(t, torch.Tensor) and t.dim():
                assert u.shape == (n,) + t.shape[1:] and u.is_contiguous()
                assert torch.equal(u, torch.cat([t, t, t])[:n])
            else:
                assert u is t
    pos, table, gfeat, lv = _small("K1g")
    got = kc.rows((pos, table, gfeat, lv), 100)
    assert got[0].shape == (100, 3) and got[1] is table and got[2].shape[0] == 100


def test_the_tool_exits_non_zero_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kc.main(["K3", "march_other.cu"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_wide_is_refused_where_an_entry_has_no_cases_past_its_layout():
    with pytest.raises(SystemExit) as e:
        kc.main(["K5", "composite_other.cu", "--wide"])
    assert e.value.code == 2


@pytest.mark.parametrize("entry", list(kc.TABLE))
def test_a_build_is_a_copy_of_the_wrapper_over_another_source(entry, tmp_path):
    """A build's wrapper is the package's module loaded again over a copy of
    the other file of its own (one library object a path, whose entries
    each module binds to its own argument types), with caches of its own;
    on the CPU it runs the plain version."""
    e = kc.TABLE[entry]
    other = kc.own_copy(e.module.SOURCE, tmp_path, "1")
    assert other != kc.own_copy(e.module.SOURCE, tmp_path, "wrapper")
    assert other.read_bytes() == e.module.SOURCE.read_bytes()
    mod = kc.load_module(e.module.__file__, f"{e.module.__name__}_test_{entry}", other)
    assert mod is not e.module and mod.SOURCE == other
    assert mod._library is not e.module._library
    k = e.kernels[0]
    k.holds({"this": getattr(e.module, k.wrapper), "copy": getattr(mod, k.wrapper)},
            k.args(_small(entry)), "small")
