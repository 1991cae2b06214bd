"""K5a/K5b's Hopper wrapper on the CPU: the launch it finds for a call, the
struct a call writes, and the plain versions at any samples a ray.

- The launch cache (composite._launch_for) never hands a float-threshold
  launch to a tensor-threshold call, one background's launch to another,
  or one k's or early_stop_eps's launch to another; a call with the same
  key finds the same launch, whose scalars are the plain version's.
- A call writes the fifteen pointers and n at once, where
  csrc/composite.cu's CompositeArgs has them.
- On CPU tensors the wrappers are the plain versions at k past 64 (the
  first design's limit), where the wrapper now refuses nothing.

The kernels themselves are held to the plain versions on the card
(tests/test_torch_kernels_card.py, chip_smoke.py phase 3d)."""

import ctypes

import numpy as np
import pytest
import torch

from lsenerf_tpu_torch.ops import composite as tcomp

BACKGROUNDS = ["linear", "black", "white", "last_sample"]
MODES = {"linear": 0, "black": 2, "white": 3, "last_sample": 4}


def test_launch_cache_keeps_threshold_forms_apart():
    tcomp._LAUNCHES.clear()
    thr = torch.tensor(0.01)
    flt = tcomp._launch_for(16, None, "linear", 0.01, 1e-4, 0)
    ten = tcomp._launch_for(16, None, "linear", thr, 1e-4, 0)
    off = tcomp._launch_for(16, None, "linear", 0.0, 1e-4, 0)
    assert len({id(flt), id(ten), id(off)}) == 3
    assert not flt.tensor_thr and flt.args.cull == 1
    assert flt.args.thr == float(np.float32(0.01))
    # a tensor threshold is read through its pointer, never the float field
    assert ten.tensor_thr and ten.args.cull == 1 and ten.args.thr == 0.0
    assert not off.tensor_thr and off.args.cull == 0
    # another tensor and another call find the tensor launch again; a float
    # call finds the float one, and another float value a launch of its own
    assert tcomp._launch_for(16, None, "linear", torch.tensor(0.5), 1e-4, 0) is ten
    assert tcomp._launch_for(16, None, "linear", 0.01, 1e-4, 0) is flt
    other = tcomp._launch_for(16, None, "linear", 0.02, 1e-4, 0)
    assert other is not flt and other.args.thr == float(np.float32(0.02))


def test_launch_cache_keeps_backgrounds_apart():
    tcomp._LAUNCHES.clear()
    bg = torch.zeros(4, 3)
    seen = {}
    for background in BACKGROUNDS:
        ln = tcomp._launch_for(48, None, background, 0.01, 1e-4, 0)
        assert ln.mode == ln.args.bg_mode == MODES[background]
        seen[background] = ln
        # colours given: the random background, whatever the name
        given = tcomp._launch_for(48, bg, background, 0.01, 1e-4, 0)
        assert given.mode == given.args.bg_mode == 1
    assert len({id(ln) for ln in seen.values()}) == len(BACKGROUNDS)
    assert tcomp._launch_for(48, bg, "linear", 0.01, 1e-4, 0) is \
        tcomp._launch_for(48, bg, "random", 0.01, 1e-4, 0)
    with pytest.raises(ValueError, match="random background needs"):
        tcomp._launch_for(48, None, "random", 0.01, 1e-4, 0)
    with pytest.raises(ValueError, match="unknown background"):
        tcomp._launch_for(48, None, "grey", 0.01, 1e-4, 0)


def test_launch_cache_keeps_k_eps_and_device_apart():
    tcomp._LAUNCHES.clear()
    base = tcomp._launch_for(16, None, "white", 0.01, 1e-4, 0)
    for k, eps, dev in ((17, 1e-4, 0), (16, 0.0, 0), (16, 1e-4, 1)):
        ln = tcomp._launch_for(k, None, "white", 0.01, eps, dev)
        assert ln is not base and ln.args.k == k
        assert ln.args.eps == float(np.float32(eps))
    assert base.args.k == 16 and base.args.n == 0


def test_call_struct_holds_the_pointers_and_n():
    fields = [name for name, _ in tcomp._CompositeArgs._fields_]
    assert fields[15] == "n" and all(
        t is ctypes.c_void_p for _, t in tcomp._CompositeArgs._fields_[:15])
    assert tcomp._CALL.size == tcomp._CompositeArgs.n.offset + ctypes.sizeof(ctypes.c_int)
    args = tcomp._CompositeArgs.from_buffer_copy(
        tcomp._Launch(96, None, "last_sample", 0.01, 1e-4).args)
    tcomp._CALL.pack_into(args, 0, *range(1, 16), 4097)
    assert [getattr(args, f) for f in fields[:15]] == list(range(1, 16))
    assert (args.n, args.k, args.bg_mode, args.cull) == (4097, 96, 4, 1)


def _inputs(n, k, seed=0):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.01, 0.2, (n, k)).astype(np.float32)
    te = np.cumsum(dt, 1).astype(np.float32)
    dens = rng.exponential(3.0, (n, k, 1)).astype(np.float32)
    dens[0, k // 2, 0] = np.inf
    mask = rng.random((n, k)) < 0.8
    mask[1] = False  # a ray with no sample
    rgb = rng.random((n, k, 3)).astype(np.float32)
    return [torch.from_numpy(x) for x in (dens, rgb, te - dt, te, mask)]


@pytest.mark.parametrize("k", [96, 200])
def test_wrappers_on_cpu_are_the_plain_versions_past_64(k):
    dens, rgb, ts, te, mask = _inputs(8, k)
    cot = [torch.from_numpy(np.random.default_rng(1).standard_normal(s).astype(np.float32))
           for s in ((8, 3), (8, 1), (8, 1))]
    before = (tcomp.K5A.launches, tcomp.K5B.launches)
    for background in BACKGROUNDS:
        args = (dens, rgb, ts, te, mask, torch.tensor(0.01), 1e-4, None, background)
        for got, want in zip(tcomp.composite_fwd(*args), tcomp.composite_fwd_plain(*args)):
            assert torch.equal(got, want) and torch.isfinite(got).all()
        for got, want in zip(tcomp.composite_bwd(*args, *cot),
                             tcomp.composite_bwd_plain(*args, *cot)):
            assert torch.equal(got, want) and torch.isfinite(got).all()
    assert (tcomp.K5A.launches, tcomp.K5B.launches) == before
    with pytest.raises(ValueError, match="CUDA"):  # no limit on k: only the device
        tcomp._checked(dens, rgb, ts, te, mask, 0.01, 1e-4, None, "linear", *cot)


def test_rays_off_plain_decides_early_stop_ties_by_a_nudge():
    """A ray whose transmittance equals early_stop_eps at a sample is a tie:
    outputs computed with eps a hair lower (the sample kept) are off the
    plain version only there, and match it with eps nudged by TIE; a ray
    off by more than the tolerance is off under every nudge."""
    dens, rgb, ts, te, mask = _inputs(8, 24)
    mask[:] = True
    dens[0, :, 0] = 3.0
    args = [dens, rgb, ts, te, mask, 0.0, 1e-4, None, "white"]
    # ray 0's transmittance at its 6th sample, made the threshold
    s = dens[0, :, 0] * (te[0] - ts[0])
    trans = torch.exp(-torch.cat([torch.zeros(1), torch.cumsum(s, 0)[:-1]]))
    args[6] = float(trans[5])
    kept = dict(enumerate(args))
    kept[6] = args[6] * (1.0 - 10 * tcomp.TIE)
    got = tcomp.composite_fwd_plain(*kept.values())
    want = tcomp.composite_fwd_plain(*args)
    assert not torch.allclose(got[0][0], want[0][0], rtol=1e-5, atol=1e-6)
    off, ties = tcomp.rays_off_plain(got, tcomp.composite_fwd_plain, tuple(args))
    assert not off.any() and ties.tolist() == [True] + [False] * 7
    worse = (got[0] + torch.tensor([1e-3, 0.0, 0.0]), *got[1:])
    off, ties = tcomp.rays_off_plain(worse, tcomp.composite_fwd_plain, tuple(args))
    assert off.all() and not ties.any()
