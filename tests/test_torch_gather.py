"""The port's gathers (lsenerf_tpu_torch/ops/gather.py) against the Pallas
gather probes' own kernels (scripts/pallas_probe*.py), one case per
`pallas_call`.

Each probe script is imported once; on the CPU its module-level checks fail
at once ("Only interpret mode is supported") and are caught by the script.
Its kernel functions then run here through `pl.pallas_call(...,
interpret=True)` with the script's own specs, on the script's inputs (P5
at a cut-down shape), and the port's function gets the same numpy inputs on
the CPU, where it runs its plain version. Every case is held to exact
equality of the bits: a gather is a copy, and H sums in the same order on
both sides. The kernel-against-plain check on the card is
tests/test_torch_kernels_card.py."""

import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lsenerf_tpu_torch import gather_probe
from lsenerf_tpu_torch.ops import gather

ROOT = Path(__file__).resolve().parent.parent
SDS = jax.ShapeDtypeStruct
F32 = jnp.float32


@functools.lru_cache(maxsize=None)
def probe(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(kernel, out_shape, *args, **specs):
    return pl.pallas_call(kernel, out_shape=out_shape, interpret=True, **specs)(*args)


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.int32, 2: np.int16}[a.dtype.itemsize])


def _t(a):
    return torch.from_numpy(np.array(a))


_SMEM_VMEM = dict(
    in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
    out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
)


def _probe1_case(kernel):
    p = probe("pallas_probe")
    if kernel == "kernel_dg":  # E: indices padded to T, result sliced
        ipad = np.zeros(p.T, np.int32)
        ipad[: p.C] = p.idx_np
        want = _interpret(p.kernel_dg, SDS((p.T, p.W), F32), p.table_np, ipad)[: p.C]
        return want, gather.row_gather(_t(p.table_np), _t(ipad))[: p.C]
    want = _interpret(getattr(p, kernel), SDS((p.C, p.W), F32), p.table_np, p.idx_np)
    return want, gather.row_gather(_t(p.table_np), _t(p.idx_np))


def _probe2_case(kernel):
    p = probe("pallas_probe2")
    if kernel == "k_tala":  # E2
        want = _interpret(p.k_tala, SDS((p.T, p.W), F32), p.t_np, p.i2d)
        return want, gather.take_along(_t(p.t_np), _t(p.i2d), 0)
    if kernel == "k_tala3":  # E3
        want = _interpret(p.k_tala3, SDS((p.T3, p.W3), F32), p.t3_np, p.i3_2d)
        return want, gather.take_along(_t(p.t3_np), _t(p.i3_2d), 0)
    if kernel == "k_bc":  # F
        want = _interpret(p.k_bc, SDS((p.T, p.W), F32), p.t_np, p.i_np[:, None])
        return want, gather.row_gather(_t(p.t_np), _t(p.i_np))
    if kernel == "k_bf16":  # G: the same bf16 bits on both sides
        want = _interpret(p.k_bf16, SDS((p.T, p.W), jnp.bfloat16), jnp.asarray(p.tb_np), p.i2d)
        tb = _t(np.asarray(p.tb_np).view(np.int16)).view(torch.bfloat16)
        return want, gather.take_along(tb, _t(p.i2d), 0)
    assert kernel == "k_tput"  # H
    want = _interpret(p.k_tput, SDS((p.TH, p.WH), F32), p.th_np, p.ih_np)
    return want, gather.gather_sum(_t(p.th_np), _t(p.ih_np))


def _probe3_case(kernel):
    p = probe("pallas_probe3")
    if kernel in ("k_m1", "k_m2", "k_m3"):
        t, i, axis = {"k_m1": (p.t8, p.i8, 0), "k_m2": (p.t8, p.i8l, 1),
                      "k_m3": (p.t1k, p.i1k, 1)}[kernel]
        want = _interpret(getattr(p, kernel), SDS(t.shape, F32), t, i)
        return want, gather.take_along(_t(t), _t(i), axis)
    if kernel == "k_s1":
        want = _interpret(p.k_s1, SDS((p.CS, p.WS), F32), p.is_, p.ts_, **_SMEM_VMEM)
        return want, gather.row_gather(_t(p.ts_), _t(p.is_))
    if kernel == "k_s2":
        start = np.asarray([17], np.int32)
        want = _interpret(p.k_s2, SDS((p.CS, p.WS), F32), start, p.ts_, **_SMEM_VMEM)
        return want, gather.row_gather(_t(p.ts_), _t(17 + np.arange(p.CS, dtype=np.int32)))
    assert kernel == "k_r1"
    want = _interpret(p.k_r1, SDS((8, 128), F32), p.t8)
    roll = np.broadcast_to((np.arange(128, dtype=np.int32) - 64) % 128, (8, 128))
    return want, gather.take_along(_t(p.t8), _t(roll), 1)


def _probe4_case(unroll, dtype):
    """pallas_probe4.py's gather_kernel with make_gather's specs, cut to a
    512-row table and 4096 rows in chunks of 256."""
    p = probe("pallas_probe4")
    T, W, m, chunk = 512, 64, 4096, 256
    rng = np.random.default_rng(unroll)
    table = jnp.asarray(rng.standard_normal((T, W)).astype(np.float32), dtype)
    idx = rng.integers(0, T, m).astype(np.int32)
    want = pl.pallas_call(
        functools.partial(p.gather_kernel, chunk=chunk, unroll=unroll),
        grid=(m // chunk,),
        in_specs=[
            pl.BlockSpec((chunk,), lambda g: (g,), memory_space=pltpu.SMEM),
            pl.BlockSpec((T, W), lambda g: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((chunk, W), lambda g: (g, 0), memory_space=pltpu.VMEM),
        out_shape=SDS((m, W), dtype),
        interpret=True,
    )(idx, table)
    tt = _t(_bits(table)).view(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return want, gather.row_gather(tt, _t(idx))


CASES = {
    # P3, scripts/pallas_probe.py
    "A-kernel_take": lambda: _probe1_case("kernel_take"),
    "B-kernel_tala": lambda: _probe1_case("kernel_tala"),
    "C-kernel_loop": lambda: _probe1_case("kernel_loop"),
    "D-kernel_onehot": lambda: _probe1_case("kernel_onehot"),
    "E-kernel_dg": lambda: _probe1_case("kernel_dg"),
    # P4, scripts/pallas_probe2.py
    "E2-k_tala": lambda: _probe2_case("k_tala"),
    "E3-k_tala3": lambda: _probe2_case("k_tala3"),
    "F-k_bc": lambda: _probe2_case("k_bc"),
    "G-k_bf16": lambda: _probe2_case("k_bf16"),
    "H-k_tput": lambda: _probe2_case("k_tput"),
    # P4, scripts/pallas_probe3.py
    "M1-k_m1": lambda: _probe3_case("k_m1"),
    "M2-k_m2": lambda: _probe3_case("k_m2"),
    "M3-k_m3": lambda: _probe3_case("k_m3"),
    "S1-k_s1": lambda: _probe3_case("k_s1"),
    "S2-k_s2": lambda: _probe3_case("k_s2"),
    "R1-k_r1": lambda: _probe3_case("k_r1"),
    # P5, scripts/pallas_probe4.py, at the dtypes and unrolls of A-D
    "P5-A-f32-u1": lambda: _probe4_case(1, jnp.float32),
    "P5-B-f32-u8": lambda: _probe4_case(8, jnp.float32),
    "P5-C-bf16-u1": lambda: _probe4_case(1, jnp.bfloat16),
    "P5-D-bf16-u8": lambda: _probe4_case(8, jnp.bfloat16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_pallas_probe(case):
    want, got = CASES[case]()
    assert got.device.type == "cpu"
    got_bits = gather_probe.bits(got)
    want_bits = _bits(want)
    assert got_bits.shape == want_bits.shape
    np.testing.assert_array_equal(got_bits, want_bits)


def test_out_of_range_indices_give_zeros():
    table = torch.arange(1, 13, dtype=torch.float32).reshape(3, 4)
    idx = torch.tensor([2, -1, 3, 0], dtype=torch.int32)
    want = torch.tensor([[9, 10, 11, 12], [0] * 4, [0] * 4, [1, 2, 3, 4]], dtype=torch.float32)
    assert torch.equal(gather.row_gather(table, idx), want)
    assert torch.equal(gather.gather_sum(table, torch.stack([idx, idx])), 2 * want)
    ti = torch.tensor([[0, 5, 1, -2], [2, 2, 9, 3]], dtype=torch.int32)
    t = table[:2]
    assert torch.equal(gather.take_along(t, ti, 1), torch.tensor([[1, 0, 2, 0], [7, 7, 0, 8.0]]))
    ti0 = torch.tensor([[0, 2, 1, -1], [1, 1, 0, 0]], dtype=torch.int32)
    assert torch.equal(gather.take_along(t, ti0, 0), torch.tensor([[1, 0, 7, 0], [5, 6, 3, 4.0]]))


@pytest.mark.parametrize("fn", ["row_gather", "take_along", "gather_sum"])
def test_cuda_tensor_never_takes_the_plain_path(monkeypatch, fn):
    """A wrapper given a non-CPU tensor launches its kernel or raises; it
    never falls back to the plain version."""
    called = []
    monkeypatch.setattr(gather, f"{fn}_plain", lambda *a: called.append(1))
    t = torch.zeros((8, 64), device="meta")
    i = torch.zeros((8, 64), dtype=torch.int32, device="meta")
    args = {"row_gather": (t, i[:, 0]), "take_along": (t, i, 0), "gather_sum": (t, i)}[fn]
    with pytest.raises((ValueError, RuntimeError)):
        getattr(gather, fn)(*args)
    assert not called


@pytest.mark.parametrize("T, W, R, n", [(6, 4, 1, 3), (50, 12, 13, 37), (300, 128, 64, 5)])
def test_gather_sum_adds_rows_in_index_order(T, W, R, n):
    """G3 adds the gathered rows in order r = 0, 1, ... in f32, an index
    outside the table adding a zero row: the same bits as numpy's f32 sum in
    that order, which the kernel also keeps."""
    rng = np.random.default_rng(T)
    table = rng.standard_normal((T, W)).astype(np.float32) * 10.0 ** rng.integers(-3, 4, (T, 1))
    idx = rng.integers(-2, T + 2, (R, n)).astype(np.int32)
    want = np.zeros((n, W), np.float32)
    for r in range(R):
        ok = (idx[r] >= 0) & (idx[r] < T)
        want = want + np.where(ok[:, None], table[np.clip(idx[r], 0, T - 1)], np.float32(0))
    got = gather.gather_sum(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_gather_probe_runs_every_case_on_cpu(capsys):
    assert gather_probe.main(["--device", "cpu", "--reduced"]) == 0
    lines = capsys.readouterr().out.splitlines()
    ok = [ln for ln in lines if ": OK [" in ln]
    assert len(ok) == 18 and "18/18 cases OK" in lines[-1]
    assert all(ln.endswith("time not measured on the CPU") for ln in ok)


def test_gather_probe_needs_the_card_unless_asked_for_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "lsenerf_tpu_torch.gather_probe"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "OK" not in proc.stdout
