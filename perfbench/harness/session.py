"""The program's side of a train cell's set-up with the check's readings
taken on the way, spans around the program's occupancy updates, the
reference pass's encode work counted, and the model FLOPs of a cell's
shapes."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.frozen import bounds
from perfbench.frozen.ref.ops import combine as ref_combine
from perfbench.frozen.ref.ops import ngp as ref_ngp
from perfbench.frozen.ref.trainer import tree_leaves
from perfbench.harness import checks, program


FIRST_STEPS = 3  # the eager chunk's steps the check follows


def drive(t, k: int, params0: dict, warm_chunks: int, mark=None) -> dict:
    """A train cell's set-up through the CLI's loop, and what the check
    reads of it (nothing it runs is changed): the first chunk, which runs
    eagerly on the card, read at its calls of Adam (the first gradient as
    Adam holds it after one step, the parameters' change after
    FIRST_STEPS); the captured chunks; then the Trainer back at its start
    (program.restart) and one chunk from there, which on the card is a
    replay of the captured graph, the window's own call, read whole: its
    batches, its k losses and the parameters' change after its k steps.
    `mark(name)` is called at the end of each part. Returns
    {"first_batches", "first_steps", "grad_norms", "first_change_norms",
    "stacked", "losses", "change_norms"}."""
    mark = mark or (lambda name: None)
    start = program.start_of(t)
    eager = _chunk_read(t, k, params0, first_steps=min(FIRST_STEPS, k))
    mark("eager chunk")
    program.train_chunks(t, k * (warm_chunks - 1), k)
    mark("captured chunks")
    program.restart(t, params0, start)
    checked = _chunk_read(t, k, params0)
    mark("checked chunk")
    return {"first_batches": eager["stacked"], "first_steps": min(FIRST_STEPS, k),
            "grad_norms": eager["grad_norms"], "first_change_norms": eager["first_change_norms"],
            "stacked": checked["stacked"], "losses": checked["losses"],
            "change_norms": checked["change_norms"]}


def _chunk_read(t, k: int, params0: dict, first_steps: int = 0) -> dict:
    """One chunk of k steps through the loop (k single steps where k is
    1), read on the way: the batches the loop drew, stacked; with
    `first_steps` the norms of the first gradient as Adam holds it after
    the chunk's first step and of the parameters' change after
    `first_steps` steps (read at its calls of Adam, which a replay never
    makes); after the chunk its k losses (the chunk's own, or else each
    step's as the loss was taken) and the norms of the parameters' change
    from `params0`."""
    seen, batches, losses, calls = {}, [], [], [0]
    draw, draw_one, loss_fn = t.dm.next_train_stack, t.dm.next_train, t.loss_fn
    paths = [(v, p) for p, v in tree_leaves(t.params)]
    flat0 = dict(tree_leaves(params0))
    opt = t.optimizer
    real_step = opt.step

    def tap(step, kk):
        out = draw(step, kk)
        seen.setdefault("stacked", {key: np.array(v, copy=True) for key, v in out.items()})
        return out

    def tap_one(step):
        out = draw_one(step)
        batches.append({key: np.array(v, copy=True) for key, v in out.items()})
        return out

    def loss_taken(*a, **kw):
        loss, metrics = loss_fn(*a, **kw)
        losses.append(loss.detach())
        return loss, metrics

    def step_taken(*a, **kw):
        out = real_step(*a, **kw)
        calls[0] += 1
        if calls[0] == 1:
            seen["grad_norms"] = checks.norms(checks.adam_first_grads(opt, paths))
        if calls[0] == first_steps:
            seen["first_change_norms"] = checks.norms(
                {p: v.detach() - flat0[p] for v, p in paths})
        return out

    t.dm.next_train_stack, t.dm.next_train, t.loss_fn = tap, tap_one, loss_taken
    if first_steps:
        opt.step = step_taken
    t.chunk_losses = None
    try:
        program.train_chunks(t, k, k)
    finally:
        del t.dm.next_train_stack, t.dm.next_train, t.loss_fn
        if first_steps:
            del opt.step
    if "stacked" not in seen:
        seen["stacked"] = {key: np.stack([b[key] for b in batches]) for key in batches[0]}
    seen["losses"] = [float(x) for x in (losses if t.chunk_losses is None else t.chunk_losses)]
    seen["change_norms"] = checks.norms({p: v.detach() - flat0[p] for v, p in paths})
    return seen


class OccSpans:
    """Spans around each occupancy update the loop runs on `t`: CUDA
    events on the card; elsewhere only the calls are counted."""

    def __init__(self, t):
        self.t, self.real, self.events = t, t.occ_update, []
        on_card = t.device.type == "cuda"

        def timed(*a, **kw):
            if not on_card:
                self.events.append(None)
                return self.real(*a, **kw)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.real(*a, **kw)
            e.record()
            self.events.append((s, e))
            return out

        t.occ_update = timed

    def close(self) -> list:
        """Each span's ms (None off the card), the wrapper removed."""
        del self.t.occ_update
        if self.events and self.events[0] is not None:
            torch.cuda.synchronize()
        return [None if ev is None else ev[0].elapsed_time(ev[1]) for ev in self.events]


class EncodeWatch:
    """The positions each of the reference's encodes sees, tagged by the
    phase the caller sets, with the bound of each call."""

    def __init__(self):
        self.phase, self.calls = "", []
        self.saved = {}

    def __enter__(self):
        for mod, layout in ((ref_combine, "blocked"), (ref_ngp, "ngp")):
            for kind in ("fwd", "bwd"):
                name = f"encode_{kind}"
                real = getattr(mod, name)
                self.saved[(mod, name)] = real
                setattr(mod, name, self._wrap(real, kind, layout))
        return self

    def __exit__(self, *exc):
        for (mod, name), real in self.saved.items():
            setattr(mod, name, real)

    def _wrap(self, real, kind, layout):
        def watched(positions, table, *rest):
            lv = rest[-1]
            if layout == "blocked":
                fwd_s, bwd_s = bounds.blocked_encode(positions, lv, table.element_size())
                F = lv.F
            else:
                F = table.shape[1]
                fwd_s, bwd_s = bounds.ngp_encode(positions, lv, F, table.element_size())
            self.calls.append({"phase": self.phase, "kind": kind, "layout": layout, "F": F,
                               "bound_s": fwd_s if kind == "fwd" else bwd_s})
            return real(positions, table, *rest)
        return watched


def encode_work(watch: EncodeWatch, phase: str, units_seen: int, units_window: int) -> list:
    """Work records for the window: each call the reference made in
    `phase` over `units_seen` units (steps, updates, frames), counted
    units_window / units_seen times."""
    scale = units_window / units_seen
    return [dict(c, count=scale) for c in watch.calls if c["phase"] == phase]


def mlp_flops(field_params: dict, density_only: bool = False) -> int:
    """The field MLPs' multiply-adds for one sample, as flops."""
    total = 0
    for name in ("base_mlp",) if density_only else ("base_mlp", "color_mlp"):
        p = field_params[name]
        total += sum(2 * p[k].shape[0] * p[k].shape[1] for k in p if k.startswith("w"))
    return total


def encode_flops(hash_cfg) -> int:
    """The encode's trilinear interpolation for one sample: 8 corners x F
    multiply-adds a level."""
    return hash_cfg.num_levels * hash_cfg.features_per_level * 8 * 2

