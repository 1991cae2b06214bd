"""The comparisons that decide `correct`, and the numbers they compare.

Training, against the reference's steps from the same weights, batches,
grid draws and backgrounds (session.drive reads the program):
  loss_gap           the chunk replayed from the seed's start: its first
                     three losses, the largest relative gap;
  grad_gap           the first, eager chunk's first gradient as Adam holds
                     it after one step, by the worst leaf;
  change_gap         the eager chunk's parameter change after three steps,
                     by the worst leaf;
  replay_change_gap  the replayed chunk's parameter change after all its
                     steps, by the median leaf (past the third step both
                     sides' run-to-run rounding grows with each step, and
                     the worst leaf reads that growth);
  batches            the batches both chunks drew, exactly.
Each leaf is judged by the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger. A leaf whose first gradient in the reference
is under a thousandth of the median leaf's is left out of both changes
(under Adam with eps 1e-15 it moves by round-off alone).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.frozen.ref.trainer import tree_leaves

NEGLIGIBLE = 1e-3  # a leaf's first gradient under this share of the median leaf's
BETA1 = 0.9


def norms(tree: dict) -> dict:
    return {p: (0.0 if v is None else float(torch.linalg.vector_norm(v.double()))) for p, v in
            tree.items()}


def _median(values) -> float:
    vals = [v for v in values if v > 0]
    return float(np.median(vals)) if vals else 0.0


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """{leaf: gap} of per-leaf norms (module doc)."""
    med = _median(want.values())
    out = {}
    for p, w in want.items():
        if keep is not None and p not in keep:
            continue
        scale = max(w, med)
        gap = abs(got.get(p, 0.0) - w) / scale if scale > 0 else abs(got.get(p, 0.0))
        out[p] = gap if math.isfinite(gap) else math.inf
    return out


def leaf_gap(got: dict, want: dict, keep=None) -> tuple:
    """(largest gap, its leaf) of per-leaf norms."""
    gaps = leaf_gaps(got, want, keep)
    where = max(gaps, key=gaps.get, default="")
    return (gaps[where] if where else 0.0), where


def median_gap(got: dict, want: dict, keep=None) -> float:
    """The median leaf's gap of per-leaf norms (inf where any is not finite)."""
    gaps = list(leaf_gaps(got, want, keep).values())
    if not gaps or not all(math.isfinite(g) for g in gaps):
        return math.inf
    return float(np.median(gaps))


def train_numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers (module doc) from each side's {"losses": [k],
    "grad_norms": {leaf: norm of step 1's gradient}, "first_change_norms":
    {leaf: norm of the change after the first steps}, "change_norms":
    {leaf: norm of the change after step k}}; the reference's side also
    gives "first_steps", the losses compared."""
    gaps = [abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog["losses"], ref["losses"])]
    loss_gap = max(gaps[:ref["first_steps"]])
    if not all(math.isfinite(x) for x in prog["losses"]):
        loss_gap = math.inf
    grad_gap, grad_leaf = leaf_gap(prog["grad_norms"], ref["grad_norms"])
    med = _median(ref["grad_norms"].values())
    keep = {p for p, g in ref["grad_norms"].items() if g >= NEGLIGIBLE * med}
    change_gap, change_leaf = leaf_gap(prog["first_change_norms"], ref["first_change_norms"],
                                       keep)
    whole, whole_leaf = leaf_gap(prog["change_norms"], ref["change_norms"], keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "replay_change_gap": median_gap(prog["change_norms"], ref["change_norms"], keep),
            "_leaves": {"grad_gap": grad_leaf, "change_gap": change_leaf,
                        "replay_change_worst": [whole_leaf, whole],
                        "replay_loss_gap_all_steps": max(gaps),
                        "left_out_of_change": sorted(set(ref["grad_norms"]) - keep)}}


def adam_first_grads(optimizer, paths_of) -> dict:
    """The first gradient as a torch Adam holds it after one step: its
    first moment over (1 - beta1), by leaf path (zeros where Adam holds no
    state for the leaf: it was not in the step's graph)."""
    out = {}
    for t, path in paths_of:
        st = optimizer.state.get(t)
        out[path] = None if not st else st["exp_avg"].detach() / (1 - BETA1)
    return out


def check_batches(chunks: list, sc, uses_events: bool) -> float:
    """0 where every batch of the stacked chunks the program drew holds the
    scene's values at its indices and no two batches are alike, else 1."""
    ok, seen = True, []
    for stacked in chunks:
        col = stacked["col_indices"]
        ok &= bool(np.array_equal(stacked["col_rgb"],
                                  sc.images[col[..., 0], col[..., 1], col[..., 2]]))
        ok &= bool(np.array_equal(stacked["col_app_id"], col[..., 0]))
        if uses_events:
            ev = stacked["evs_indices"]
            want = (sc.eimgs[ev[..., 0], ev[..., 1], ev[..., 2]].astype(np.float32)
                    * np.float32(sc.e_thresh))
            ok &= bool(np.array_equal(stacked["evs_values"], want))
            ok &= bool(np.array_equal(stacked["evs_app_id"], ev[..., 0]))
        seen += [c.tobytes() for c in col]
    ok &= len(set(seen)) == len(seen)
    return 0.0 if ok else 1.0


def batch_tensors(stacked: dict, j: int, device) -> dict:
    """Step j's batch as device tensors, as the port's Trainer.batch_to_device makes them."""
    out = {}
    for k, v in stacked.items():
        v = np.asarray(v[j])
        dt = torch.long if np.issubdtype(v.dtype, np.integer) else torch.float32
        out[k] = torch.as_tensor(v, dtype=dt).to(device)
    return out


def reference_steps(ref, params0: dict, seed: int, prog: dict, phase=None) -> dict:
    """The reference's side of what `prog` (session.drive's readings) holds:
    from `params0` and the seed's start, the occupancy update and a step on
    each of the first chunk's first `first_steps` batches (the first
    gradient, the change after them), then again from the start the update
    and a step on each batch of the checked chunk (their losses, the change
    after the last). `phase(name)` is told "first", "occ" and "step" as the
    pass goes. Returns {"losses", "grad_norms", "first_change_norms",
    "change_norms"}."""
    phase = phase or (lambda name: None)
    flat0 = dict(tree_leaves(params0))

    def change():
        return norms({p: v.detach() - flat0[p].to(v.device) for p, v in tree_leaves(ref.params)})

    phase("first")
    ref.start(params0, seed)
    ref.occ_update()
    first = None
    for j in range(prog["first_steps"]):
        got = ref.step(batch_tensors(prog["first_batches"], j, ref.device))
        first = got["grads"] if first is None else first
    first_change = change()
    ref.start(params0, seed)
    phase("occ")
    ref.occ_update()
    phase("step")
    losses = [ref.step(batch_tensors(prog["stacked"], j, ref.device))["loss"]
              for j in range(len(prog["losses"]))]
    return {"losses": losses, "first_steps": prog["first_steps"], "grad_norms": norms(first),
            "first_change_norms": first_change, "change_norms": change()}
