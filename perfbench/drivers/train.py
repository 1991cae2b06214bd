"""The `train` traffic: the CLI's training loop in a closed loop.

Set-up builds the port's Trainer with the seed's weights and drives it
through the traffic's warm-up chunks: the first runs eagerly and the
second is captured as one CUDA graph and replayed. The Trainer then goes
back to its start in place and runs one more chunk, a replay of that
graph: the check reads it whole (session.drive). The window is one call
of the loop from there, chunks of `scan_steps` steps with the occupancy
update it runs before each, closed at the first logged step after
`--seconds`; step_ms is the window over every step in it. A traced run
traces `trace_chunks` chunks on the card instead, then one more chunk
with the host's ops (tracing.measured). The check then runs the
reference's steps from the same weights and batches.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from perfbench.frozen.ref.ops import occupancy as occ_lib
from perfbench.harness import checks, env, program, session, tracing


class _WindowClosed(Exception):
    """Raised from the loop's log callback once the window has lasted --seconds."""


def run(ctx) -> dict:
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    k = tr["scan_steps"]
    st = program.Started(ctx)
    sc, ref, params0, t = st.scene, st.ref, st.params0, st.trainer

    def mark(name):
        env.sync(dev)
        st.mark(ctx, name)

    prog = session.drive(t, k, params0, tr["warm_chunks"], mark)
    setup_s = st.setup_s(ctx, "set-up")
    replayed = any(getattr(c, "graph", None) is not None
                   for c in getattr(t, "_chunks", {}).values())
    ctx.note(f"set-up {setup_s:.3f} s (kernel build {st.compile_s:.3f} s, the reference's "
             f"{st.ref_s:.3f} s left out); warm-up {tr['warm_chunks']} chunks of {k} steps, then "
             f"the checked chunk (a replay of a captured graph: {replayed}); s since start at "
             f"the end of each part: {st.parts()}")

    out = {"failed": 0, "work": {}}
    if not ctx.trace:
        # one call of the loop, as the CLI makes it: it syncs the host only
        # where it logs (every 100 steps), and there the window is closed
        # once --seconds have passed
        start, t0, seen = t.step_count, time.perf_counter(), {}

        def logged(step, scalars):
            seen["last"] = step
            out["failed"] += int(not math.isfinite(scalars.get("loss", 0.0)))
            if time.perf_counter() - t0 >= ctx.seconds:
                raise _WindowClosed

        try:
            program.train_chunks(t, 10**9, k, callback=logged)
        except _WindowClosed:
            pass
        env.sync(dev)
        window_s = time.perf_counter() - t0
        steps = seen["last"] + 1 - start
        out["e2e"] = {"step_ms": window_s / steps * 1e3, "setup_s": setup_s}
        ctx.note(f"window {window_s:.6f} s, {steps} steps")
    else:
        n = tr["trace_chunks"]
        spans = session.OccSpans(t)

        def window():
            program.train_chunks(t, n * k, k)
            out["work"]["occ_update_ms"] = spans.close()

        out["trace"], out["breakdown"] = tracing.measured(
            window, lambda: program.train_chunks(t, k, k), dev)
        steps = n * k
        out["work"].update(steps=steps, occ_updates=len(out["work"]["occ_update_ms"]))
    out["attempted"] = steps
    out["device"] = env.device_info(dev)
    ctx.note(f"peak device memory {out['device']['memory_peak_bytes']} B")

    # the check: the program is freed, the reference follows the read steps
    del t, st.trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    watch = session.EncodeWatch() if ctx.trace else None
    if watch is not None:
        with watch:
            ref_got = checks.reference_steps(ref, params0, seed, prog,
                                             phase=lambda name: setattr(watch, "phase", name))
    else:
        ref_got = checks.reference_steps(ref, params0, seed, prog)
    numbers = checks.train_numbers(prog, ref_got)
    numbers["batches"] = checks.check_batches([prog["first_batches"], prog["stacked"]], sc,
                                              program.uses_events(cfg))
    ctx.note(f"checked chunk's losses: program {prog['losses']} reference {ref_got['losses']}; "
             f"worst leaves {numbers.pop('_leaves')}")
    out["numbers"] = numbers

    if watch is not None:
        hcfg = ref.mcfg.field.hash
        fp = ref.params["model"]["field"]
        samples = ref.num_rays() * (ref.mcfg.proposal_samples or ref.mcfg.max_samples)
        per_sample = 3 * (session.mlp_flops(fp) + session.encode_flops(hcfg))
        occ_points = occ_lib.num_update_cells(ref.mcfg.grid) * ref.mcfg.grid.levels
        occ_flops = occ_points * (session.mlp_flops(fp, True) + session.encode_flops(hcfg))
        work = out["work"]
        work["flops"] = steps * samples * per_sample + work["occ_updates"] * occ_flops
        work["encode"] = (session.encode_work(watch, "step", len(prog["losses"]), steps)
                          + session.encode_work(watch, "occ", 1, work["occ_updates"]))
    return out
