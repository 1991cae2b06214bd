"""k train steps as one CUDA graph: the card's form of the JAX package's
Trainer.make_train_step_multi (lsenerf_tpu/engine/trainer.py:422-444), a
lax.scan over k stacked batches that is one device dispatch a chunk.

A ChunkGraph holds, for one trainer, one k and one model config:
  - one pinned staging buffer and its device twin, which hold the chunk's
    k stacked batches (int64 and f32, as Trainer.batch_to_device makes
    them), each step's learning rate per Adam group (sched(opt_count + j),
    worked out on the host) and each step's camera gates (the delayed
    scheme's 0/1 for step + j, as a device value, so that a chunk in which
    the gate switches on takes the eager step's value at every step); one
    H2D copy a chunk;
  - a grid state of its own (occs, binaries and the supergrids the march
    reads), into which each new OccGridState of the trainer is copied
    before the chunk; a state's own tensors are never written;
  - the graph: bundles (K8a/K8b), the march (K3), the field (K1/K2 or K7a/K7b), the
    composite (K5a/K5b), the losses, the backward and Adam of k steps, with
    the background generator registered, so that its draws are the eager
    draws and its state after a replay is the eager state.
The first chunk runs the same body eagerly: that warm-up is real training,
and it builds what a capture must find built (K3's growth table and
launches, Adam's moments, the encode levels, the cached supergrid). The
second chunk is captured, then replayed; every later chunk is one replay.
No step runs twice and none is skipped. A capture or replay that fails
raises, naming the op of the port where it failed; nothing falls back to
eager steps.

One step of the graph, its middle one (marked_steps), carries device
marks (engine/spans.py): an event at the step's start, after its
background draw, at the end of each of its layers and before its
backward, and the march's tally of live samples (one reduction), which
every replay records again (each mark costs the card ~3 us). While a
profiler runs, a replay's marks are read after the next chunk is staged
and before it replays (the host waits for them where the card has not yet
run the marked step, while the card still holds the rest of the replay:
the reads never leave it idle), or where the loop's run ends; the tally is
added on the card into the run's total, read where the run ends.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch

from lsenerf_tpu_torch.cameras import pose_opt
from lsenerf_tpu_torch.engine import spans
from lsenerf_tpu_torch.ops import occupancy as occ_lib


def path_kernels():
    """The launch counters of the train step's kernels: K1, K2, K1g, K2g,
    K7a, K7b, K7ag, K7bg, K3, K5a, K5b, K8a, K8b, K9a and K9b."""
    from lsenerf_tpu_torch.ops import bundles, combine, composite, field_head, march, ngp

    return (combine.KERNELS + ngp.KERNELS + march.KERNELS + composite.KERNELS + bundles.KERNELS
            + field_head.KERNELS)


def _where(exc: BaseException) -> str:
    """The innermost frame of the port in the traceback of `exc`, or of the
    exception it was raised while handling: where the failing op was
    called."""
    seen = []
    e = exc
    while e is not None and e not in seen:
        seen.append(e)
        e = e.__context__ or e.__cause__
    for e in reversed(seen):
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if "lsenerf_tpu_torch" in f.filename and not f.filename.endswith("chunk_graph.py")]
        if frames:
            f = frames[-1]
            name = f.filename[f.filename.rindex("lsenerf_tpu_torch"):]
            return f"{name}:{f.lineno} in {f.name}: {f.line} ({type(e).__name__}: {e})"
    return f"{type(exc).__name__}: {exc}"


class ChunkGraph:
    """k steps of one trainer as one replayed CUDA graph (module doc);
    `reason`, why its graph is captured (the first capture, or the cause of
    a recapture), is counted at the capture."""

    def __init__(self, trainer, k: int, stacked: dict, reason: str = "first"):
        self.trainer, self.k, self.reason = trainer, k, reason
        self.model_config = trainer.model_config
        dev = trainer.device
        # every region starts on 8 bytes, so that each is a view of its dtype
        layout, off = {}, 0
        for key, v in stacked.items():
            v = np.asarray(v)
            dt = np.int64 if np.issubdtype(v.dtype, np.integer) else np.float32
            layout[key] = (off, dt, v.shape)
            off += _align8(v.size * np.dtype(dt).itemsize)
        groups = 0 if trainer.optimizer is None else len(trainer.optimizer.param_groups)
        self.lr_off, self.gate_off = off, off + _align8(k * groups * 4)
        nbytes = self.gate_off + k * 2 * 4
        on_card = dev.type == "cuda"
        self.host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=on_card)
        self.host_np = self.host.numpy()
        # on the CPU (the tests run the body there) the staging buffer is the
        # device buffer
        self.dev = torch.empty(nbytes, dtype=torch.uint8, device=dev) if on_card else self.host
        self.layout = layout
        tdt = {np.int64: torch.int64, np.float32: torch.float32}
        self.batch = {key: self.dev[o:o + int(np.prod(s)) * np.dtype(dt).itemsize]
                      .view(tdt[dt]).view(s) for key, (o, dt, s) in layout.items()}
        self.lrs = self.dev[self.lr_off:self.lr_off + k * groups * 4].view(torch.float32).view(k, groups)
        self.gates = self.dev[self.gate_off:nbytes].view(torch.float32).view(k, 2)
        self.copied = None  # the event after the last H2D copy
        self.host_lrs = None  # the lrs as floats, for an optimizer that takes floats
        self.occ = self.occ_src = None
        self.graph = None
        self.warm = False
        self.names = None  # the metrics' names, in the order of `out`
        self.out = None  # the last step's metrics, then the k losses
        self.launches = None  # each kernel's launches captured in the graph
        self.marks = []  # the graph's groups of device marks

    # -- inputs -----------------------------------------------------------------

    def load(self, stacked: dict) -> None:
        """The chunk's batches, learning rates and gates into the staging
        buffer, then one H2D copy. The host waits for the previous copy
        (not for the graph) before it writes the buffer again."""
        t, k = self.trainer, self.k
        if self.copied is not None:
            with spans.span("chunk.stage.wait"):
                self.copied.synchronize()
        h = self.host_np
        for key, (o, dt, shape) in self.layout.items():
            v = np.asarray(stacked[key])
            if v.shape != shape:
                raise ValueError(f"chunk batch {key!r} has shape {v.shape}, the graph's is {shape}")
            n = v.size * np.dtype(dt).itemsize
            h[o:o + n].view(dt).reshape(shape)[...] = v
        if t.optimizer is not None:
            self.host_lrs = [[sched(t.opt_count + j) for sched in t.schedules] for j in range(k)]
            lrs = h[self.lr_off:self.lr_off + self.lrs.numel() * 4].view(np.float32).reshape(k, -1)
            lrs[...] = self.host_lrs
        tc = t.config
        gates = h[self.gate_off:self.gate_off + k * 8].view(np.float32).reshape(k, 2)
        for j in range(k):
            s = t.step_count + j
            gates[j] = (pose_opt.activation_gate(s, tc.col_cam_opt.scheme, tc.col_cam_opt.delay_cnt),
                        pose_opt.activation_gate(s, tc.evs_cam_opt.scheme, tc.evs_cam_opt.delay_cnt))
        if self.dev is not self.host:
            self.dev.copy_(self.host, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record()
        spans.count("staged_bytes", self.host.numel())

    def refresh_occ(self) -> None:
        """The trainer's grid state into the graph's own, where it is a new
        one: occs, binaries and every supergrid the march has read."""
        occ = self.trainer.occ
        if occ is self.occ_src:
            return
        if self.occ is None:
            self.occ = occ_lib.OccGridState(occs=occ.occs.clone(), binaries=occ.binaries.clone())
        else:
            self.occ.occs.copy_(occ.occs)
            self.occ.binaries.copy_(occ.binaries)
            for factor, buf in self.occ.__dict__.get("_super", {}).items():
                buf.copy_(occ.super_binaries(factor))
        self.occ_src = occ

    # -- the k steps --------------------------------------------------------------

    def marked_steps(self) -> tuple:
        """The steps of the chunk that carry device marks: the middle one."""
        return (self.k // 2,)

    def body(self) -> None:
        """k steps on the staged inputs, each Trainer.update on the step's
        batch, gates and lrs and the graph's grid (the step's background
        drawn in it). Writes the last step's metrics and the k losses into
        `out`."""
        t = self.trainer
        # the lrs as floats where the optimizer takes floats (the CPU)
        lrs = self.host_lrs if self.dev is self.host else self.lrs
        losses = []
        marked = self.marked_steps()
        for j in range(self.k):
            marks = spans.open_marks(t.device, 1) if j in marked else None
            batch = {key: v[j] for key, v in self.batch.items()}
            loss, metrics = t.update(batch, gates=(self.gates[j, 0], self.gates[j, 1]),
                                     lrs=None if t.optimizer is None else lrs[j], occ=self.occ)
            losses.append(loss.detach())
            spans.close_marks(marks)
        metrics["loss"] = loss
        self.names = list(metrics)
        self.out = torch.stack([metrics[n].detach().float().reshape(()) for n in self.names]
                               + losses)

    def capture(self) -> None:
        """The body recorded into one CUDA graph (nothing runs until the
        replay), with the kernels' launches and the device marks it holds."""
        t = self.trainer
        graph = torch.cuda.CUDAGraph()
        if t.model_config.background_color == "random":
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    f"torch {torch.__version__} has no CUDAGraph.register_generator_state: the "
                    "random background's draws cannot be replayed; scan_steps needs torch >= 2.5")
            graph.register_generator_state(t._bg_gen)
        before = {kn.name: kn.launches for kn in path_kernels()}
        try:
            with spans.capture() as marks, torch.cuda.graph(graph):
                self.body()
        except Exception as e:
            raise RuntimeError(f"capturing {self.k} train steps as one CUDA graph failed at "
                               f"{_where(e)}") from e
        self.launches = {kn.name: kn.launches - before[kn.name] for kn in path_kernels()}
        self.graph, self.marks = graph, marks
        spans.count("captures", 1, self.reason)

    def run(self, stacked: dict):
        """One chunk: (the last step's metrics, the k losses)."""
        with spans.span("chunk.stage"):
            self.load(stacked)
        with spans.span("chunk.refresh_occ"):
            self.refresh_occ()
        if not self.warm:
            spans.count("eager_steps", self.k, "warm-up")
            self.body()
            self.warm = True
        else:
            if self.graph is None:
                with spans.span("chunk.capture"):
                    self.capture()
            # the previous replay's marks, before this replay records them again
            spans.read_pending()
            try:
                with spans.span("chunk.launch"):
                    self.graph.replay()
            except Exception as e:
                raise RuntimeError(f"replaying the {self.k}-step CUDA graph failed: "
                                   f"{type(e).__name__}: {e}") from e
            spans.replayed(self.marks, self.launches)
        vec = self.out.clone()
        n = len(self.names)
        return {name: vec[i] for i, name in enumerate(self.names)}, vec[n:]


def _align8(n: int) -> int:
    return -(-n // 8) * 8
