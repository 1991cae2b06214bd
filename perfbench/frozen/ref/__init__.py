"""A frozen copy of the port's plain PyTorch path: the reference that the
benchmark holds the port to.

The modules are the port's (`lsenerf_tpu_torch`) cameras, models and ops
as they stood when the benchmark was written, with every hand-written
kernel replaced by its plain PyTorch version on any device and nothing
built or loaded. `trainer.py` is the train step of the port's Trainer and
chunk body (bundles, loss, backward, Adam) written out plainly. Nothing
here imports the port, so a later change to the port cannot move the
reference.
"""

from __future__ import annotations

EPS = 1e-6  # the port's global epsilon
