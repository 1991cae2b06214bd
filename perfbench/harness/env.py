"""The run's environment: caches inside the checkout, the card, the
forbidden modules."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

# the whole top-level names that the process printing a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "lsenerf_tpu")


def set_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout, so that only a checkout's first run builds. The port builds
    its kernels into lsenerf_tpu_torch/_build/ itself."""
    cache = root / ".perfbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (lsenerf_tpu_torch begins with lsenerf_tpu and is allowed)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class NoCard(RuntimeError):
    """The run has fewer CUDA cards than its cell needs."""


def need_cards(n: int) -> None:
    """Raise NoCard unless torch sees at least n CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark runs only on the card")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} cards and torch sees {torch.cuda.device_count()}")


def card_power() -> str:
    """The card's name and power limit as nvidia-smi reads them ("" where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def device_info(device) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
