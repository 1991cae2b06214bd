"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "lsenerf_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_card.py",
]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lsenerf_tpu")


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_its_kernel_sources():
    assert (ROOT / "lsenerf_tpu_torch" / "csrc" / "blocked_encode.cu").exists()
    assert len(PORT_FILES) > 20


def _tiny_trainer(device):
    from lsenerf_tpu_torch.data.datamanager import DataManagerConfig, MultiCamDataManager
    from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene
    from lsenerf_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from lsenerf_tpu_torch.models.lsenerf import ModelConfig

    col, evs = make_synthetic_scene(n_cams=3, h=8, w=8)
    dm = MultiCamDataManager(DataManagerConfig(train_num_rays_per_batch=16), col, evs)
    return Trainer(TrainerConfig(), ModelConfig(), dm, device=device)


def test_trainer_needs_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _tiny_trainer(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        _tiny_trainer("cuda")
    assert _tiny_trainer("cpu").device == torch.device("cpu")
