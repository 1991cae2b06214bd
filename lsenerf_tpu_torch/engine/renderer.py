"""Full-image rendering for the eval, in chunks of eval_num_rays_per_chunk
rays. Port of lsenerf_tpu/engine/renderer.py: the JAX package renders 8
chunks in one jitted call to save dispatches; the port renders chunk by
chunk, the last one short, and gives the same images."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lsenerf_tpu_torch.cameras import cameras as cam_lib
from lsenerf_tpu_torch.models import lsenerf as model_lib


def render_chunk(model_params: dict, cams: cam_lib.Cameras, occ_state, coords: torch.Tensor,
                 idx: torch.Tensor, app_id: torch.Tensor, c2w: Optional[torch.Tensor],
                 config: model_lib.ModelConfig, generator: Optional[torch.Generator] = None) -> dict:
    """One chunk of rays at pixel coords (n, 2) [y, x] of camera idx,
    rendered in eval mode. Without mapping, the configured background is
    blended in by the accumulation (white, or random colours drawn from
    `generator`) and rgb clipped to [0, 1]; with mapping the raw sum stays."""
    bundle = cam_lib.generate_rays(cams, idx, coords, c2w=c2w)
    bundle = bundle.replace(metadata={"appearance_id": app_id})
    out = model_lib.model_forward(model_params, bundle, occ_state, config, train=False)
    if config.background_color != "linear" and not config.use_mapping:
        acc = out["accumulation"]
        if config.background_color == "white":
            out["rgb"] = out["rgb"] + (1.0 - acc)
        elif config.background_color == "random":
            bg = torch.rand(out["rgb"].shape, generator=generator, device=acc.device)
            out["rgb"] = out["rgb"] + bg * (1.0 - acc)
        out["rgb"] = torch.clamp(out["rgb"], 0.0, 1.0)
    return out


@torch.no_grad()
def render_image(model_params: dict, cams: cam_lib.Cameras, cam_idx: int, occ_state,
                 config: model_lib.ModelConfig, appearance_id: int = 0, chunk: int = 4096,
                 c2w_override=None, generator: Optional[torch.Generator] = None) -> dict:
    """One full view -> {name: (h, w, c) numpy array}. `cams` and the
    params live on the device the render runs on; `c2w_override` (3, 4)
    replaces the view's pose; `generator` draws the random background
    (a fresh one seeded 0 by default, on the render's device)."""
    dev = cams.camera_to_worlds.device
    h, w = cams.height, cams.width
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    coords = torch.stack([ys.reshape(-1), xs.reshape(-1)], 1).float()
    n = coords.shape[0]
    if generator is None and config.background_color == "random":
        generator = torch.Generator(device=dev).manual_seed(0)
    c2w_full = None
    if c2w_override is not None:
        c2w_full = torch.as_tensor(c2w_override, device=dev).float().reshape(1, 3, 4)
    outs = []
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        c2w = None if c2w_full is None else c2w_full.expand(m, 3, 4)
        outs.append(render_chunk(
            model_params, cams, occ_state, coords[i : i + m],
            torch.full((m,), int(cam_idx), dtype=torch.long, device=dev),
            torch.full((m,), int(appearance_id), dtype=torch.long, device=dev),
            c2w, config, generator))
    merged = {}
    for name in outs[0]:
        vals = torch.cat([o[name] for o in outs]).float().cpu().numpy()
        if vals.ndim == 1:
            vals = vals[:, None]
        merged[name] = vals.reshape(h, w, -1)
    return merged
