"""The flagship training configurations, the port's counterparts of
`__graft_entry__._flagship(tiny=False, production=False)` and of its
production protocol (`production=True`), and the paper's four model
presets on the same scene and widths.

The flagship: a 16-level blocked bf16 hash grid (2^14 rows per hashed
level), bf16-rounded MLP inputs, a 128^3 x 4 occupancy grid, the
hierarchical march with the packed phase-2 rule, proposal resampling to 16
samples per ray, co_map with an identity RGB mapper and a powpow event
mapper, SO3xR3 `ns` camera deltas for both cameras, and 3512-ray batches
(2318 RGB + 2 x 597 event) on the 12-camera 64x64 synthetic scene.

The production protocol keeps that model and scene and changes the RGB
camera: its poses come from the continuous-time spline (12 knots), and
each RGB pixel is the mean of 4 rays across its exposure (deblur x4). The
3512-ray budget then gives 579 RGB pixels x 4 + 2 x 597 event rays =
3510 rays, 56,160 field samples a step.

The presets (`preset_trainer`) are `configs/{lsenerf,lsenerf_emb,badnerf,
badnerf_emb}.sh` under `scripts/train_lse_data.sh`'s protocol (deblur x4,
the RGB spline with exposure 30,000, event `ns` SO3xR3 deltas,
ev_one_dim gt, event weight 1, lr 1e-2), with the CLI's other defaults
(random background, proposal F=16 except F=0 under evs_emb,
engine/config.py:444-455) at the flagship's widths and scene:
  lsenerf      the production trainer above;
  lsenerf_emb  one appearance row per image (12) and F=0: 3510 rays x 48
               samples = 168,480 field samples a step;
  badnerf      RGB only (rgb_frac 1.0, no event dataset), no mapping:
               878 pixels x 4 = 3512 rays, 56,192 samples;
  badnerf_emb  badnerf with one appearance row per image and F=0.
All keep the trainer's seed 42 (the script passes 96), so `lsenerf` is
the production trainer exactly. `hash_layout`, `compute_dtype` and
`coarse_stride` change a preset's field as the CLI's flags of those names
do: `preset_trainer("badnerf", hash_layout="ngp", compute_dtype="float32")`
is the real_scale_badnerf_ngpf32 golden's model (16 ngp levels of 2^19
entries, f32 gather and MLP inputs) at these widths."""

from __future__ import annotations

import dataclasses

import torch

from lsenerf_tpu_torch.data.datamanager import DataManagerConfig, MultiCamDataManager
from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene
from lsenerf_tpu_torch.engine import renderer
from lsenerf_tpu_torch.engine.trainer import CameraOptConfig, Trainer, TrainerConfig
from lsenerf_tpu_torch.models import embeddings as emb_lib
from lsenerf_tpu_torch.models import field as field_lib
from lsenerf_tpu_torch.models import lsenerf as model_lib
from lsenerf_tpu_torch.models import mlp
from lsenerf_tpu_torch.ops import combine, ngp, sh
from lsenerf_tpu_torch.ops import hash_encoding as he

# configs/*.sh: rgb_frac, use_map, mapping_method, map_mode,
# evs_mapping_method, emb_type (each runs evs_loss_fn=log_loss)
PRESETS = {
    "lsenerf": (0.66, True, "identity", "co_map", "powpow", "global_emb"),
    "lsenerf_emb": (0.66, True, "identity", "co_map", "powpow", "evs_emb"),
    "badnerf": (1.0, False, "identity", "None", "None", "global_emb"),
    "badnerf_emb": (1.0, False, "identity", "None", "None", "evs_emb"),
}


# the flagship's encode width (out_dim 32 = 16 levels x 2 features) as 8
# levels of 4 features: a hash_fields of preset_model_config
FEATURES_4 = dict(num_levels=8, features_per_level=4)


def flagship_model_config() -> model_lib.ModelConfig:
    return model_lib.ModelConfig(
        field=field_lib.FieldConfig(
            compute_dtype="bfloat16",
            hash=he.HashEncodingConfig(gather_dtype="bfloat16", layout="blocked"),
        ),
        proposal_samples=16,
        use_mapping=True,
        mapping_method="identity",
        evs_mapping_method="powpow",
        map_mode="co_map",
        ev_one_dim="gt",
    )


def preset_model_config(preset: str, production: bool = True, hash_layout: str = "blocked",
                        compute_dtype: str = "bfloat16", coarse_stride: int = 1,
                        hash_fields: dict | None = None) -> model_lib.ModelConfig:
    """The preset's model at the flagship's widths; with `production`,
    deblur x4 RGB rays; the field's hash layout, compute (and gather) dtype
    and coarse stride as the CLI lowers those flags; `hash_fields` sets
    other HashEncodingConfig fields, which the CLI does not take (e.g.
    FEATURES_4)."""
    _, use_map, mapping, map_mode, evs_mapping, emb_type = PRESETS[preset]
    base = flagship_model_config()
    hash_cfg = dataclasses.replace(base.field.hash, layout=hash_layout, gather_dtype=compute_dtype,
                                   **(hash_fields or {}))
    return dataclasses.replace(
        base,
        field=dataclasses.replace(base.field, embedding=emb_lib.EmbeddingConfig(emb_type),
                                  hash=hash_cfg, compute_dtype=compute_dtype,
                                  coarse_stride=coarse_stride),
        proposal_samples=0 if emb_type == "evs_emb" else 16,
        use_mapping=use_map, mapping_method=mapping, map_mode=map_mode,
        evs_mapping_method=evs_mapping,
        rgb_loss_type="deblur" if production else "linspace",
    ).normalized()


def preset_configs(preset: str, production: bool = True, **field):
    """(TrainerConfig, ModelConfig, DataManagerConfig) of a preset: with
    `production` under train_lse_data.sh's protocol (RGB spline + deblur
    x4, event `ns` deltas), else with `ns` deltas for both cameras and one
    ray an RGB pixel, as the flagship; `field` as preset_model_config
    takes it (hash_layout, compute_dtype, coarse_stride, hash_fields)."""
    cfg = TrainerConfig(
        col_cam_opt=CameraOptConfig(mode="SO3xR3", optim_type="spline" if production else "ns"),
        evs_cam_opt=CameraOptConfig(mode="SO3xR3", optim_type="ns"),
    )
    dmc = DataManagerConfig(train_num_rays_per_batch=3512, rgb_frac=PRESETS[preset][0],
                            rgb_loss_mode="deblur" if production else "mse")
    return cfg, preset_model_config(preset, production, **field), dmc


def preset_trainer(preset: str, production: bool = True, device=None, dm_seed: int = 0,
                   dp=None, **field) -> Trainer:
    """A preset's trainer (preset_configs) on the flagship's scene, set up
    with fresh parameters from its seed; `dp` makes it a rank of a
    data-parallel group (parallel/ddp.py)."""
    cfg, mcfg, dmc = preset_configs(preset, production, **field)
    col, evs = make_synthetic_scene(n_cams=12, h=64, w=64, focal=60.0)
    if dmc.rgb_frac >= 1.0:
        evs = None  # train.py parses no event data for an RGB-only run
    trainer = Trainer(cfg, mcfg, MultiCamDataManager(dmc, col, evs, seed=dm_seed), device=device,
                      dp=dp)
    trainer.setup()
    return trainer


def flagship_trainer(device=None, dm_seed: int = 0, production: bool = False) -> Trainer:
    """The flagship trainer, or with `production` the production protocol's
    (the `lsenerf` preset: RGB spline + deblur x4, event `ns` deltas, 579
    RGB pixels x 4 + 2 x 597 event rays)."""
    return preset_trainer("lsenerf", production, device, dm_seed)


def step_encode_inputs(device=None, preset: str | None = None, trainer: Trainer | None = None):
    """The arguments the blocked encode's backward kernel (K2,
    combine.encode_bwd) is given in one real train step: a fresh flagship
    trainer (or the preset's production trainer, or `trainer`) takes its
    step 0 (the occupancy update, the march, the field and the backward)
    with the wrapper watched. Returns (positions, table, cotangent, levels); the
    positions come ray-major, as many samples a ray as the march gives (16
    for the flagship, 48 under F=0). The ngp layout's are ngp_encode_calls'."""
    seen, real = [], combine.encode_bwd

    def watch(positions, table, gfeat, levels):
        seen.append((positions.clone(), table.clone(), gfeat.clone(), levels))
        return real(positions, table, gfeat, levels)

    if trainer is None:
        trainer = (flagship_trainer(device=device) if preset is None
                   else preset_trainer(preset, True, device))
    combine.encode_bwd = watch
    try:
        trainer.step(trainer.dm.next_train(0))
    finally:
        combine.encode_bwd = real
    if len(seen) != 1:
        raise RuntimeError(f"one train step called the encode's backward {len(seen)} times, not once")
    return seen[0]


def ngp_encode_calls(device=None, trainer: Trainer | None = None, chunk: int = 4096) -> dict:
    """K7a's and K7b's arguments where the ngp main path calls them, in the
    real_scale_badnerf_ngpf32 golden's model at these widths (a fresh
    `preset_trainer("badnerf", hash_layout="ngp", compute_dtype="float32")`,
    or `trainer`): its step 0 (the occupancy update's density chunks, then
    the step's field and its backward) and one eval render chunk of `chunk`
    rays of view 0 (the eval's 48 samples a ray, ray-major), with both
    wrappers watched. Returns {"occupancy": [(positions, table, levels) a
    density chunk], "step": (positions, table, cotangent, levels) of the
    backward, "eval_chunk": (positions, table, levels)}."""
    if trainer is None:
        trainer = preset_trainer("badnerf", device=device, hash_layout="ngp",
                                 compute_dtype="float32")
    fwd_seen, bwd_seen = [], []
    real_fwd, real_bwd = ngp.encode_fwd, ngp.encode_bwd

    def watch_fwd(positions, table, levels):
        fwd_seen.append((positions.clone(), table.clone(), levels))
        return real_fwd(positions, table, levels)

    def watch_bwd(positions, table, gfeat, levels):
        bwd_seen.append((positions.clone(), table.clone(), gfeat.clone(), levels))
        return real_bwd(positions, table, gfeat, levels)

    dev = trainer.device
    cams = trainer.dm.col.cameras.to(dev)
    h, w = cams.height, cams.width
    m = min(chunk, h * w)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    coords = torch.stack([ys.reshape(-1), xs.reshape(-1)], 1).float()[:m]
    zeros = torch.zeros((m,), dtype=torch.long, device=dev)
    occ_calls = []

    def occ_update(*args, **kw):
        real_occ(*args, **kw)
        occ_calls.append(len(fwd_seen))

    real_occ = trainer.occ_update
    trainer.occ_update = occ_update
    ngp.encode_fwd, ngp.encode_bwd = watch_fwd, watch_bwd
    try:
        trainer.step(trainer.dm.next_train(0))
        n_step = len(fwd_seen)
        with torch.no_grad():
            renderer.render_chunk(trainer.params["model"], cams, trainer.occ, coords, zeros, zeros,
                                  None, trainer.model_config)
    finally:
        ngp.encode_fwd, ngp.encode_bwd = real_fwd, real_bwd
        del trainer.occ_update
    n_occ = occ_calls[0] if occ_calls else 0
    if n_occ < 1 or n_step != n_occ + 1 or len(fwd_seen) != n_step + 1 or len(bwd_seen) != 1:
        raise RuntimeError(f"step 0 and an eval chunk called K7a {len(fwd_seen)} times "
                           f"({n_occ} in the occupancy update) and K7b {len(bwd_seen)} times, not "
                           f"once a density chunk, once in the step, once in the chunk and once")
    return {"occupancy": fwd_seen[:n_occ], "step": bwd_seen[0], "eval_chunk": fwd_seen[n_step]}


# the badnerf preset's field samples a step: 878 pixels x 4 rays x 16 samples
NGP_SAMPLES = 878 * 4 * 16


def ngp_encode_shapes(device=None) -> dict:
    """K7a's and K7b's inputs at the ngp layout's shapes, {name:
    (positions, table, cotangent or None, levels)}: NGP_SAMPLES uniform
    positions with JAX's default grid (16 ngp levels of 2^19 entries) and a
    U(-1, 1) f32 table ("uniform"), its bf16 copy ("bf16") and the level
    window [4, 16) ("window_4_16"), all drawn from seed 0 on `device`; then
    from ngp_encode_calls one step's ("step"), one eval render chunk's
    ("eval_chunk") and the step-0 occupancy update's first density chunk
    ("occupancy"), the last two with no cotangent (no backward runs)."""
    hcfg = he.HashEncodingConfig()
    gen = torch.Generator(device=device).manual_seed(0)
    pos = torch.rand((NGP_SAMPLES, 3), generator=gen, device=device)
    table = torch.rand(hcfg.table_shape, generator=gen, device=device) * 2 - 1
    gfeat = torch.randn((NGP_SAMPLES, hcfg.out_dim), generator=gen, device=device)
    lv = he.levels_for(hcfg, device)
    wcfg = dataclasses.replace(hcfg, level_lo=4)
    calls = ngp_encode_calls(device)
    return {
        "uniform": (pos, table, gfeat, lv),
        "bf16": (pos, table.to(torch.bfloat16), gfeat, lv),
        "window_4_16": (pos, table, gfeat[:, : wcfg.out_dim].contiguous(),
                        he.levels_for(wcfg, device)),
        "step": calls["step"],
        "eval_chunk": (*calls["eval_chunk"][:2], None, calls["eval_chunk"][2]),
        "occupancy": (*calls["occupancy"][0][:2], None, calls["occupancy"][0][2]),
    }


def march_composite_calls(device=None, chunk: int = 4096, step: int = 16) -> dict:
    """K3's and K5a/K5b's arguments where the flagship's main path calls
    them: a fresh flagship trainer takes steps 0..`step` (its occupancy
    updates at steps 0 and 16), with the wrappers watched in the last one,
    then renders one eval chunk of `chunk` rays of view 0 (48 samples a
    ray: an eval render runs no proposal). Returns {"march": march_ts's
    arguments (o, d, nears, fars, occ_state, occ_config, march config) in
    that step, "composite": composite_bwd's (density, rgb, t_starts,
    t_ends, mask, alpha_thre, early_stop_eps, bg_color, background, g_rgb,
    g_depth, g_acc) in it, "eval_march" and "eval_composite" (the
    forward's, no cotangents) of the chunk}."""
    from lsenerf_tpu_torch.ops import composite, march

    trainer = flagship_trainer(device=device)
    for i in range(step):
        trainer.step(trainer.dm.next_train(i))
    seen = {}
    real = {"march_ts": march.march_ts, "composite_fwd": composite.composite_fwd,
            "composite_bwd": composite.composite_bwd}

    def watch(name, key):
        def fn(*args):
            seen.setdefault(key, []).append(tuple(
                a.clone() if isinstance(a, torch.Tensor) else a for a in args))
            return real[name](*args)
        return fn

    dev = trainer.device
    cams = trainer.dm.col.cameras.to(dev)
    h, w = cams.height, cams.width
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    coords = torch.stack([ys.reshape(-1), xs.reshape(-1)], 1).float()
    coords = coords.repeat(-(-chunk // coords.shape[0]), 1)[:chunk]
    zeros = torch.zeros((chunk,), dtype=torch.long, device=dev)
    try:
        march.march_ts = watch("march_ts", "march")
        composite.composite_bwd = watch("composite_bwd", "composite")
        trainer.step(trainer.dm.next_train(step))
        march.march_ts = watch("march_ts", "eval_march")
        composite.composite_fwd = watch("composite_fwd", "eval_composite")
        with torch.no_grad():
            renderer.render_chunk(trainer.params["model"], cams, trainer.occ, coords, zeros, zeros,
                                  None, trainer.model_config)
    finally:
        for name, fn in real.items():
            setattr(march if name == "march_ts" else composite, name, fn)
    if any(len(seen.get(k, ())) != 1 for k in ("march", "composite", "eval_march",
                                                "eval_composite")):
        raise RuntimeError(f"step {step} and an eval chunk called K3/K5 "
                           f"{ {k: len(v) for k, v in seen.items()} } times, not once each")
    return {k: v[0] for k, v in seen.items()}


def march_cases(calls: dict) -> list:
    """K3's check cases at march_composite_calls' step-16 rays: [(label, o,
    d, nears, fars, occ_state, march config)]: that step's grid; the fresh
    all-ones grid, where every ray strides; a 20%-occupied random grid;
    half the rays turned to miss the aabb; with nears/fars; the flat march,
    the unpacked phase 2 and cone_angle 0; and nears past t_crit, where
    n_lin is 0 and the candidates read the whole growth table."""
    from lsenerf_tpu_torch.ops import occupancy as occ_lib

    o, d, nears, fars, state, gcfg, cfg = calls["march"]
    dev = o.device
    gen = torch.Generator(device=dev).manual_seed(3)
    n = o.shape[0]
    shape = (gcfg.levels,) + (gcfg.resolution,) * 3
    rand = occ_lib.OccGridState(occs=torch.rand(shape, generator=gen, device=dev),
                                binaries=torch.rand(shape, generator=gen, device=dev) < 0.2)
    half = gcfg.aabb_scale * 2.0 ** (gcfg.levels - 1)
    miss_o, miss_d = o.clone(), d.clone()
    out = torch.nn.functional.normalize(torch.randn((n // 2, 3), generator=gen, device=dev), dim=1)
    miss_o[: n // 2] = out * (3.0 * half)
    miss_d[: n // 2] = out
    near = torch.rand((n,), generator=gen, device=dev)
    far = near + 0.5 + 3.0 * torch.rand((n,), generator=gen, device=dev)
    t_crit = cfg.render_step_size / cfg.cone_angle
    deep = t_crit * 1.01 + torch.rand((n,), generator=gen, device=dev)
    return [
        ("step 16, after its occupancy update", o, d, nears, fars, state, cfg),
        ("the fresh all-ones grid", o, d, nears, fars, occ_lib.init_occ_grid(gcfg, dev), cfg),
        ("a 20%-occupied random grid", o, d, nears, fars, rand, cfg),
        ("half the rays missing the aabb", miss_o, miss_d, nears, fars, state, cfg),
        ("nears/fars", o, d, near, far, state, cfg),
        ("the flat march", o, d, nears, fars, state, dataclasses.replace(cfg, hierarchical=False)),
        ("the unpacked phase 2", o, d, nears, fars, state,
         dataclasses.replace(cfg, packed_phase2=False)),
        ("cone_angle 0", o, d, nears, fars, state, dataclasses.replace(cfg, cone_angle=0.0)),
        ("nears past t_crit (n_lin 0)", o, d, deep, fars, state, cfg),
    ]


# K3 past its static per-warp layout (64 slots, 64 coarse segments, 64
# rounds of 32 candidates), with segments wider than a warp and with its
# scratch past a block's shared memory, as the JAX package's march takes
# any value; "grid" doubles the step's grid to that resolution (each cell
# 2^3 of its own: the same occupancy)
WIDE_MARCHES = {
    "96 slots (F=16)": dict(max_samples=96),
    "96 coarse segments": dict(max_coarse_segments=96),
    "the flat march over 4096 candidates": dict(hierarchical=False, max_candidates=4096),
    "coarse_factor 64 on the grid at 256^3 (4096 candidates, 24 segments)": dict(
        coarse_factor=64, max_candidates=4096, grid=256),
    "3000 slots over 4096 flat candidates (the global workspace)": dict(
        hierarchical=False, max_candidates=4096, max_samples=3000),
    "96 slots, 96 coarse segments, 4096 candidates, F=80": dict(
        max_samples=96, max_coarse_segments=96, max_candidates=4096, proposal_samples=80),
}


def march_wide_cases(calls: dict) -> list:
    """K3's check cases past its static layout at march_composite_calls'
    step-16 rays and grid: [(label, o, d, nears, fars, occ_state, grid
    config, march config)], one for each of WIDE_MARCHES."""
    from lsenerf_tpu_torch.ops import occupancy as occ_lib

    o, d, nears, fars, state, gcfg, cfg = calls["march"]
    out = []
    for label, kw in WIDE_MARCHES.items():
        kw = dict(kw)
        st, g = state, gcfg
        res = kw.pop("grid", None)
        if res is not None:
            e, b = state.occs, state.binaries
            for dim in (1, 2, 3):
                e = e.repeat_interleave(res // gcfg.resolution, dim)
                b = b.repeat_interleave(res // gcfg.resolution, dim)
            st = occ_lib.OccGridState(occs=e, binaries=b)
            g = dataclasses.replace(gcfg, resolution=res)
        out.append((label, o, d, nears, fars, st, g, dataclasses.replace(cfg, **kw)))
    return out


def composite_shapes(calls: dict, seed: int = 9) -> dict:
    """K5a/K5b's timed shapes from march_composite_calls' calls: {name:
    (composite_fwd's 9 arguments, the 3 cotangents)}: "step" (that step's
    3512 x 16 with its cotangents), "n3510_k48" (the eval chunk's first
    3510 rays) and "eval_chunk" (4096 x 48), the last two with standard
    normal cotangents drawn from `seed` on the chunk's device."""
    comp, ecomp = calls["composite"], calls["eval_composite"]
    dev = ecomp[0].device
    rng = torch.Generator(device=dev).manual_seed(seed)
    shapes = {"step": (comp[:9], comp[9:])}
    for key, m in (("n3510_k48", 3510), ("eval_chunk", ecomp[0].shape[0])):
        a = tuple(x[:m] if isinstance(x, torch.Tensor) and x.dim() else x for x in ecomp)
        cot = (torch.randn((m, 3), generator=rng, device=dev),
               torch.randn((m, 1), generator=rng, device=dev),
               torch.randn((m, 1), generator=rng, device=dev))
        shapes[key] = (a, cot)
    return shapes


# the generic encode kernels' uniform shape: the badnerf and flagship
# presets' 3512 rays x 16 samples, at FEATURES_4's 8 levels
GENERIC_SAMPLES = 3512 * 16


def generic_encode_uniform(features, device=None):
    """K1g/K2g's and K7ag/K7bg's inputs on GENERIC_SAMPLES uniform
    positions at 8 levels of each F in `features`, drawn from seed 0 on
    `device` one (layout, F) at a time: yields (layout, F, positions,
    table, cotangent, levels), the blocked layout's full-width grid with a
    U(-1, 1) bf16 table, then the ngp layout's 8 levels of 2^19 entries
    with an f32 one."""
    gen = torch.Generator(device=device).manual_seed(0)
    pos = torch.rand((GENERIC_SAMPLES, 3), generator=gen, device=device)
    for layout, dtype in (("blocked", torch.bfloat16), ("ngp", torch.float32)):
        for F in features:
            hcfg = he.HashEncodingConfig(layout=layout, num_levels=8, features_per_level=F)
            table = (torch.rand(hcfg.table_shape, generator=gen, device=device) * 2 - 1).to(dtype)
            gfeat = torch.randn((GENERIC_SAMPLES, hcfg.out_dim), generator=gen, device=device)
            yield layout, F, pos, table, gfeat, he.levels_for(hcfg, device)


def generic_encode_steps(device=None) -> dict:
    """The generic encode backwards' arguments in one real step 0 of each
    FEATURES_4 path: {"blocked": the flagship's (K2g), "ngp": badnerf ngp
    f32's (K7bg)}, each (positions, table, cotangent, levels)."""
    flag = preset_trainer("lsenerf", False, device, hash_fields=FEATURES_4)
    blocked = step_encode_inputs(trainer=flag)
    del flag
    bad = preset_trainer("badnerf", device=device, hash_layout="ngp", compute_dtype="float32",
                         hash_fields=FEATURES_4)
    return {"blocked": blocked, "ngp": ngp_encode_calls(trainer=bad)["step"]}


# the field head's shapes (K9a/K9b): (rays, samples a ray, bf16, codes,
# features a sample, code width) of the three train cells' steps, the
# occupancy update's density chunk, and widths that take the kernels
# compiled for no preset (16 levels x F 4, 16-wide codes); then badnerf's
# f32 step with weights and features spread over six decades (SPREAD)
HEAD_SHAPES = {
    "lsenerf step": (3510, 16, True, "one", 32, 32),
    "lsenerf_emb step": (3510, 48, True, "a ray", 32, 32),
    "badnerf_ngp_f32 step": (3512, 16, False, "one", 32, 32),
    "occupancy chunk": (131072, 1, True, None, 32, 0),
    "other widths": (3510, 16, True, "a ray", 64, 16),
    "dynamic range": (3512, 16, False, "one", 32, 32),
}
SPREAD = ("dynamic range",)


def _spread(gen, base: dict, color: dict, feats, dirs, codes) -> tuple:
    """(base, color, feats, codes) with every weight, bias, feature and code
    made positive and times 10^u, u uniform in [-3, 3], then each layer's
    weight and bias divided by the largest of its outputs on these inputs
    (computed in f64): the products' operands span six decades while exp
    and the sigmoid stay near 1, and no sum cancels nor ReLU clips (a
    unit that changes side between two f32 sums would take the gradients
    past the f32 limit whatever the products' precision)."""
    def spread(t):
        return t.abs() * 10 ** (torch.rand(t.shape, generator=gen) * 6 - 3)

    feats, codes = spread(feats), spread(codes)
    base = {k: spread(t) for k, t in base.items()}
    color = {k: spread(t) for k, t in color.items()}

    def layers(params, x, count):
        for i in range(count):
            w, b = params[f"w{i}"], params[f"b{i}"]
            y = x @ w.double() + b.double()
            top = float(y.abs().max())
            params[f"w{i}"], params[f"b{i}"] = w / top, b / top
            x = y / top if i == count - 1 else torch.relu(y / top)
        return x

    h = layers(base, feats.double(), 2)
    one = codes.shape[0] == 1  # one code for every ray
    x = torch.cat([sh.sh_encode(dirs.double(), 4), h[:, 1:],
                   field_lib.expand_codes(codes.double().expand(feats.shape[0], -1) if one
                                          else codes.double(), feats.shape[0])], dim=-1)
    layers(color, x, 3)
    return base, color, feats, codes


def head_shapes(device=None, seed: int = 26, names=None) -> dict:
    """{name: (base MLP, colour MLP, features, selector, directions, codes,
    average_init_density, bf16, density cotangent, rgb cotangent)}, in
    field_head.run's order, at HEAD_SHAPES: the MLPs drawn as init_field
    draws them, N(0, 0.5) features, unit directions, 90% of samples in
    bounds, N(0, 1) codes (one for every ray, as global_emb's, or one a
    ray) and cotangents. The occupancy chunk has no directions, codes or
    cotangents: density alone, forward only. The SPREAD shapes' weights and
    features span six decades (_spread)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, (rays, k, bf16, codes, D, E) in HEAD_SHAPES.items():
        if names is not None and name not in names:
            continue
        n = rays * k
        base = mlp.init_mlp(gen, D, 2, 64, 16)
        color = mlp.init_mlp(gen, 16 + 15 + E, 3, 64, 3)
        feats = torch.randn((n, D), generator=gen) * 0.5
        sel = torch.rand((n,), generator=gen) < 0.9
        dirs = g_d = g_rgb = c = None
        if codes is not None:
            dirs = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=-1)
            c = torch.randn((1 if codes == "one" else rays, E), generator=gen)
            g_d, g_rgb = torch.randn((n, 1), generator=gen), torch.randn((n, 3), generator=gen)
        if name in SPREAD:
            base, color, feats, c = _spread(gen, base, color, feats, dirs, c)
        to = (lambda t: None if t is None else t.to(device))  # noqa: E731
        c = to(c)
        if codes == "one":
            c = c[0].expand(rays, E)
        base = {key: to(t) for key, t in base.items()}
        color = None if codes is None else {key: to(t) for key, t in color.items()}
        out[name] = (base, color, to(feats), to(sel), to(dirs), c, 1.0, bf16, to(g_d), to(g_rgb))
    return out
