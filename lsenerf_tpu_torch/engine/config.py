"""Experiment configuration tree, dotted CLI flags, config.yml and the
eval-mode surgery. Port of lsenerf_tpu/engine/config.py:
  - the typed tree addressable with dotted flags in the reference's
    spellings (--pipeline.model.map-mode, --pipeline.datamanager.rgb_frac,
    --optimizers.fields.optimizer.lr, ...), any dash/underscore mix;
  - `modify_config`, the post-parse surgery for eval and pretrain runs
    (reloading a saved config.yml and keeping some of the CLI's values);
  - `build_runtime_configs`, lowered to the port's own config classes.

config.yml is written and read by this module's own emitter and reader
(no PyYAML on the card's machine), for the subset the tree uses: nested
mappings of str, int, float, bool and None. yaml.safe_load reads the
port's files to the same dict, and the reader reads the JAX CLI's
yaml.safe_dump output.

Options the port does not have yet raise NotImplementedError naming their
ROADMAP.md item (`check_supported`). `machine.scan_steps` and
`pipeline.model.supergrid_matmul` are kept so that JAX config trees load,
and change nothing here: the port runs single steps, and its march has no
one-hot matmul.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import os.path as osp
import re
import typing
from dataclasses import dataclass, field as dc_field

# ---------------------------------------------------------------------------
# the CLI-facing tree (mutable; the reference's flag names)
# ---------------------------------------------------------------------------


@dataclass
class AdamConfig:
    lr: float = 1e-2
    eps: float = 1e-15


@dataclass
class SchedulerConfig:
    lr_final: float = 1e-4
    max_steps: int = 200000
    warmup_steps: int = 0


@dataclass
class OptimizerSpec:
    optimizer: AdamConfig = dc_field(default_factory=AdamConfig)
    scheduler: SchedulerConfig = dc_field(default_factory=SchedulerConfig)


@dataclass
class OptimizersConfig:
    fields: OptimizerSpec = dc_field(default_factory=OptimizerSpec)
    camera_opt: OptimizerSpec = dc_field(
        default_factory=lambda: OptimizerSpec(
            optimizer=AdamConfig(lr=1e-3),
            scheduler=SchedulerConfig(lr_final=1e-4, max_steps=5000),
        )
    )


@dataclass
class CameraOptCLI:
    mode: str = "off"  # off | SO3xR3 | SE3
    optim_type: str = "ns"  # ns | spline | prevnext
    scheme: str = "active"  # active | delayed
    delay_cnt: int = 10000
    exp_t: float = 30000.0
    control_pnt_factor: int = 1

    def __post_init__(self):
        if self.mode == "off":
            self.scheme = "active"


@dataclass
class ColDataparserConfig:
    data: str = ""
    scale_factor: float = 1.0
    scene_scale: float = 1.0
    use_gray: bool = False
    image_type: str = "gamma"
    quality: str = "clear"


@dataclass
class EvsDataparserConfig:
    data: str = ""
    scale_factor: float = 1.0
    scene_scale: float = 1.0
    e_thresh: str = "None"  # a string, as in the reference
    event_type: str = "None"


@dataclass
class EmbedConfig:
    embedding_type: str = "global_emb"
    emb_dim: int = 32
    eval_mode: str = "zero"


@dataclass
class DataManagerCLI:
    data: str = ""
    col_dataparser: ColDataparserConfig = dc_field(default_factory=ColDataparserConfig)
    evs_dataparser: EvsDataparserConfig = dc_field(default_factory=EvsDataparserConfig)
    train_num_rays_per_batch: int = 3512
    eval_num_rays_per_batch: int = 1024
    rgb_frac: float = 0.66
    rgb_loss_mode: str = "mse"
    use_native: bool = False
    col_cam_optimizer: CameraOptCLI = dc_field(default_factory=CameraOptCLI)
    evs_cam_optimizer: CameraOptCLI = dc_field(default_factory=CameraOptCLI)


@dataclass
class ModelCLI:
    evs_loss_weight: float = 1.0
    # accepted for the reference's CLI; no loss reads them there either
    emb_norm_weight: float = 1e-2
    use_mapper_loss: bool = False
    mapper_loss_weight: float = 0.25
    scaler_weight: float = 1.0
    event_loss_type: str = "log_loss"
    rgb_loss_type: str = "linspace"
    use_mapping: bool = False
    mapping_method: str = "mlp"
    evs_mapping_method: str = "None"
    map_mode: str = "evs_rgb"
    ev_one_dim: str = "learned"
    embed_config: EmbedConfig = dc_field(default_factory=EmbedConfig)
    eval_num_rays_per_chunk: int = 3512
    num_levels: int = 16
    log2_hashmap_size: int = 19  # the ngp layout's; the blocked layout has 2^14 rows a level
    base_res: int = 16
    max_res: int = 2048
    grid_resolution: int = 128
    grid_levels: int = 4
    occ_sample_fraction: float = 0.03125
    max_samples: int = 48
    max_candidates: int = 1024
    hierarchical_march: bool = True
    coarse_factor: int = 8
    max_coarse_segments: int = 24
    supergrid_matmul: bool = True
    compact_chunk: int = 0
    # -1: 16, except 0 under evs_emb; eval and pretrain runs always 0
    proposal_samples: int = -1
    proposal_uniform_frac: float = 0.2
    proposal_warmup_steps: int = 0
    disable_scene_contraction: bool = False
    background_color: str = "random"
    compute_dtype: str = "bfloat16"
    hash_layout: str = "blocked"
    packed_phase2: bool = True
    coarse_stride: int = 1
    coarse_levels: int = 4
    grad_overflow_telemetry: bool = False


@dataclass
class PipelineCLI:
    datamanager: DataManagerCLI = dc_field(default_factory=DataManagerCLI)
    model: ModelCLI = dc_field(default_factory=ModelCLI)


@dataclass
class MachineConfig:
    seed: int = 42
    num_devices: int = 1
    scan_steps: int = 16  # the JAX package's steps a dispatch; the port runs single steps


@dataclass
class ExperimentConfig:
    method_name: str = "lsenerf"
    experiment_name: str = "unnamed"
    output_dir: str = "outputs"
    timestamp: str = ""
    data: str = ""
    max_num_iterations: int = 30000
    steps_per_save: int = 2000
    steps_per_eval_batch: int = 500
    steps_per_eval_image: int = 500
    steps_per_eval_all_images: int = 25000
    vis: str = "tensorboard"
    is_eval: bool = False
    emb_eval_mode: str = "zero"
    do_pretrain: bool = False
    is_render: bool = False
    load_dir: str = ""
    load_config: str = ""
    load_checkpoint: str = ""
    load_step: int = -1
    machine: MachineConfig = dc_field(default_factory=MachineConfig)
    pipeline: PipelineCLI = dc_field(default_factory=PipelineCLI)
    optimizers: OptimizersConfig = dc_field(default_factory=OptimizersConfig)

    def base_dir(self) -> str:
        return osp.join(self.output_dir, self.experiment_name, self.method_name, self.timestamp)


# ---------------------------------------------------------------------------
# dotted-flag CLI over the tree
# ---------------------------------------------------------------------------


def _walk_fields(cls, prefix=""):
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        name = f"{prefix}{f.name}"
        ftype = hints.get(f.name, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            yield from _walk_fields(ftype, prefix=f"{name}.")
        else:
            yield name, ftype


def _parse_bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def add_config_args(parser: argparse.ArgumentParser, cls=ExperimentConfig):
    kinds = {bool: _parse_bool, int: int, float: float}
    for dotted, ftype in _walk_fields(cls):
        parser.add_argument("--" + dotted, dest=dotted, type=kinds.get(ftype, str), default=None)
    return parser


def apply_overrides(config: ExperimentConfig, ns: argparse.Namespace):
    for dotted, value in vars(ns).items():
        if value is None or "." not in dotted and not hasattr(config, dotted):
            continue
        obj = config
        parts = dotted.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        if hasattr(obj, parts[-1]):
            setattr(obj, parts[-1], value)
    return config


def _normalize_argv(argv):
    """Any dash/underscore mix in a flag's name; the registered spelling
    is all-underscore."""
    out = []
    for tok in argv:
        if tok.startswith("--"):
            if "=" in tok:
                name, val = tok[2:].split("=", 1)
                out.append("--" + name.replace("-", "_") + "=" + val)
            else:
                out.append("--" + tok[2:].replace("-", "_"))
        else:
            out.append(tok)
    return out


def parse_cli(argv=None) -> ExperimentConfig:
    import sys

    parser = argparse.ArgumentParser(prog="python -m lsenerf_tpu_torch.train",
                                     description="LSENeRF trainer (PyTorch port)")
    parser.add_argument("method", nargs="?", default="lsenerf")
    add_config_args(parser)
    argv = sys.argv[1:] if argv is None else list(argv)
    ns = parser.parse_args(_normalize_argv(argv))
    return apply_overrides(ExperimentConfig(method_name=ns.method), ns)


# ---------------------------------------------------------------------------
# config.yml: a YAML emitter and reader for nested mappings of scalars
# ---------------------------------------------------------------------------

_YAML_BOOL = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}
_YAML_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_YAML_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _yaml_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r:  # 1e-15 -> 1.0e-15: YAML 1.1 floats need the dot
            r = r.replace("e", ".0e")
        return r
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"config.yml holds str, int, float, bool and None, not {type(v).__name__}")


def dump_yaml(d: dict, indent: int = 0) -> str:
    lines = []
    for k, v in d.items():
        pad = " " * indent
        if isinstance(v, dict):
            lines.append(f"{pad}{k}:" + (" {}" if not v else ""))
            if v:
                lines.append(dump_yaml(v, indent + 2))
        else:
            lines.append(f"{pad}{k}: {_yaml_scalar(v)}")
    return "\n".join(lines)


def _parse_scalar(text: str):
    t = text.strip()
    if t.startswith("'"):
        if not t.endswith("'") or len(t) < 2:
            raise ValueError(f"config.yml: unterminated quote in {text!r}")
        return t[1:-1].replace("''", "'")
    if t.startswith('"'):
        return json.loads(t)
    if t in ("", "~", "null", "Null", "NULL"):
        return None
    if t == "{}":
        return {}
    if t.lower() in _YAML_BOOL and t in (t.lower(), t.upper(), t.capitalize()):
        return _YAML_BOOL[t.lower()]
    if _YAML_INT.match(t):
        return int(t.replace("_", ""))
    if _YAML_FLOAT.match(t):
        low = t.lower()
        if low.endswith("nan"):
            return float("nan")
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        return float(t.replace("_", ""))
    return t


def load_yaml(text: str) -> dict:
    """Block mappings indented by spaces, `key: scalar` or `key:` opening
    a nested mapping; comments and blank lines skipped."""
    root: dict = {}
    stack = [(-1, root)]
    for n, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line.strip() or line.lstrip().startswith("#") or line.strip() == "---":
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, rest = line.strip().partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise ValueError(f"config.yml line {n}: not a 'key: value' line: {raw!r}")
        while stack[-1][0] >= indent:
            stack.pop()
        parent = stack[-1][1]
        if rest.strip():
            parent[key] = _parse_scalar(rest)
        else:
            parent[key] = {}
            stack.append((indent, parent[key]))
    return root


# ---------------------------------------------------------------------------
# config.yml round trip
# ---------------------------------------------------------------------------


def to_dict(config) -> dict:
    return dataclasses.asdict(config)


def from_dict(cls, d: dict):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = hints.get(f.name, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            kwargs[f.name] = from_dict(ftype, v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def save_config(config: ExperimentConfig, path: str):
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(dump_yaml(to_dict(config)) + "\n")


def load_config(path: str) -> ExperimentConfig:
    with open(path) as f:
        return from_dict(ExperimentConfig, load_yaml(f.read()))


# ---------------------------------------------------------------------------
# modify_config: eval / pretrain surgery
# ---------------------------------------------------------------------------


def modify_config(config: ExperimentConfig) -> ExperimentConfig:
    """With --load-config: the saved config, keeping the CLI's run-control
    values; an eval run is named <method>/<scene>_eval_<mode> (<scene> =
    the loaded run's directory name; emb_eval.sh finds stage 1's run by
    it), evaluates all images 5 steps before its end (the pretrain: never),
    and refines SO3xR3 deltas of the eval cameras (the pretrain keeps the
    spline and fits the test embedding under deblur). Deblur always
    means the spline, and an eval run trains on RGB only."""
    from lsenerf_tpu_torch.engine.checkpoints import latest_step

    if config.load_config:
        ori = config
        config = load_config(config.load_config)
        for k in ("load_dir", "max_num_iterations", "steps_per_eval_image",
                  "steps_per_eval_all_images", "steps_per_save", "timestamp",
                  "emb_eval_mode", "is_eval", "do_pretrain", "is_render"):
            setattr(config, k, getattr(ori, k))
        col = config.pipeline.datamanager.col_dataparser
        col.image_type = ori.pipeline.datamanager.col_dataparser.image_type
        col.quality = ori.pipeline.datamanager.col_dataparser.quality
        if ori.output_dir != "outputs":
            config.output_dir = ori.output_dir
        if ori.data:
            config.data = ori.data
        config.pipeline.model.eval_num_rays_per_chunk = ori.pipeline.model.eval_num_rays_per_chunk

        scene_tag = osp.basename(osp.dirname(str(ori.load_dir)))
        if config.is_eval:
            config.method_name = osp.join(config.method_name,
                                          f"{scene_tag}_eval_{config.emb_eval_mode}")
            load = latest_step(str(ori.load_dir)) or 0
            config.steps_per_eval_all_images = load + config.max_num_iterations - 5
            config.pipeline.model.embed_config.eval_mode = config.emb_eval_mode
            if not config.do_pretrain:
                config.pipeline.model.rgb_loss_type = "linspace"
                config.pipeline.datamanager.rgb_loss_mode = "mse"
            else:
                config.steps_per_eval_all_images = load + config.max_num_iterations + 1000
        else:
            config.method_name = osp.join(config.method_name, f"{scene_tag}_camopt")

        cam = config.pipeline.datamanager.col_cam_optimizer
        cam.mode = "SO3xR3"
        if config.do_pretrain and config.pipeline.model.embed_config.eval_mode == "param":
            config.pipeline.model.rgb_loss_type = "deblur"
            config.pipeline.datamanager.rgb_loss_mode = "deblur"
        elif config.do_pretrain:
            raise ValueError("pretrain only makes sense with eval_mode='param'")
        else:
            cam.optim_type = "ns"
        cam.scheme = "active"

    if config.pipeline.model.rgb_loss_type == "deblur":
        config.pipeline.datamanager.rgb_loss_mode = "deblur"
        config.pipeline.datamanager.col_cam_optimizer.optim_type = "spline"
    if config.is_eval:
        config.pipeline.datamanager.rgb_frac = 1.0
    return config


# ---------------------------------------------------------------------------
# lowering: CLI tree -> the port's runtime configs
# ---------------------------------------------------------------------------


def _resolve_proposal_samples(config: ExperimentConfig) -> int:
    """-1 (auto) -> 16, except 0 under evs_emb (its per-frame table
    memorises the event quadrature's noise). Eval and pretrain runs always
    take 0, an explicit value included, as the JAX package does: they are
    short frozen-field refinements for the eval's sake."""
    if config.is_eval or config.do_pretrain:
        return 0
    m = config.pipeline.model
    if m.proposal_samples >= 0:
        return m.proposal_samples
    return 0 if m.embed_config.embedding_type == "evs_emb" else 16


def check_supported(config: ExperimentConfig) -> None:
    """Raise NotImplementedError for options the port does not have yet."""
    m = config.pipeline.model
    off_default = "ROADMAP.md §1, 'Off-default knobs'"
    unsupported = [
        (config.machine.num_devices > 1, "machine.num_devices > 1", "ROADMAP.md §1, 'Data parallel'"),
        (config.is_render, "is_render", "ROADMAP.md §1, 'Viewer and renders'"),
        (config.pipeline.datamanager.use_native, "use_native (the C++ prefetcher)", off_default),
        (m.proposal_warmup_steps > 0, "proposal_warmup_steps > 0", off_default),
        (m.hash_layout != "blocked", f"hash_layout={m.hash_layout!r}",
         "ROADMAP.md §2, K7 (the ngp layout)"),
        (m.disable_scene_contraction, "disable_scene_contraction", off_default),
        (m.coarse_stride > 1, "coarse_stride > 1", off_default),
        (m.compact_chunk > 0, "compact_chunk > 0", off_default),
        (m.grad_overflow_telemetry, "grad_overflow_telemetry (the port's table gradient is "
         "exact: there is no windowed update to count)", off_default),
    ]
    for bad, what, where in unsupported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet: {where}")


def build_runtime_configs(config: ExperimentConfig):
    """ExperimentConfig -> (TrainerConfig, ModelConfig, DataManagerConfig,
    ParserConfig) of the port."""
    from lsenerf_tpu_torch.data.datamanager import DataManagerConfig
    from lsenerf_tpu_torch.data.parser import ParserConfig
    from lsenerf_tpu_torch.engine import trainer as tr
    from lsenerf_tpu_torch.models import embeddings as emb_lib
    from lsenerf_tpu_torch.models import field as field_lib
    from lsenerf_tpu_torch.models import lsenerf as model_lib
    from lsenerf_tpu_torch.ops import hash_encoding as he
    from lsenerf_tpu_torch.ops import occupancy as occ_lib

    check_supported(config)
    m = config.pipeline.model
    dm = config.pipeline.datamanager
    scene_scale = dm.col_dataparser.scene_scale
    model_cfg = model_lib.ModelConfig(
        field=field_lib.FieldConfig(
            aabb_scale=scene_scale,
            hash=he.HashEncodingConfig(num_levels=m.num_levels, base_res=m.base_res,
                                       max_res=m.max_res, gather_dtype=m.compute_dtype),
            embedding=emb_lib.EmbeddingConfig(
                embedding_type=m.embed_config.embedding_type, emb_dim=m.embed_config.emb_dim,
                eval_mode=m.embed_config.eval_mode, is_eval=config.is_eval),
            compute_dtype=m.compute_dtype,
        ),
        grid=occ_lib.OccGridConfig(resolution=m.grid_resolution, levels=m.grid_levels,
                                   aabb_scale=scene_scale, sample_fraction=m.occ_sample_fraction),
        max_samples=m.max_samples,
        max_candidates=m.max_candidates,
        hierarchical_march=m.hierarchical_march,
        coarse_factor=m.coarse_factor,
        max_coarse_segments=m.max_coarse_segments,
        packed_phase2=m.packed_phase2,
        proposal_samples=_resolve_proposal_samples(config),
        proposal_uniform_frac=m.proposal_uniform_frac,
        background_color=m.background_color,
        evs_loss_weight=m.evs_loss_weight,
        event_loss_type=m.event_loss_type,
        rgb_loss_type=m.rgb_loss_type,
        use_mapping=m.use_mapping,
        mapping_method=m.mapping_method,
        evs_mapping_method=m.evs_mapping_method,
        map_mode=m.map_mode,
        ev_one_dim=m.ev_one_dim,
    ).normalized()

    def group(spec: OptimizerSpec) -> tr.OptimizerGroupConfig:
        return tr.OptimizerGroupConfig(
            lr=spec.optimizer.lr, eps=spec.optimizer.eps, lr_final=spec.scheduler.lr_final,
            max_steps=spec.scheduler.max_steps, warmup_steps=spec.scheduler.warmup_steps)

    def cam(c: CameraOptCLI) -> tr.CameraOptConfig:
        return tr.CameraOptConfig(mode=c.mode, optim_type=c.optim_type, scheme=c.scheme,
                                  delay_cnt=c.delay_cnt, exp_t=c.exp_t,
                                  control_pnt_factor=c.control_pnt_factor)

    if config.do_pretrain:
        mode = tr.RunMode.PRETRAIN
    elif config.is_render:
        mode = tr.RunMode.RENDER
    elif config.is_eval:
        mode = tr.RunMode.EVAL
    else:
        mode = tr.RunMode.TRAIN
    trainer_cfg = tr.TrainerConfig(
        max_num_iterations=config.max_num_iterations,
        steps_per_save=config.steps_per_save,
        steps_per_eval_batch=config.steps_per_eval_batch,
        steps_per_eval_image=config.steps_per_eval_image,
        steps_per_eval_all_images=config.steps_per_eval_all_images,
        seed=config.machine.seed,
        mode=mode,
        fields_optimizer=group(config.optimizers.fields),
        camera_optimizer=group(config.optimizers.camera_opt),
        col_cam_opt=cam(dm.col_cam_optimizer),
        evs_cam_opt=cam(dm.evs_cam_optimizer),
    )
    dm_cfg = DataManagerConfig(
        train_num_rays_per_batch=dm.train_num_rays_per_batch, rgb_frac=dm.rgb_frac,
        rgb_loss_mode=dm.rgb_loss_mode, eval_num_rays_per_batch=dm.eval_num_rays_per_batch,
        use_native=dm.use_native,
    )
    e_thresh = dm.evs_dataparser.e_thresh
    event_type = dm.evs_dataparser.event_type
    parser_cfg = ParserConfig(
        scale_factor=dm.col_dataparser.scale_factor,
        scene_scale=scene_scale,
        use_gray=dm.col_dataparser.use_gray,
        e_thresh=None if str(e_thresh).lower() == "none" else float(e_thresh),
        event_type=None if str(event_type).lower() == "none" else event_type,
        quality=dm.col_dataparser.quality,
        image_type=dm.col_dataparser.image_type,
    )
    return trainer_cfg, model_cfg, dm_cfg, parser_cfg
