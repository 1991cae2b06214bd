"""The port's CLI configuration against the JAX package's, on the CPU.

For the argv of scripts/train_lse_data.sh under each configs/*.sh, of
scripts/eval.sh, of both stages of scripts/emb_eval.sh and of
scripts/parity.py --tiny: the parsed tree is the same dict, modify_config
and build_runtime_configs lower to the same values field by field, and
config.yml round-trips both ways (yaml.safe_load reads the port's file;
the port reads the JAX CLI's).
"""

import dataclasses
import json
import os
import os.path as osp
import re
import shlex
from pathlib import Path

import pytest
import yaml

from lsenerf_tpu.engine import config as jcfg
from lsenerf_tpu.engine import trainer as jtr
from lsenerf_tpu_torch.engine import config as tcfg

ROOT = Path(__file__).resolve().parent.parent
PRESETS = ["lsenerf", "lsenerf_emb", "badnerf", "badnerf_emb"]


def script_invocations(script: str, values: dict) -> list:
    """The train.py argv of each `python train.py ...` line of a script,
    with its $VAR, ${VAR}, "$VAR/..." and $((a + b)) substituted from
    `values` and the script's own assignments."""
    text = (ROOT / "scripts" / script).read_text().replace("\\\n", " ")
    env = dict(values)

    def subst(line):
        line = re.sub(r"\$\(\((\d+) \+ (\d+)\)\)", lambda g: str(int(g[1]) + int(g[2])), line)
        return re.sub(r"\$\{?(\w+)\}?", lambda g: env.get(g[1], g[0]), line)

    out = []
    for line in text.splitlines():
        m = re.match(r"^(\w+)=(\S*)\s*(#.*)?$", line.strip())
        if m and m[1] not in env:
            env[m[1]] = subst(m[2].strip('"'))
        if line.strip().startswith("python train.py"):
            out.append(shlex.split(subst(line))[2:])
    return out


def train_argv(preset: str, data: str = "scene") -> list:
    values = {}
    for line in (ROOT / "configs" / f"{preset}.sh").read_text().splitlines():
        m = re.match(r"^(\w+)=(\S+)", line)
        if m:
            values[m[1]] = m[2]
    return script_invocations("train_lse_data.sh", dict(values, DATA=data))[0]


def parity_tiny_argv(data: str = "scene") -> list:
    """scripts/parity.py's train argv with --tiny (1500 steps, seed 96)."""
    src = (ROOT / "scripts" / "parity.py").read_text()
    block = src.split("if args.tiny:")[1].split("argv_train += list(args.extra)")[0]
    tiny = re.findall(r'"(--pipeline\.[\w.-]+)", "([\w.]+)"', block)
    assert len(tiny) == 10
    argv = ["lsenerf", "--data", data, "--output-dir", "run", "--machine.seed", "96",
            "--max-num-iterations", "1500", "--steps-per-eval-all-images", "1500",
            "--steps-per-save", "1500", "--steps-per-eval-image", "15000",
            "--pipeline.datamanager.rgb_frac", "0.66"]
    for flag, val in tiny:
        argv += [flag, val]
    return argv


def _same_fields(t, j, path=""):
    """Every field of the port's dataclass `t` equals the JAX object's."""
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            _same_fields(tv, jv, f"{path}{f.name}.")
        else:
            assert tv == jv, f"{path}{f.name}: port {tv!r}, JAX {jv!r}"
    for extra in ("train_num_col_rays_per_batch", "train_num_evs_rays_per_batch"):
        if hasattr(t, extra):
            assert getattr(t, extra) == getattr(j, extra), extra


def _lower_both(argv):
    j = jcfg.modify_config(jcfg.parse_cli(argv))
    t = tcfg.modify_config(tcfg.parse_cli(argv))
    assert tcfg.to_dict(t) == jcfg.to_dict(j)
    for tp, jp in zip(tcfg.build_runtime_configs(t), jcfg.build_runtime_configs(j)):
        _same_fields(tp, jp)
    return t, j


@pytest.mark.parametrize("preset", PRESETS)
def test_train_script_lowers_as_jax(preset):
    _lower_both(train_argv(preset))


def test_parity_tiny_lowers_as_jax():
    from lsenerf_tpu_torch import parity

    argv = parity_tiny_argv()
    assert argv[-len(parity.TINY):] == parity.TINY
    t, _ = _lower_both(argv)
    assert t.pipeline.model.background_color == "white"
    assert t.pipeline.model.num_levels == 4 and t.machine.seed == 96


@pytest.fixture()
def trained_run(tmp_path):
    """A train run's directory as the CLI leaves it (lsenerf preset):
    config.yml written by each package and a checkpoints dir at step 99."""
    def make(preset, writer):
        lib = jcfg if writer == "jax" else tcfg
        cfg = lib.modify_config(lib.parse_cli(train_argv(preset)))
        cfg.output_dir = str(tmp_path / writer / "outputs_tpu")
        cfg.experiment_name, cfg.timestamp = "scene", "2026-01-01_000000"
        run = cfg.base_dir()
        os.makedirs(osp.join(run, "checkpoints", "step-000000099"))
        lib.save_config(cfg, osp.join(run, "config.yml"))
        return run
    return make


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_eval_script_lowers_as_jax(trained_run, writer):
    run = trained_run("lsenerf", writer)
    (argv,) = script_invocations("eval.sh", {"EXP_PATH": run})
    t, j = _lower_both(argv)
    assert t.base_dir().startswith(run + "_eval_zero")
    assert t.steps_per_eval_all_images == 99 + 6010 - 5
    assert t.pipeline.datamanager.rgb_frac == 1.0
    assert t.pipeline.datamanager.col_cam_optimizer.optim_type == "ns"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_emb_eval_stages_lower_as_jax(trained_run, writer, tmp_path):
    """Stage 1 (the test-embedding pretrain) and stage 2, with stage 2's
    run dir found by the script's own rule from stage 1's method name."""
    run = trained_run("lsenerf_emb", writer)
    stage1, stage2 = script_invocations("emb_eval.sh", {"EXP_PATH": run})
    t1, _ = _lower_both(stage1)
    assert t1.do_pretrain and t1.pipeline.model.rgb_loss_type == "deblur"
    assert t1.method_name == osp.join("LSENeRF_emb", "2026-01-01_000000_eval_param")
    # the script takes the newest entry of ${EXP_PATH}_eval_param as stage 1's run
    t1.timestamp = "2026-01-02_000000"
    stage1_dir = t1.base_dir()
    assert osp.dirname(stage1_dir) == run + "_eval_param"
    os.makedirs(osp.join(stage1_dir, "checkpoints", "step-000003109"))
    tcfg.save_config(t1, osp.join(stage1_dir, "config.yml"))
    param_exp_path = run + "_eval_param"
    last_dir = sorted(d for d in os.listdir(param_exp_path) if "_eval_param" not in d)[-1]
    _, stage2 = script_invocations("emb_eval.sh", {"EXP_PATH": run, "LAST_DIR": last_dir})
    assert stage2[stage2.index("--load-dir") + 1] == osp.join(stage1_dir, "checkpoints")
    t2, _ = _lower_both(stage2)
    assert t2.method_name == osp.join("LSENeRF_emb", "2026-01-01_000000_eval_param",
                                      "2026-01-02_000000_eval_param")
    assert not t2.do_pretrain and t2.pipeline.model.embed_config.eval_mode == "param"


@pytest.mark.parametrize("preset", PRESETS)
def test_config_yml_round_trips(preset, tmp_path):
    """The port's file reads back to the same tree, and yaml.safe_load
    reads it to the same dict; the port reads the JAX CLI's file (PyYAML's
    output) to the dict yaml.safe_load gives."""
    t = tcfg.modify_config(tcfg.parse_cli(train_argv(preset) + ["--load-dir", "it's here"]))
    p = str(tmp_path / "port.yml")
    tcfg.save_config(t, p)
    assert tcfg.to_dict(tcfg.load_config(p)) == tcfg.to_dict(t)
    assert yaml.safe_load(open(p)) == tcfg.to_dict(t)
    j = jcfg.modify_config(jcfg.parse_cli(train_argv(preset)))
    jp = str(tmp_path / "jax.yml")
    jcfg.save_config(j, jp)
    assert tcfg.to_dict(tcfg.load_config(jp)) == yaml.safe_load(open(jp)) == jcfg.to_dict(j)


def test_yaml_scalars_read_as_pyyaml_reads_them():
    """Each scalar form PyYAML writes (and a few it reads) resolves alike."""
    d = {"a": 1e-15, "b": 0.03125, "c": 30000.0, "d": -3, "e": True, "f": None, "g": "",
         "h": "None", "i": "true", "j": "1.0", "k": "a: b", "l": "o'clock", "m": "2026-10-17_001912",
         "n": float("inf"), "o": {"p": {"q": "SO3xR3"}}}
    text = yaml.safe_dump(d, sort_keys=False)
    assert tcfg.load_yaml(text) == d
    assert yaml.safe_load(tcfg.dump_yaml(d)) == d
    for s in ("yes", "Off", "~", "1_000", "-.inf", "12e3", ".5"):
        assert tcfg.load_yaml(f"x: {s}") == yaml.safe_load(f"x: {s}"), s


# the options the JAX package takes off its defaults, each with the field
# it lowers into: (flags, (object, field, value)) with object "model",
# "trainer" or "dm" (the runtime configs) or "tree" (the CLI tree, which
# train.py reads)
OPTION_FLAGS = {
    "num_devices": (["--machine.num-devices", "2"], ("tree", "machine.num_devices", 2)),
    "use_native": (["--pipeline.datamanager.use-native", "True"], ("dm", "use_native", True)),
    "proposal_warmup_steps": (["--pipeline.model.proposal-warmup-steps", "100"],
                              ("tree", "pipeline.model.proposal_warmup_steps", 100)),
    "is_render": (["--is_render", "True"], ("trainer", "mode", "render")),
    "compact_chunk": (["--pipeline.model.compact-chunk", "4096"], ("model", "compact_chunk", 4096)),
}


@pytest.mark.parametrize("name", list(OPTION_FLAGS))
def test_options_lower_as_jax(name):
    """Each option lowers into the port's runtime configs field by field as
    JAX's build_runtime_configs lowers it, and lands where the run reads
    it; under --machine.num-devices 2 the ray budgets round to the ranks
    as JAX's round_rays_to_mesh rounds them to a 2-device mesh."""
    flags, (obj, field, value) = OPTION_FLAGS[name]
    t, j = _lower_both(["lsenerf"] + flags)
    trainer, model, dm, _ = tcfg.build_runtime_configs(t)
    target = {"tree": t, "trainer": trainer, "model": model, "dm": dm}[obj]
    for part in field.split("."):
        target = getattr(target, part)
    assert target == value
    if name == "num_devices":
        from lsenerf_tpu.parallel import mesh as mesh_lib
        from lsenerf_tpu_torch.parallel import ddp

        jdm = jcfg.build_runtime_configs(j)[2]
        for d in (dm, jdm):
            d.train_num_col_rays_per_batch, d.train_num_evs_rays_per_batch = 2319, 597
        ddp.round_rays(dm, 2)
        mesh_lib.round_rays_to_mesh(jdm, mesh_lib.make_mesh(2))
        assert (dm.train_num_col_rays_per_batch, dm.train_num_evs_rays_per_batch) == (
            jdm.train_num_col_rays_per_batch, jdm.train_num_evs_rays_per_batch) == (2318, 596)
        assert dm.num_hosts == 2  # a process a rank; JAX's one process drives both devices


def test_unported_options_raise():
    """No option raises any more: grad_overflow_telemetry, the last one the
    port refused, lowers into its ModelConfig as JAX's CLI lowers it, and
    the sentinel's cadence is JAX's default."""
    argv = ["lsenerf", "--pipeline.model.grad-overflow-telemetry", "True"]
    tc, tm, _, _ = tcfg.build_runtime_configs(tcfg.modify_config(tcfg.parse_cli(argv)))
    assert tm.grad_overflow_telemetry is True
    jm = jcfg.build_runtime_configs(jcfg.modify_config(jcfg.parse_cli(argv)))[1]
    assert jm.grad_overflow_telemetry is True
    assert tc.grad_overflow_every == jtr.TrainerConfig().grad_overflow_every == 256


# flags that lower into the hash encoding and the field, each alone on the
# CLI's defaults and on the lsenerf preset's argv
FIELD_FLAGS = {
    "hash_layout": ["--pipeline.model.hash-layout", "ngp"],
    "coarse_stride": ["--pipeline.model.coarse-stride", "2"],
    "disable_scene_contraction": ["--pipeline.model.disable-scene-contraction", "True"],
    "log2_hashmap_size": ["--pipeline.model.log2-hashmap-size", "12"],
    "coarse_levels": ["--pipeline.model.coarse-stride", "4", "--pipeline.model.coarse-levels", "6"],
    "ngp_f32": ["--pipeline.model.hash-layout", "ngp", "--pipeline.model.compute-dtype",
                "float32"],
}


@pytest.mark.parametrize("base", ["defaults", "lsenerf"])
@pytest.mark.parametrize("name", list(FIELD_FLAGS))
def test_field_flags_lower_as_jax(name, base):
    """Each flag lowers to the port's FieldConfig and HashEncodingConfig
    field by field as JAX's build_runtime_configs lowers it."""
    argv = (["lsenerf"] if base == "defaults" else train_argv("lsenerf")) + FIELD_FLAGS[name]
    _lower_both(argv)


def golden_ngpf32_argv(data: str = "scene") -> list:
    """scripts/golden_real_scale.py's train argv for the
    real_scale_badnerf_ngpf32 golden: the headline protocol and the extra
    flags recorded in scripts/golden_parity.json."""
    entry = json.loads((ROOT / "scripts" / "golden_parity.json").read_text())[
        "real_scale_badnerf_ngpf32"]
    extra = entry["protocol"]["config"].split(" + ", 1)[1].split()
    src = (ROOT / "scripts" / "golden_real_scale.py").read_text()
    block = src.split("# headline protocol (scripts/train_lse_data.sh)")[1].split("] + (")[0]
    headline = re.findall(r'"(--[\w.-]+)", "([\w.]+)"', block)
    argv = ["lsenerf", "--data", data, "--output-dir", "run", "--machine.seed", "96",
            "--max-num-iterations", "8000", "--steps-per-save", "5000",
            "--steps-per-eval-image", "2666", "--steps-per-eval-all-images", "8000",
            "--steps-per-eval-batch", "2666", "--pipeline.datamanager.rgb_frac", "0.66"]
    for flag, val in headline:
        argv += [flag, val]
    for flag in extra:
        argv += flag.split("=", 1)
    return argv


def test_golden_ngpf32_flags_lower_as_jax():
    """The real_scale_badnerf_ngpf32 golden's whole flag set, and the
    port's copy of its flags and its PSNR / SSIM in parity.py."""
    from lsenerf_tpu_torch import parity

    argv = golden_ngpf32_argv()
    t, _ = _lower_both(argv)
    assert argv[-len(parity.NGPF32):] == parity.NGPF32
    assert argv[-len(parity.NGPF32) - len(parity.HEADLINE):-len(parity.NGPF32)] == parity.HEADLINE
    _, model, dm, _ = tcfg.build_runtime_configs(t)
    assert (model.field.hash.layout, model.field.compute_dtype, model.field.hash.gather_dtype) == (
        "ngp", "float32", "float32")
    assert dm.rgb_frac == 1.0 and not model.use_mapping and model.rgb_loss_type == "deblur"
    golden = json.loads((ROOT / "scripts" / "golden_parity.json").read_text())[
        "real_scale_badnerf_ngpf32"]
    for k, (psnr, ssim) in parity.GOLDEN_NGPF32.items():
        assert (psnr, ssim) == (golden[k]["psnr"], golden[k]["ssim"])
