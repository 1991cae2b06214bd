"""The manifest and the files it names: the contract's shape, and that a
configuration, a traffic mix, a kernel family and a per-layer metric
added as files (with their manifest entries) are found by name without
editing any file that is there."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    return manifest.manifest()


def test_manifest_has_exactly_the_contract_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert man["paths"] == ["perfbench"]
    assert 1 <= man["run_seconds"] <= 51
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert len(json.dumps(man)) < 64 * 1024


def test_names_units_and_moves(man):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["unit"] in ("s", "ms", "%")
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}
    for w in man["workloads"]:
        e2e = {m["name"] for m in manifest.end_to_end(w["name"], man)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = manifest.per_layer(w["name"], man)
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_named_file_is_there(man):
    for w in man["workloads"]:
        cfg = manifest.config(w["config"], man)
        assert cfg["name"] == w["config"]
        tr = manifest.traffic(w["traffic"])
        assert hasattr(manifest.driver(tr), "run")
        assert manifest.limits(w["name"])
    for m in man["per_layer"]:
        assert hasattr(manifest.metric_reader(m["name"]), "read")
    fams = manifest.kernel_families()
    assert {"K1", "K2", "K7a", "K7b", "K3", "K5a", "K5b"} <= set(fams)
    for f in fams.values():
        if f["bound"]:
            assert callable(manifest.bound_function(f["bound"]))


def test_reduced_keys_are_in_the_config_file(man):
    for c in man["configs"]:
        spec = manifest.load_json(manifest.ROOT / c["file"])
        assert spec["reduced"] == c["reduced"]
        assert spec["source"] and spec["preset"]


def test_new_files_are_found_by_name(tmp_path, man):
    """A later PR adds a config, a traffic mix, a kernel family and a
    per-layer metric as new files and manifest entries, and edits none."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH, root / "perfbench")
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    bench = root / "perfbench"
    new = dict(man)
    cfg = manifest.load_json(bench / "configs" / "lsenerf.json")
    (bench / "configs" / "lsenerf_f4.json").write_text(json.dumps(dict(cfg, name="lsenerf_f4")))
    (bench / "traffic" / "train_scan1.json").write_text(json.dumps(
        {"driver": "train", "scan_steps": 1, "warm_chunks": 2, "trace_chunks": 16}))
    (bench / "limits" / "lsenerf_f4.train_scan1.json").write_text(json.dumps(
        {"loss_gap": {"limit": 1e-4}}))
    (bench / "kernels" / "K9.json").write_text(json.dumps(
        {"patterns": [r"\bnew_kernel\b"], "layer": "encode", "bound": "bounds.ngp_fwd"}))
    (bench / "metrics" / "new_share.train.py").write_text("def read(r):\n    return 42.0\n")
    new["configs"] = man["configs"] + [dict(man["configs"][0], name="lsenerf_f4",
                                            file="perfbench/configs/lsenerf_f4.json")]
    new["workloads"] = man["workloads"] + [dict(man["workloads"][0], name="lsenerf_f4.train_scan1",
                                                config="lsenerf_f4", traffic="train_scan1")]
    new["per_layer"] = man["per_layer"] + [
        {"name": "new_share.train", "unit": "%", "better": "higher", "source": "device_trace",
         "layer": "encode", "moves": "step_ms", "workloads": ["lsenerf_f4.train_scan1"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(new))

    got = manifest.manifest(root)
    w = manifest.cell("lsenerf_f4.train_scan1", got)
    assert manifest.config(w["config"], got, root)["name"] == "lsenerf_f4"
    tr = manifest.traffic(w["traffic"], bench)
    assert tr["scan_steps"] == 1 and hasattr(manifest.driver(tr, bench), "run")
    assert manifest.limits(w["name"], bench)["loss_gap"]["limit"] == 1e-4
    assert "K9" in manifest.kernel_families(bench)
    assert manifest.metric_reader("new_share.train", bench).read(None) == 42.0
    assert "new_share.train" in {m["name"] for m in manifest.per_layer(w["name"], got)}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
