"""A configuration, a mix, a cell and a per-layer metric are added as new
files only: in a temporary copy of the benchmark, new files and new
entries in BENCHMARK.json, and a CPU rehearsal reports the new metric
for the new cell with no other edit.  A data file that states a setting
no run applies is refused."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import shapes, spec, traffic

ROOT = Path(__file__).resolve().parents[2]

METRIC = '''"""Steps the traced window ran."""


def read(run):
    return float(run.units)
'''


def test_new_files_are_picked_up(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "kubeflow_tpu_torch").symlink_to(ROOT / "kubeflow_tpu_torch")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    config = json.loads((b / "configs" / "mistral-7b-pp2.json").read_text())
    config.update(vocab_size=256, num_hidden_layers=2, hidden_size=128,
                  num_attention_heads=2, num_key_value_heads=1,
                  intermediate_size=256)
    (b / "configs" / "tiny-dense.json").write_text(json.dumps(config))
    (b / "traffic" / "tiny-train.json").write_text(json.dumps(
        {"kind": "train", "batch": 2, "seq": 128}))
    cell = json.loads((b / "cells" / "mistral-7b.train-4k.json").read_text())
    (b / "cells" / "tiny-dense.train.json").write_text(json.dumps(cell))
    (b / "metrics" / "steps_seen.train.py").write_text(METRIC)
    bench["configs"].append({"name": "tiny-dense", "source": "test",
                             "file": "benchmark/configs/tiny-dense.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-dense.train",
                               "config": "tiny-dense",
                               "traffic": "tiny-train", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("tiny-dense.train")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "training step",
                               "moves": "train_tokens_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = ("from benchmark import run\n"
              "run.main(['--workload', 'tiny-dense.train', '--seed', '11',"
              " '--seconds', '0.3', '--trace', '1'], device='cpu')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metrics"]["steps_seen.train"]["value"] >= 1
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("kind,key,value", [
    ("traffic", "clients", 4), ("traffic", "sampling", "top_k"),
    ("traffic", "tokens", "zipf"), ("assumed", "int4_group", 128),
    ("assumed", "aux_loss", "switch-top2"), ("published", "hidden_act",
                                             "gelu"),
    ("cell", "clients", 4)])
def test_a_setting_no_run_applies_is_refused(kind, key, value, monkeypatch,
                                             tmp_path):
    if kind == "traffic":
        mix = json.loads((shapes.ROOT / "traffic" / "chat-b16.json")
                         .read_text())
        (tmp_path / "traffic").mkdir()
        (tmp_path / "traffic" / "chat-b16.json").write_text(
            json.dumps({**mix, key: value}))
        monkeypatch.setattr(traffic, "ROOT", tmp_path)
        with pytest.raises(ValueError, match=key):
            traffic.load("chat-b16")
    elif kind == "cell":
        setting = spec.cell("mistral-7b.int4-chat")
        (tmp_path / "cells").mkdir()
        (tmp_path / "cells" / "x.json").write_text(
            json.dumps({**setting, key: value}))
        monkeypatch.setattr(spec, "ROOT", tmp_path)
        with pytest.raises(ValueError, match=key):
            spec.cell("x")
    else:
        cfg = shapes.load_json(shapes.ROOT / "configs"
                               / "mixtral-8x7b-l2.json")
        if kind == "assumed":
            cfg["assumed"][key] = value
        else:
            cfg[key] = value
        with pytest.raises(ValueError, match=key):
            shapes.shape_from("x", cfg)


def test_the_committed_data_files_load():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        spec.cell(w["name"])
        traffic.load(w["traffic"])
    for c in bench["configs"]:
        shapes.load_shape(c["name"])
