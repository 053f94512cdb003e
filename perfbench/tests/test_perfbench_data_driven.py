"""A later cell, configuration, mix and per-layer metric go in as new files
and new entries of BENCHMARK.json: a copy of the benchmark gains one of
each, every existing file of the copy stays byte for byte, and a run of the
new cell finds them all by name."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from perfbench.tests.conftest import ROOT, SMALL


def _digests(top: str) -> dict:
    out = {}
    for base, _, files in os.walk(os.path.join(top, "perfbench")):
        for name in files:
            if name.endswith((".py", ".json")):
                path = os.path.join(base, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, top)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_cell_config_mix_and_metric_are_files_and_entries(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), copy / "perfbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    before = _digests(str(copy))
    pb = copy / "perfbench"
    cfg = json.loads((pb / "configs" / "randla_net.json").read_text())
    (pb / "configs" / "randla_net_copy.json").write_text(
        json.dumps(dict(cfg, name="randla_net_copy")))
    mix = json.loads((pb / "traffic" / "subtile_predict.json").read_text())
    (pb / "traffic" / "small_mix.json").write_text(json.dumps(dict(mix, **SMALL["predict_step"])))
    (pb / "metrics" / "steps_run.py").write_text(
        '"""Steps the window ran."""\n\n\ndef read(record):\n    return float(record["steps"])\n')
    limits = json.loads((pb / "limits" / "randla.predict_step.json").read_text())
    (pb / "limits" / "copy.small.json").write_text(json.dumps(limits))
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "randla_net_copy",
                             "source": "https://arxiv.org/abs/1911.11236",
                             "file": "perfbench/configs/randla_net_copy.json", "reduced": [],
                             "why": "a copy"})
    bench["workloads"].append({"name": "copy.small", "config": "randla_net_copy",
                               "traffic": "small_mix", "chips": 1, "why": "a small cell"})
    bench["end_to_end"][1]["workloads"].append("copy.small")
    bench["per_layer"].append({"name": "steps_run", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "model step",
                               "moves": "predict_step_mpts_per_s", "workloads": ["copy.small"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, types, torch\n"
        "from perfbench import run\n"
        "assert run.__file__.startswith(sys.argv[1]), run.__file__\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "cell, config, traffic = run.cell_of(bench, 'copy.small')\n"
        "args = types.SimpleNamespace(seed=5, seconds=0.0, trace=1)\n"
        "res = run.execute(bench, cell, config, traffic, args, torch.device('cpu'))\n"
        "print(json.dumps({'metrics': res['metrics'], 'correct': res['correct'],"
        " 'rows': traffic['rows'], 'config': config['name']}))\n")
    env = dict(os.environ, PYTHONPATH=f"{copy}{os.pathsep}{ROOT}")
    proc = subprocess.run([sys.executable, "-c", code, str(copy)], cwd=copy, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["config"] == "randla_net_copy" and got["rows"] == SMALL["predict_step"]["rows"]
    assert got["metrics"]["steps_run"]["value"] >= 1 and got["correct"]
    assert "enqueue_ms.predict_step" not in got["metrics"]   # listed for other cells only
    after = _digests(str(copy))
    assert {k: after[k] for k in before} == before
