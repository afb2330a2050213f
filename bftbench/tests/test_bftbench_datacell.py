"""A cell added as data files alone (a configuration, a traffic mix and
an entry of BENCHMARK.json) runs, with no edit of a file that is there."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import tiny

REPO = Path(__file__).resolve().parents[2]


def test_a_cell_added_as_data_files_alone_runs(tmp_path):
    shutil.copytree(REPO / "bftbench", tmp_path / "bftbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = tiny.bench()
    cfg = json.loads((REPO / "bftbench/configs/hub180.json").read_text())
    cfg.update(name="hub12", validators=12, epoch=50, shift=4, chain_height=500)
    (tmp_path / "bftbench/configs/hub12.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "bftbench/traffic/lightstorm.json").read_text())
    mix.update(sessions=40, workers=4, heights=8, height_range=[250, 500], clients=2, forged=1)
    (tmp_path / "bftbench/traffic/lightpuff.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "hub12", "source": cfg["source"], "file": "bftbench/configs/hub12.json",
                             "reduced": ["validators"], "why": "a test"})
    bench["workloads"].append({"name": "lightpuff.hub12", "config": "hub12", "traffic": "lightpuff", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lightstorm.hub180" in m.get("workloads", []):
            m["workloads"].append("lightpuff.hub12")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(REPO)!r}]\n"
        "import torch; torch.set_num_threads(1)\n"
        "import bftbench.run as run\n"
        f"assert run.__file__.startswith({str(tmp_path)!r})\n"
        "line = run.run_cell('lightpuff.hub12', 7, 1.0, False, device='cpu', ref_workers=0)\n"
        "print(json.dumps(line))\n"
    )
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["light_headers_per_s"]["value"] > 0
