"""The harness: finding things by name, the window's arithmetic, the
frozen roofline count and the result line."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from tiny import TINY, bench, run_tiny

from bftbench import core, roofline

ROOT = core.ROOT


def test_loader_finds_config_mix_cell_and_metric_by_name():
    b = bench()
    cell = core.find_cell(b, "lightstorm.hub180")
    assert cell["config"] == "hub180" and cell["traffic"] == "lightstorm"
    assert core.load_config(b, "hub180")["validators"] == 180
    assert core.load_json("traffic", "lightstorm")["driver"] == "light_storm"
    assert core.load_driver(core.load_json("traffic", "catchup")).__name__ == "bftbench.drivers.catchup"
    names = [m["name"] for m in core.metrics_for(b, cell, trace=True)]
    assert "light.jobs_per_dispatch" in names and "exec.apply_ms_per_block" not in names
    assert core.read_metrics([{"name": "light.jobs_per_dispatch", "unit": "jobs"}],
                             {"light": {"jobs_batched": 30, "dispatches": 10}}, True) == {
        "light.jobs_per_dispatch": {"value": 3.0, "unit": "jobs"}}
    with pytest.raises(core.BenchError):
        core.find_cell(b, "no.such_cell")


@pytest.mark.parametrize("which", ["BENCHMARK.json", "with the light storm"])
def test_every_metric_and_cell_has_its_files(which):
    b = core.load_benchmark() if which == "BENCHMARK.json" else bench()
    for c in b["configs"]:
        assert (core.ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for m in b["end_to_end"]:
        assert (core.HERE / "e2e" / f"{m['name']}.py").is_file()
    for m in b["per_layer"]:
        assert (core.HERE / "metrics" / f"{m['name']}.py").is_file()
        moves = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves.get("workloads", m["workloads"]))
    for c in b["workloads"]:
        assert core.load_driver(core.load_json("traffic", c["traffic"]))


def test_rate_counts_all_the_work_over_all_the_window():
    done = [0.5, 1.0, 1.5, 2.0, 9.9, 10.5]
    assert core.rate(done, 0.0, 10.0) == 0.5  # 5 in the window; the one after it does not count


def test_p95_is_over_every_request():
    lat = [10.0] * 95 + [100.0] * 5
    assert core.percentile(lat, 0.95) == 10.0
    assert core.percentile(lat + [100.0], 0.95) == 100.0


def test_a_stalled_window_moves_both():
    # 100 answers/s for 10 s, each 5 ms; then the same with the node
    # stalled 2 s from t = 4: what follows comes 2 s later, and the 64
    # requests in flight at the stall wait it out
    steady = [i * 0.01 for i in range(1000)]
    stalled = [t if t < 4.0 else t + 2.0 for t in steady]
    assert core.rate(steady, 0.0, 10.0) == 100.0
    assert core.rate(stalled, 0.0, 10.0) == pytest.approx(80.0, abs=0.2)
    lat_steady = [5.0] * 1000
    lat_stalled = [5.0] * 736 + [2000.0] * 64
    assert core.percentile(lat_steady, 0.95) == 5.0
    assert core.percentile(lat_stalled, 0.95) == 2000.0


def test_roofline_count_at_one_lane_against_a_hand_count():
    rate = 1e12
    # K1: 1,899 multiplies x 100 + 1,037 squares x 55 products; K2: two
    # points of 18 x 100 + 255 x 55; K3: one SHA-512 block + 600 ops
    k1 = (1899 * 100 + 1037 * 55) / rate
    k2 = 2 * (18 * 100 + 255 * 55) / rate
    k3 = (80 * 28 + 64 * 20 + 16 + 32 + 600) / rate
    assert roofline.fe_products("ladder") == 1899 * 100 + 1037 * 55
    assert roofline.sha_blocks(46) == 1 and roofline.sha_blocks(47) == 1 and roofline.sha_blocks(48) == 2
    assert roofline.bound_s(1, 128, 1, rate) == pytest.approx(k1 + k2 + k3)
    # at a slow enough memory the bytes bound instead
    assert roofline.bound_s(1, 128, 1, 1e30) == pytest.approx(
        (452 + 2 * 193 + 128 + 229) / roofline.HBM_BYTES_S)


def test_result_line_keys_on_a_cpu_run():
    line = run_tiny("lightstorm.hub180")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"light_headers_per_s", "light_p95_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["checks"] == {n: {"value": 0, "limit": 0} for n in
                              ("header_mismatches", "verdict_mismatches", "unanswered")}


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "bftbench/run.py", "--workload", "catchup.osmosis150", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "cuda" in p.stderr.lower()


def test_tiny_sizes_name_only_known_keys():
    b = bench()
    for cell, over in TINY.items():
        c = core.find_cell(b, cell)
        known = set(core.load_config(b, c["config"])) | set(core.load_json("traffic", c["traffic"]))
        assert set(over) <= known, cell


def test_checks_print_last_on_stderr_and_last_in_the_line(monkeypatch, capsys):
    from bftbench import run

    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"correct": True, "attempted": 1, "failed": 0,
                                                         "metrics": {}, "device": {}, "checks": {
                                                             "a": {"value": 0, "limit": 0}}})
    assert run.main(["--workload", "x", "--seed", "1", "--seconds", "1"]) == 0
    out, err = capsys.readouterr()
    assert list(json.loads(out.strip().splitlines()[-1]))[-1] == "checks"
    assert err.strip().splitlines()[-1] == "check a = 0 (limit 0)"


def test_a_directory_of_the_benchmark_alone_exits_nonzero_and_prints_no_result(tmp_path):
    shutil.copytree(core.HERE, tmp_path / "bftbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    head = f"import sys\nsys.path.insert(0, {str(tmp_path)!r})\nfrom bftbench import run\n"
    calls = ("run.main(['--workload', 'catchup.osmosis150', '--seed', '1', '--seconds', '1'])",
             # past the card check (a CPU run) the cell needs the program, which is not there
             "run.run_cell('catchup.osmosis150', 1, 1.0, False, device='cpu')")
    for call in calls:
        p = subprocess.run([sys.executable, "-c", head + f"sys.exit({call})\n"], cwd=tmp_path,
                           env=dict(os.environ, PYTHONPATH=""), capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout == "", call
    assert "cometbft_tpu_torch" in p.stderr
