"""A configuration, a traffic mix and a metric added as new files are found
by name, with no file that is there edited."""
import hashlib
import json
import time

from conftest import REPO

from portbench import load, run


def _digest(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_are_found(tiny):
    before = _digest(tiny)
    repo_before = _digest(REPO / "portbench")
    (tiny / "configs" / "adv_box_6.json").write_text(json.dumps({
        **load.config("adv_amr_48", tiny), "initial_length": [6, 4, 4],
        "adapt": {"diff_increase": 0.05, "diff_threshold": 0.5,
                  "hump": {"centre": [0.5, 0.5], "radius": 0.3}}}))
    (tiny / "traffic" / "step3.json").write_text(json.dumps(
        {"entry": "step", "k": 3, "cfl": 0.3}))
    (tiny / "cells" / "adv_box_6.step3.json").write_text(json.dumps(
        {"density_gap_first": 1e-3, "density_gap_later": 1e-3, "dt_gap": 1e-5,
         "leaf_mismatch": 0}))
    (tiny / "metrics" / "chunks_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.chunks))\n")
    bench_path = tiny.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "adv_box_6", "source": "test",
                             "file": "portbench/configs/adv_box_6.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "adv_box_6.step3", "config": "adv_box_6",
                               "traffic": "step3", "chips": 1, "why": "test"})
    bench["end_to_end"][0].setdefault("workloads", [])
    bench["per_layer"].append({"name": "chunks_seen", "unit": "chunks",
                               "better": "higher", "source": "host_clock",
                               "layer": "model", "moves": "cell_updates_per_s",
                               "workloads": ["adv_box_6.step3"]})
    bench["end_to_end"][0].pop("workloads")
    bench_path.write_text(json.dumps(bench))

    bench = load.benchmark(tiny)
    cell = load.workload(bench, "adv_box_6.step3")
    r = run.run_cell(bench, cell, 5, 0.2, True, "cpu", time.perf_counter(),
                     root=tiny, log=lambda m: None)
    assert r["correct"] is True
    assert r["metrics"]["chunks_seen"]["value"] == r["attempted"]
    after = _digest(tiny)
    assert all(after[k] == v for k, v in before.items())
    assert _digest(REPO / "portbench") == repo_before


def test_benchmark_json_names_only_files_that_exist():
    bench = load.benchmark()
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert load.config(c["name"])["model"]
    for w in bench["workloads"]:
        load.config(w["config"])
        load.traffic(w["traffic"])
        assert set(load.limits(w["name"])) == {
            "density_gap_first", "density_gap_later", "dt_gap", "leaf_mismatch"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(load.reader(m["name"]))


def test_benchmark_json_keeps_the_contract_shapes():
    bench = load.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    texts = [c["why"] for c in bench["configs"]] + [w["why"] for w in bench["workloads"]]
    texts += [c["source"] for c in bench["configs"]] + [m["layer"] for m in bench["per_layer"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in bench["end_to_end"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_reports_what_its_layer_metrics_move():
    """Each cell reports ``setup_s`` and another end-to-end metric, and each
    per-layer metric it reports moves one of them; a ``.cached`` reader is
    its plain twin's."""
    bench = load.benchmark()
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"] if load.applies(m, w["name"], bench)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layer = [m for m in bench["per_layer"] if load.applies(m, w["name"], bench)]
        assert layer and all(m["moves"] in e2e for m in layer), w["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"].endswith(".cached"):
            twin = load.reader(m["name"][:-len(".cached")])
            assert (load.reader(m["name"]).__code__.co_filename
                    == twin.__code__.co_filename)
