"""The harness on the CPU at small sizes: cells found from files alone, the
import check, the result line's keys, the refusal without a card."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest_portbench import ROOT, run_small, small_cell
from portbench import common, harness

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_a_cell_is_found_from_files_alone(tmp_path):
    """A new configuration, traffic mix, cell file and per-layer metric,
    added as files and entries of BENCHMARK.json, run without any other
    file changing."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "digits_1797", "source": "https://arxiv.org/abs/2212.11506",
                             "file": "portbench/configs/digits_1797.json", "reduced": [],
                             "why": "small"})
    bench["workloads"].append({"name": "digits_fit", "config": "digits_1797",
                               "traffic": "short_fit", "chips": 1, "why": "small"})
    for m in bench["end_to_end"]:
        if m["name"] == "fit_s":
            m["workloads"].append("digits_fit")
    bench["per_layer"].append({"name": "kl_calls", "unit": "1", "better": "lower",
                               "source": "program_counter", "layer": "descent",
                               "moves": "fit_s", "workloads": ["digits_fit"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = json.loads((harness.BENCH_DIR / "configs" / "mnist_70k.json").read_text())
    cfg.update(name="digits_1797", n=200, dim=16, n_iter=20, exaggeration_iters=10,
               momentum_switch_iter=10)
    (tmp_path / "portbench/configs/digits_1797.json").write_text(json.dumps(cfg))
    traffic = json.loads((harness.BENCH_DIR / "traffic" / "whole_fit.json").read_text())
    traffic.update(warmup_steps=2, backend_options={}, kl_every=10)
    (tmp_path / "portbench/traffic/short_fit.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/cells/digits_fit.json").write_text(json.dumps(
        {"limits": {"p_l1": 1.0, "step_rel": 10.0, "kl_rel": 10.0}}))
    (tmp_path / "portbench/metrics/kl_calls.py").write_text(
        'UNIT = "1"\n\n\ndef read(run):\n    return run.units[-1]["steps"] / 10\n')

    cell = harness.load_cell("digits_fit", root=tmp_path, bench_dir=tmp_path / "portbench")
    assert cell.config["n"] == 200 and cell.traffic["kl_every"] == 10
    assert cell.end_to_end == ["fit_s", "setup_s"]
    assert list(cell.per_layer) == ["kl_calls"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = harness.run_cell(cell, 5, 0.0, True, device="cpu", log=lambda m: None)
    finally:
        torch.set_num_threads(threads)
    assert out["correct"] is True
    assert out["metrics"] == {"kl_calls": {"value": 2.0, "unit": "1"}}
    # the committed cells are untouched by the new files
    assert harness.load_cell("mnist_bh_fit").per_layer.keys() == {
        "knn_s", "symmetrize_s", "descent_ms.fit", "idle_share.fit",
        "pairwise_roofline.fit", "attractive_roofline.fit"}
    assert list(harness.load_cell("mouse_bh_descent").per_layer) == ["idle_share.descent"]


@pytest.mark.parametrize("names, bad", [
    (["repro_torch", "repro_torch.api", "numpy", "portbench.harness"], []),
    (["repro", "numpy"], ["repro"]),
    (["repro.core.tsne"], ["repro"]),
    (["jax._src.core", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "reproducible", "flaxen"], []),
])
def test_import_check_compares_whole_top_level_names(names, bad):
    assert common.forbidden_modules(names) == bad


@pytest.mark.parametrize("workload", ["mnist_bh_fit", "mouse_bh_descent"])
def test_result_line_has_the_contract_keys(workload):
    out = run_small(workload)
    assert list(out) == CONTRACT_KEYS + ["checks"]
    cell = small_cell(workload)
    assert list(out["metrics"]) == cell.end_to_end
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["checks"]) == set(cell.limits)
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    json.dumps(out)


def test_traced_result_line_has_the_contract_keys():
    out = run_small("mnist_bh_fit", trace=True, config={"n_iter": 30})
    assert list(out) == CONTRACT_KEYS + ["breakdown", "checks"]
    # on the CPU no device operation is traced: the device readers are silent
    assert set(out["metrics"]) == {"knn_s", "symmetrize_s", "descent_ms.fit"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                           "mnist_bh_fit", "--seed", "3", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_readings_judge_each_variant_on_one_set_up():
    """``portbench/readings.py``: one set-up, a sound unit and a stuck one,
    each judged after the program's state is freed; the stuck one fails."""
    from portbench import readings
    cell = small_cell("mouse_bh_descent")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lines = list(readings.read(cell, 7, ["sound", "stuck_step"], None, "cpu"))
    finally:
        torch.set_num_threads(threads)
    assert [line["variant"] for line in lines] == ["sound", "stuck_step"]
    sound, stuck = (line["readings"] for line in lines)
    assert all(sound[k] <= limit for k, limit in cell.limits.items())
    assert stuck["z_ratio"] > cell.limits["z_ratio"]
