"""The benchmark as files: ``BENCHMARK.json`` against the contract, every
name resolving to its file, a cell and a metric added as files only, the
imports of every file, and the command's refusals."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import harness

REPO, ROOT = harness.REPO, harness.ROOT
BENCH = harness.load_json(os.path.join(REPO, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert harness.load_json(os.path.join(REPO, c["file"]))["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        cell = harness.find_cell(w["name"], BENCH)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert os.path.isfile(os.path.join(ROOT, "traffic", cell.mix["kind"] + ".py"))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(ROOT, "metrics", m["name"] + ".py"))
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in cells and w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def _copy(tmp_path):
    shutil.copytree(ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", ".trace", "__pycache__"))
    return json.loads(json.dumps(BENCH))


def test_a_cell_and_a_metric_added_as_files_run(tmp_path):
    bench = _copy(tmp_path)
    cfg = harness.load_json(os.path.join(ROOT, "configs", "fever50k.json"))
    cfg["corpus"].update(num_docs=300, hash_size=1 << 18)
    cfg["ranker"]["fixed_union_cap"] = 512
    (tmp_path / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    mix = harness.load_json(os.path.join(ROOT, "workloads", "retrieve_claims4096.json"))
    mix.update(batch=32, pool_batches=2, sample_queries=32)
    (tmp_path / "benchmark/workloads/tiny_claims32.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/metrics/claims_per_request.py").write_text(
        "def read(run):\n    return run.rate() * run.window_s / len(run.requests)\n")
    bench["workloads"].append({"name": "tiny.retrieve", "config": "tiny",
                               "traffic": "tiny_claims32", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "claims_per_request", "unit": "claims", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["tiny.retrieve"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("retrieval_qps", "request_p95_ms"):
            m["workloads"].append("tiny.retrieve")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = ("import json; from benchmark import harness\n"
              "cell = harness.find_cell('tiny.retrieve', harness.load_json('BENCHMARK.json'))\n"
              "print(json.dumps(harness.run_cell(cell, 5, 0.3, False, 'cpu')))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}")
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["metrics"]["claims_per_request"]["value"] == pytest.approx(32)
    assert set(out["metrics"]) == {"retrieval_qps", "request_p95_ms", "setup_s",
                                   "claims_per_request"}


FORBIDDEN = {"jax", "jaxlib", "flax", "ircl_tpu", "scripts", "bench", "bench_dense",
             "bench_pipeline", "bench_scale", "bench_serve", "bench_train", "bench_verdict",
             "__graft_entry__", "chip_smoke"}


def _imports(path=None, source=None):
    tree = ast.parse(source if source is not None else open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files():
    for base, _, names in os.walk(ROOT):
        if "/." in base or "__pycache__" in base:
            continue
        yield from (os.path.join(base, n) for n in names if n.endswith(".py"))


def test_no_file_imports_jax_the_jax_package_or_the_root_scripts():
    files = list(_files())
    assert len(files) > 30
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f
    # whole top-level names: the port's name begins with the JAX package's
    names = set(_imports(source="import ircl_tpu_torch.index\nfrom ircl_tpu.ops import x\n"))
    assert names & FORBIDDEN == {"ircl_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    for f in _files():
        if os.sep + "reference" + os.sep in f:
            assert "ircl_tpu_torch" not in set(_imports(f)), f


def test_run_without_a_card_exits_without_a_result():
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "fever50k.verify",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_run_without_the_program_exits_without_a_result(tmp_path):
    _copy(tmp_path)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "fever50k.retrieve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ircl_tpu_torch.x", types.ModuleType("ircl_tpu_torch.x"))
    assert not [m for m in harness.forbidden_modules() if m.startswith("ircl_tpu_torch")]
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax.numpy" in harness.forbidden_modules()


@pytest.mark.parametrize("kind", ["retrieve", "verify", "finetune"])
def test_each_traffic_kind_has_its_driver(kind):
    mod = harness.load_module(os.path.join(ROOT, "traffic", kind + ".py"), "t_" + kind)
    assert callable(mod.build)
