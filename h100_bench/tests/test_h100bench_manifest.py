"""``BENCHMARK.json`` and the files it names: the manifest's form, the metrics each cell
reports, the files each cell needs, what the harness may import, that a new configuration,
cell and metric are found as new files alone, and how the card's tests are marked."""

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from h100_bench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_form():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["h100_bench"] and b["command"] == ["python3", "-m", "h100_bench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("h100_bench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split(".")[0].split("_"):
            assert m["unit"] == "%"
    names = [x["name"] for k in ("configs", "workloads") for x in b[k]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names) and len(set(metrics)) == len(metrics)
    assert "setup_s" in metrics
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    b = manifest()
    cells = [w["name"] for w in b["workloads"]]
    for m in b["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in [e["name"] for e in harness.end_to_end_metrics(b, cell)], (m["name"], cell)
    for cell in cells:
        e2e = [e["name"] for e in harness.end_to_end_metrics(b, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.per_layer_metrics(b, cell)


def test_each_cell_has_its_files():
    b = manifest()
    for w in b["workloads"]:
        _, _, cell = harness.load_cell(w["name"], 1, "cpu")
        assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        assert cell.weights.is_file()
        assert cell.checks["limits"]
        for m in harness.per_layer_metrics(b, w["name"]):
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    sources = sorted(BENCH.rglob("*.py"))
    assert len(sources) > 20
    for path in sources:
        for name in imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)
    for path in sorted((BENCH / "reference").rglob("*.py")):
        for name in imports(path):
            assert name.split(".")[0] != "piv_liteflownet_tpu_torch", (path, name)


def test_a_new_config_cell_and_metric_are_found_as_new_files(tmp_path, few_threads):
    """A configuration, a traffic mix, a cell and a per-layer metric added as files to a copy
    of the benchmark run through the harness with no other file edited (only the manifest
    gains their entries)."""
    from conftest import RUN_SMALL

    shutil.copytree(BENCH, tmp_path / "h100_bench", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "work" / "synth_run").mkdir(parents=True)
    shutil.copy(ROOT / "work" / "synth_run" / "params_final.npz", tmp_path / "work" / "synth_run")
    b = manifest()
    conf = json.loads((BENCH / "configs" / "piv-lfn-en-v1-f32.json").read_text())
    conf["conv_impl"] = "chain"
    (tmp_path / "h100_bench" / "configs" / "piv-lfn-en-v1-f32-chain.json").write_text(json.dumps(conf))
    tr = json.loads((BENCH / "traffic" / "campaign-1024-b8.json").read_text())
    tr["batch"] = 2
    (tmp_path / "h100_bench" / "traffic" / "campaign-1024-b2.json").write_text(json.dumps(tr))
    (tmp_path / "h100_bench" / "workloads" / "lfn1-f32chain-run-1024-b2.json").write_text(
        (BENCH / "workloads" / "lfn2-bf16-run-1024-b8.json").read_text())
    (tmp_path / "h100_bench" / "metrics" / "pairs_seen.run.py").write_text(
        "def read(run):\n    return run.stats['items']\n")
    b["configs"].append({"name": "piv-lfn-en-v1-f32-chain", "source": "test", "reduced": [], "why": "test",
                         "file": "h100_bench/configs/piv-lfn-en-v1-f32-chain.json"})
    b["workloads"].append({"name": "lfn1-f32chain-run-1024-b2", "config": "piv-lfn-en-v1-f32-chain",
                           "traffic": "campaign-1024-b2", "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] in ("pairs_per_s", "batch_p90_ms"):
            m["workloads"].append("lfn1-f32chain-run-1024-b2")
    b["per_layer"].append({"name": "pairs_seen.run", "unit": "pairs", "better": "higher", "source": "host_clock",
                           "layer": "entry point", "moves": "pairs_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    over = json.loads(json.dumps(RUN_SMALL))
    over["traffic"]["batch"] = 2
    for trace in (False, True):
        out = harness.run_cell("lfn1-f32chain-run-1024-b2", 3, 0.5, trace, device="cpu", root=tmp_path,
                               overrides=over)
        assert out["correct"], out["checks"]
        if trace:
            assert out["metrics"]["pairs_seen.run"]["value"] == out["attempted"]
        else:
            assert set(out["metrics"]) == {"pairs_per_s", "batch_p90_ms", "setup_s"}


def test_card_tests_are_marked_and_decide_inside_the_test():
    for path in sorted((BENCH / "tests").glob("test_*.py")):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
                marks = [ast.unparse(d) for d in node.decorator_list]
                assert not any("is_available" in m for m in marks), (path, node.name)
                uses_card = "cuda_device" in [a.arg for a in node.args.args]
                assert uses_card == any(m == "pytest.mark.gpu" for m in marks), (path, node.name)
            elif not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                assert "is_available" not in ast.unparse(node), (path, ast.unparse(node)[:80])


@pytest.mark.parametrize("workload", [w["name"] for w in manifest()["workloads"]])
def test_a_run_without_the_card_prints_no_result(workload, capsys):
    from h100_bench import __main__ as entry

    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert entry.main(["--workload", workload, "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
