"""The report, profiling and the CLI's report / scaling / experiment on the
CPU (counterpart of quantnet/report/analyzer.py, quantnet/bench/profiling.py
and quantnet/cli/main.py:639-704).

The analyzer's CSV, JSON and markdown must be byte for byte the JAX
package's on the same accuracy.json and benchmark.json: fixed inputs (with
and without the roofline fields, a missing batch size, no baseline), and
the files a tiny `experiment` run wrote. `trace` must write a Chrome trace
that holds the `annotate` names. Tolerance: none. The byte comparisons run
with both analyzers' plots off (they are not compared, and matplotlib's
rendering is most of their time); the experiment's own report draws them.
"""
import json

import pytest

from quantnet.report import analyzer as janalyzer
from quantnet_torch.cli.main import main
from quantnet_torch.report import analyzer as tanalyzer
from test_torch_cli import _dirs

FILES = ("quantization_comparison.csv", "quantization_comparison.json", "detailed_analysis_report.md")


def _bench(ms, tput, size, mfu=None, sizes=(1, 32)):
    out = {"model_size_mb": size}
    for bs in sizes:
        s = {"mean_ms": ms * bs / 10, "ms_per_image": ms / 10, "images_per_s": tput, "p50_ms": ms * 0.9,
             "p95_ms": ms * 1.3}
        if mfu is not None:
            s.update(model_gops=1.25, achieved_tops=tput / 1e3, peak_tops=1979.0, mfu=mfu)
        out[f"bs{bs}"] = s
    return out


CASES = {
    "plain": ({"fp32": {"top1": 0.8273, "top5": 0.99}, "static": {"top1": 0.8281, "top5": 0.985},
               "dynamic": {"top1": 0.8201}},
              {"fp32": _bench(2.1, 120000.5, 12.4), "static": _bench(0.7, 350123.25, 3.1),
               "dynamic": _bench(0.9, 250000.0, 3.1)}),
    "roofline": ({"fp32": {"top1": 0.5, "top5": 0.9}, "w4a8": {"top1": 0.45, "top5": 0.88}},
                 {"fp32": _bench(3.0, 1000.0, 10.0, mfu=0.0123),
                  "w4a8": _bench(1.0, 3000.0, 1.7, mfu=0.0456, sizes=(1, 1024))}),
    "no_baseline": ({"static": {"top1": 0.7}, "bf16": {"top1": 0.71}},
                    {"static": _bench(1.0, 10.0, 3.0), "bf16": {}}),
}


@pytest.fixture
def no_plots(monkeypatch):
    for mod in (janalyzer, tanalyzer):
        monkeypatch.setattr(mod, "_maybe_pyplot", lambda: None)


@pytest.mark.parametrize("case", sorted(CASES))
def test_analyzer_files_byte_equal_to_jax(tmp_path, case, no_plots):
    accuracy, benchmark = CASES[case]
    outs = {}
    for name, mod in (("jax", janalyzer), ("torch", tanalyzer)):
        d = tmp_path / name
        table = mod.ResultAnalyzer(str(d)).compare_quantization_methods(accuracy, benchmark)
        outs[name] = (table, mod.create_detailed_report(table, str(d), extra={"run": case}))
    assert outs["jax"] == outs["torch"]
    for f in FILES:
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_trace_holds_the_annotations(tmp_path):
    import torch

    from quantnet_torch.bench.profiling import annotate, maybe_trace, trace

    with trace(str(tmp_path / "t")):
        with annotate("eval:static"):
            torch.ones(64).sum()
    text = (tmp_path / "t" / "trace.json").read_text()
    assert "eval:static" in text and json.loads(text)["traceEvents"]
    with maybe_trace(None):
        pass
    assert not (tmp_path / "none").exists()


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    base = tmp_path_factory.mktemp("experiment")
    d = _dirs(base) + ["--synthetic-train-size", "128", "--synthetic-test-size", "64",
                       "--batch-size", "32", "--device", "cpu"]
    out = main(["experiment", "--epochs", "1", "--qat-epochs", "1", "--calibration-batches", "2",
                "--batch-sizes", "1,8", "--warmup", "1", "--iters", "2", "--eval-batch-size", "64", *d])
    return base, d, out


SCHEMES = ["fp32", "bf16", "dynamic", "static", "weight_only", "weight_only_int4", "w4a8", "optimized",
           "qat"]


def test_experiment_runs_every_stage(experiment):
    base, _, out = experiment
    assert list(out["accuracy"]) == SCHEMES and list(out["benchmark"]) == SCHEMES
    assert all(r["n"] == 64 for r in out["accuracy"].values())
    assert out["benchmark"]["static"]["bs8"]["device"] == "cpu"
    md = (base / "results" / "detailed_analysis_report.md").read_text()
    rows = [line for line in md.splitlines() if line.startswith("| ") and not line.startswith("| model")]
    assert [r.split(" | ")[0][2:] for r in rows] == SCHEMES
    csv_rows = (base / "results" / "quantization_comparison.csv").read_text().splitlines()[1:]
    assert [r.split(",")[0] for r in csv_rows] == SCHEMES
    assert (base / "saved" / "qat.json").exists() and (base / "saved" / "history.jsonl").exists()
    plots = tanalyzer._maybe_pyplot() is not None
    assert (base / "results" / "quantization_comparison.png").exists() == plots


def test_report_reproduces_the_experiments_files(experiment, tmp_path, no_plots):
    """A second report writes the same bytes, and so does the JAX analyzer on
    the experiment's accuracy.json and benchmark.json."""
    base, d, _ = experiment
    before = {f: (base / "results" / f).read_bytes() for f in FILES}
    main(["report", "--report-batch-size", "32", *d])
    assert {f: (base / "results" / f).read_bytes() for f in FILES} == before
    accuracy = json.loads((base / "results" / "accuracy.json").read_text())
    benchmark = json.loads((base / "results" / "benchmark.json").read_text())
    table = janalyzer.ResultAnalyzer(str(tmp_path)).compare_quantization_methods(accuracy, benchmark)
    janalyzer.create_detailed_report(table, str(tmp_path))
    assert {f: (tmp_path / f).read_bytes() for f in FILES} == before


def test_report_needs_both_files(tmp_path):
    with pytest.raises(SystemExit, match="accuracy.json and benchmark.json"):
        main(["report", *_dirs(tmp_path), "--device", "cpu"])


def test_scaling_writes_the_jax_keys(experiment):
    base, d, _ = experiment
    res = main(["scaling", "--per-device-batch", "4", "--iters", "2", *d])
    written = json.loads((base / "results" / "scaling.json").read_text())
    assert written["model"] == "static" and set(written) == {"model", "throughput", "efficiency"}
    assert list(written["throughput"]) == ["1"] and written["efficiency"] == {"1": 1.0}
    assert res["device"] == "cpu" and res["throughput"][1] > 0


def test_serve_data_parallel_over_the_local_devices(experiment):
    _, d, _ = experiment
    out = main(["serve", "--data-parallel", "-1", "--requests", "8", "--buckets", "8", *d])
    assert out["shards"] == 1 and out["stats"]["requests"] == 8
