"""Result analysis and reports (counterpart of quantnet/report/analyzer.py):
the comparison table of the schemes, its CSV, JSON and plots, and the
markdown report with the efficiency metric.

  - ResultAnalyzer.compare_quantization_methods merges accuracy.json and
    benchmark.json into the table and writes quantization_comparison.{csv,
    json,png};
  - create_detailed_report writes detailed_analysis_report.md (and
    accuracy_vs_performance.png, efficiency_metric.png), with the
    efficiency metric (batch_speedup x throughput_gain) /
    (1 + acc_loss / 100).

The CSV, JSON and markdown are byte for byte the JAX package's from the
same accuracy.json and benchmark.json. matplotlib is optional (the Agg
backend, imported when a plot is drawn): without it the plots are skipped
and everything else is written.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, Optional


def _maybe_pyplot():
    """matplotlib's pyplot on the Agg backend, or None where it is not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class ResultAnalyzer:
    """Collects per-model metrics and emits the comparison artifacts."""

    def __init__(self, output_dir: str = "./results"):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    def analyze_and_plot(
        self,
        results: Dict[str, Dict[str, float]],
        filename: str = "analysis.png",
    ) -> Dict[str, Dict[str, float]]:
        """1x3 summary grid (accuracy / size / inference time) — contract of
        the reference's ResultAnalyzer.analyze_and_plot
        (utils/result_analyzer.py:19-61). `results`: {model: {'accuracy',
        'model_size_mb', 'inference_time_ms'}}."""
        plt = _maybe_pyplot()
        if plt is not None and results:
            names = list(results)
            fig, axes = plt.subplots(1, 3, figsize=(15, 4.5))
            panels = [
                ("accuracy", "Accuracy (%)"),
                ("model_size_mb", "Model size (MB)"),
                ("inference_time_ms", "Inference time (ms)"),
            ]
            for ax, (key, title) in zip(axes, panels):
                ax.bar(names, [results[n].get(key, 0.0) for n in names])
                ax.set_title(title)
                ax.tick_params(axis="x", rotation=20)
            fig.tight_layout()
            fig.savefig(os.path.join(self.output_dir, filename), dpi=120)
            plt.close(fig)
        return results

    def compare_quantization_methods(
        self,
        accuracy: Dict[str, Dict[str, float]],
        benchmark: Dict[str, Dict[str, object]],
        *,
        batch_size: int = 32,
        baseline: str = "fp32",
    ) -> Dict[str, Dict[str, float]]:
        """Merge accuracy + benchmark results into the comparison table and
        write quantization_comparison.{csv,png,json}.

        accuracy: {model: {'top1','top5',...}}; benchmark: {model: {'model_size_mb',
        f"bs{batch_size}": {...}}} (from bench/benchmark.py).
        """
        table: Dict[str, Dict[str, float]] = {}
        for name in accuracy:
            bench = benchmark.get(name, {})
            bs_stats = bench.get(f"bs{batch_size}", {})
            if not bs_stats:
                # Fall back to the largest benchmarked batch size.
                sizes = sorted(
                    int(k[2:]) for k in bench if k.startswith("bs") and k[2:].isdigit()
                )
                if sizes:
                    bs_stats = bench[f"bs{sizes[-1]}"]
            bs1_stats = bench.get("bs1", {})
            table[name] = {
                "top1": accuracy[name]["top1"] * 100,
                "top5": accuracy[name].get("top5", 0.0) * 100,
                "model_size_mb": bench.get("model_size_mb", 0.0),
                "latency_single_ms": bs1_stats.get("mean_ms", 0.0),
                "latency_batch_ms_per_image": bs_stats.get("ms_per_image", 0.0),
                "throughput_img_s": bs_stats.get("images_per_s", 0.0),
                "p50_ms": bs_stats.get("p50_ms", 0.0),
                "p95_ms": bs_stats.get("p95_ms", 0.0),
            }
            # Roofline fields (emitted by the bench harness when the backend
            # reports FLOPs + a known chip peak): achieved TOP/s and MFU.
            for key in ("model_gops", "achieved_tops", "peak_tops", "mfu"):
                if key in bs_stats:
                    table[name][key] = bs_stats[key]
        if baseline in table:
            base = table[baseline]
            for name, row in table.items():
                row["accuracy_delta_pt"] = row["top1"] - base["top1"]
                if row["latency_batch_ms_per_image"] > 0 and base["latency_batch_ms_per_image"] > 0:
                    row["batch_speedup"] = (
                        base["latency_batch_ms_per_image"] / row["latency_batch_ms_per_image"]
                    )
                if row["model_size_mb"] > 0 and base["model_size_mb"] > 0:
                    row["compression_ratio"] = base["model_size_mb"] / row["model_size_mb"]

        self._write_csv(table, "quantization_comparison.csv")
        with open(os.path.join(self.output_dir, "quantization_comparison.json"), "w") as f:
            json.dump(table, f, indent=2)
        self._plot_comparison(table, "quantization_comparison.png")
        return table

    def _write_csv(self, table: Dict[str, Dict[str, float]], filename: str):
        path = os.path.join(self.output_dir, filename)
        cols = sorted({k for row in table.values() for k in row})
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["model"] + cols)
            for name, row in table.items():
                writer.writerow([name] + [row.get(c, "") for c in cols])

    def _plot_comparison(self, table, filename: str):
        plt = _maybe_pyplot()
        if plt is None or not table:
            return
        names = list(table)
        fig, axes = plt.subplots(2, 2, figsize=(12, 9))
        panels = [
            ("top1", "Top-1 accuracy (%)"),
            ("model_size_mb", "Model size (MB)"),
            ("latency_batch_ms_per_image", "Batch latency (ms/image)"),
            ("throughput_img_s", "Throughput (images/s)"),
        ]
        for ax, (key, title) in zip(axes.flat, panels):
            vals = [table[n].get(key, 0.0) for n in names]
            ax.bar(names, vals)
            ax.set_title(title)
            ax.tick_params(axis="x", rotation=20)
        fig.tight_layout()
        fig.savefig(os.path.join(self.output_dir, filename), dpi=120)
        plt.close(fig)


def create_detailed_report(
    table: Dict[str, Dict[str, float]],
    output_dir: str = "./results",
    *,
    baseline: str = "fp32",
    extra: Optional[Dict[str, object]] = None,
) -> str:
    """Markdown report + two plots (contract of analyze_results.py:90-196)."""
    os.makedirs(output_dir, exist_ok=True)
    plt = _maybe_pyplot()

    # efficiency metric per reference analyze_results.py:84-88
    eff = {}
    base = table.get(baseline, {})
    for name, row in table.items():
        if name == baseline:
            continue
        acc_loss = max(base.get("top1", 0.0) - row.get("top1", 0.0), 0.0)
        speedup = row.get("batch_speedup", 1.0)
        tp_gain = (
            row.get("throughput_img_s", 1.0) / base.get("throughput_img_s", 1.0)
            if base.get("throughput_img_s")
            else 1.0
        )
        eff[name] = (speedup * tp_gain) / (1.0 + acc_loss / 100.0)

    if plt is not None and table:
        names = [n for n in table if n != baseline]
        fig, ax = plt.subplots(figsize=(8, 6))
        ax.scatter(
            [table[n].get("throughput_img_s", 0) for n in table],
            [table[n].get("top1", 0) for n in table],
        )
        for n in table:
            ax.annotate(
                n,
                (table[n].get("throughput_img_s", 0), table[n].get("top1", 0)),
            )
        ax.set_xlabel("Throughput (images/s)")
        ax.set_ylabel("Top-1 accuracy (%)")
        ax.set_title("Accuracy vs performance")
        fig.tight_layout()
        fig.savefig(os.path.join(output_dir, "accuracy_vs_performance.png"), dpi=120)
        plt.close(fig)

        if eff:
            fig, ax = plt.subplots(figsize=(8, 6))
            ax.bar(list(eff), list(eff.values()))
            ax.set_title("Efficiency metric (speedup x throughput gain) / (1 + acc loss)")
            fig.tight_layout()
            fig.savefig(os.path.join(output_dir, "efficiency_metric.png"), dpi=120)
            plt.close(fig)

    has_mfu = any("achieved_tops" in row for row in table.values())
    lines = ["# Quantization analysis report", ""]
    header = "| model | top-1 % | Δ vs fp32 (pt) | size (MB) | ms/img (batch) | img/s | p50 ms | speedup |"
    rule = "|---|---|---|---|---|---|---|---|"
    if has_mfu:
        header += " TOP/s | MFU |"
        rule += "---|---|"
    lines.append(header)
    lines.append(rule)
    for name, row in table.items():
        line = (
            f"| {name} | {row.get('top1', 0):.2f} | {row.get('accuracy_delta_pt', 0):+.2f} "
            f"| {row.get('model_size_mb', 0):.2f} | {row.get('latency_batch_ms_per_image', 0):.4f} "
            f"| {row.get('throughput_img_s', 0):.1f} | {row.get('p50_ms', 0):.3f} "
            f"| {row.get('batch_speedup', 1.0):.2f}x |"
        )
        if has_mfu:
            tops = row.get("achieved_tops")
            mfu = row.get("mfu")
            line += (
                f" {tops:.1f} |" if tops is not None else " — |"
            ) + (f" {mfu * 100:.1f}% |" if mfu is not None else " — |")
        lines.append(line)
    if eff:
        lines += ["", "## Efficiency metric", ""]
        for n, v in eff.items():
            lines.append(f"- {n}: {v:.3f}")
    if extra:
        lines += ["", "## Run metadata", "", "```json", json.dumps(extra, indent=2), "```"]
    report = "\n".join(lines) + "\n"
    with open(os.path.join(output_dir, "detailed_analysis_report.md"), "w") as f:
        f.write(report)
    return report
