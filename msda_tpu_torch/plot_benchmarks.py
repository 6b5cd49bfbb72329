"""Render the op benchmark's CSV as curve plots: the counterpart of
``scripts/plot_benchmarks.py``.

    python -m msda_tpu_torch.plot_benchmarks [CSV] [OUT_DIR]

Reads a CSV of ``python -m msda_tpu_torch.benchmark`` (default
``build/benchmark_ref_cuda.csv``) and writes one PNG per metric
(``fwd_ms``, ``fwdbwd_ms``, ``peak_mem_mb``) to ``OUT_DIR`` (default
``build/``).  A CSV of another sweep than the default one gets suffixed
file names (``benchmark_big_cuda.csv`` -> ``fwd_ms_big_cuda.png``).  The
series are the CUDA kernels in f32 and bf16 and the plain PyTorch version
in f32, in the JAX script's palette slots; msda-triton's published RTX 2060
times are marked on the reference pyramid only.  The titles name the card
and its power limit from the CSV's ``device`` and ``power_limit`` columns,
or say "device not recorded" when the CSV has none.

matplotlib is imported when a plot is drawn, not with this module: the
card's machine has none, so the plot is rendered wherever a CSV brought
back from the card lands.
"""

from __future__ import annotations

import csv
import os
import sys

__all__ = ["SERIES", "BASELINE", "METRICS", "DEFAULT_CSV", "title_device",
           "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CSV = os.path.join(_ROOT, "build", "benchmark_ref_cuda.csv")
DEFAULT_STEM = "benchmark_ref_cuda"

SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT_2 = "#52514e"
GRID = "#e6e5e0"
SERIES = {  # the JAX script's fixed slots, in its order
    ("cuda", "float32"): ("#2a78d6", "CUDA f32"),
    ("cuda", "bfloat16"): ("#eb6834", "CUDA bf16"),
    ("reference", "float32"): ("#1baf7a", "PyTorch reference f32"),
}
BASELINE = {  # msda-triton on an RTX 2060, 10k queries, f32
    "fwd_ms": 3.78,
    "fwdbwd_ms": 22.78,
    "peak_mem_mb": 166.14,
}
METRICS = [
    ("fwd_ms", "forward latency (ms)", "msda fwd runtime"),
    ("fwdbwd_ms", "forward+backward latency (ms)", "msda fwd+bwd runtime"),
    ("peak_mem_mb", "peak extra memory (MB)", "msda memory consumption"),
]


def title_device(rows: list[dict]) -> str:
    """The card (or cards) that measured ``rows``, with the power limit:
    "NVIDIA H100 80GB HBM3, 700.00 W"; "device not recorded" without the
    columns."""
    seen = []
    for r in rows:
        name = (r.get("device") or "").strip()
        if not name:
            continue
        power = (r.get("power_limit") or "").strip()
        label = f"{name}, {power}" if power else name
        if label not in seen:
            seen.append(label)
    return "; ".join(seen) if seen else "device not recorded"


def _points(rows, impl, dtype, key):
    pts = []
    for r in rows:
        if r["impl"] != impl or r["dtype"] != dtype:
            continue
        try:
            value = float(r[key])
        except (TypeError, ValueError):
            continue
        if value == value:  # not NaN
            pts.append((int(r["num_queries"]), value))
    return sorted(pts)


def main(csv_path: str = DEFAULT_CSV, out_dir: str | None = None) -> dict:
    """Write the PNGs; returns ``{metric: {"path", "title", "series",
    "baseline"}}`` (the series drawn, and whether the RTX 2060 mark is)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = os.path.join(_ROOT, "build") if out_dir is None else out_dir
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(csv_path))[0]
    suffix = ("" if stem == DEFAULT_STEM
              else "_" + stem.removeprefix("benchmark_"))
    # the published msda-triton times are for the reference pyramid only
    on_reference_pyramid = "big" not in stem.split("_")
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    device = title_device(rows)
    drawn = {}
    for key, ylabel, title in METRICS:
        fig, ax = plt.subplots(figsize=(6.4, 4.2), dpi=150)
        fig.patch.set_facecolor(SURFACE)
        ax.set_facecolor(SURFACE)
        series = []
        for (impl, dt), (color, label) in SERIES.items():
            pts = _points(rows, impl, dt, key)
            if not pts:
                continue
            series.append(label)
            xs, ys = zip(*pts)
            ax.plot(xs, ys, color=color, linewidth=2, marker="o",
                    markersize=6, label=label)
            ax.annotate(label, (xs[-1], ys[-1]), textcoords="offset points",
                        xytext=(6, 0), color=TEXT_2, fontsize=8, va="center")
        if on_reference_pyramid:
            base = BASELINE[key]
            ax.scatter([10000], [base], marker="x", s=70, color=TEXT_2,
                       zorder=5)
            ax.annotate(f"msda-triton / RTX 2060: {base:g}", (10000, base),
                        textcoords="offset points", xytext=(-8, -12),
                        color=TEXT_2, fontsize=8, ha="right")
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_xlabel("num_queries", color=TEXT_2)
        ax.set_ylabel(ylabel, color=TEXT_2)
        pyramid = f" ({suffix[1:]})" if suffix else ""
        full_title = f"{title}{pyramid} — {device}"
        ax.set_title(full_title, color=TEXT, fontsize=9)
        ax.grid(True, which="both", color=GRID, linewidth=0.6)
        ax.tick_params(colors=TEXT_2, labelsize=8)
        for spine in ax.spines.values():
            spine.set_color(GRID)
        if series:
            ax.legend(fontsize=8, framealpha=0, labelcolor=TEXT)
        ax.margins(x=0.12)
        fig.tight_layout()
        out = os.path.join(out_dir, f"{key}{suffix}.png")
        fig.savefig(out, facecolor=SURFACE)
        plt.close(fig)
        print("wrote", out)
        drawn[key] = {"path": out, "title": full_title, "series": series,
                      "baseline": on_reference_pyramid}
    return drawn


if __name__ == "__main__":
    main(*sys.argv[1:])
