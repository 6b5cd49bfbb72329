"""The port's benchmark plots (``python -m msda_tpu_torch.plot_benchmarks``),
mirroring ``tests/test_plot_benchmarks.py``: every metric renders from the
default sweep's CSV with a gap and an empty cell, another sweep's CSV gets
suffixed PNGs and no RTX 2060 mark on the big pyramid, and the titles name
the card and its power limit when the CSV carries them, "device not
recorded" when it does not, and never a TPU.
"""

import csv

import pytest

from msda_tpu_torch import benchmark, plot_benchmarks

pytest.importorskip("matplotlib")

CARD = {"device": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
_ROWS = [
    # one series with a gap (no bf16 fwd+bwd at N=100) and an empty cell
    {"impl": "cuda", "dtype": "float32", "num_queries": "100",
     "fwd_ms": "0.05", "fwdbwd_ms": "0.2", "peak_mem_mb": "30.0"},
    {"impl": "cuda", "dtype": "float32", "num_queries": "10000",
     "fwd_ms": "0.3", "fwdbwd_ms": "1.2", "peak_mem_mb": "124.7"},
    {"impl": "cuda", "dtype": "bfloat16", "num_queries": "100",
     "fwd_ms": "0.04", "fwdbwd_ms": "", "peak_mem_mb": "nan"},
    {"impl": "reference", "dtype": "float32", "num_queries": "10000",
     "fwd_ms": "10.3", "fwdbwd_ms": "28.2", "peak_mem_mb": "2000.0"},
]


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def test_default_sweep_renders_all_metrics(tmp_path):
    csv_path = tmp_path / "benchmark_ref_cuda.csv"
    _write_csv(csv_path, [dict(r, **CARD) for r in _ROWS])
    drawn = plot_benchmarks.main(str(csv_path), str(tmp_path))
    for key, _, _ in plot_benchmarks.METRICS:
        out = tmp_path / f"{key}.png"
        assert out.exists() and out.stat().st_size > 10_000, out
        assert drawn[key]["baseline"]
    assert drawn["fwd_ms"]["series"] == [
        "CUDA f32", "CUDA bf16", "PyTorch reference f32"]
    # the gap and the empty cells drop out of a series, not the series
    assert drawn["fwdbwd_ms"]["series"] == ["CUDA f32",
                                            "PyTorch reference f32"]
    assert drawn["peak_mem_mb"]["series"] == ["CUDA f32",
                                              "PyTorch reference f32"]


def test_nondefault_sweep_gets_suffixed_pngs(tmp_path):
    csv_path = tmp_path / "benchmark_big_cuda.csv"
    _write_csv(csv_path, [dict(r, **CARD) for r in _ROWS])
    drawn = plot_benchmarks.main(str(csv_path), str(tmp_path))
    # suffixed names, so that a big-pyramid render never clobbers the
    # reference pyramid's plots; msda-triton published no big-pyramid time
    assert (tmp_path / "fwd_ms_big_cuda.png").exists()
    assert not (tmp_path / "fwd_ms.png").exists()
    assert not any(d["baseline"] for d in drawn.values())
    assert "(big_cuda)" in drawn["fwd_ms"]["title"]


@pytest.mark.parametrize("with_device", [True, False],
                         ids=["device_columns", "jax_columns_only"])
def test_titles_name_the_card_or_say_not_recorded(tmp_path, with_device):
    rows = [dict(r, **CARD) for r in _ROWS] if with_device else _ROWS
    csv_path = tmp_path / "benchmark_ref_cuda.csv"
    _write_csv(csv_path, rows)
    drawn = plot_benchmarks.main(str(csv_path), str(tmp_path))
    for d in drawn.values():
        want = ("NVIDIA H100 80GB HBM3, 700.00 W" if with_device
                else "device not recorded")
        assert d["title"].endswith(want)
        assert "TPU" not in d["title"]


def test_a_cpu_sweep_renders_from_the_benchmark_cli(tmp_path):
    """A CSV as ``python -m msda_tpu_torch.benchmark --device cpu`` writes
    it: the reference series only, the device "cpu", no power limit."""
    csv_path = tmp_path / "benchmark_ref_cpu.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=benchmark.FIELDS)
        w.writeheader()
        w.writerow({"impl": "reference", "dtype": "float32",
                    "num_queries": 10, "fwd_ms": 1.5, "fwdbwd_ms": 4.0,
                    "peak_mem_mb": float("nan"), "device": "cpu",
                    "power_limit": ""})
    drawn = plot_benchmarks.main(str(csv_path), str(tmp_path))
    assert drawn["fwd_ms"]["series"] == ["PyTorch reference f32"]
    assert drawn["peak_mem_mb"]["series"] == []
    assert drawn["fwd_ms"]["title"].endswith("— cpu")
    assert (tmp_path / "fwd_ms_ref_cpu.png").exists()


def test_title_device_joins_cards_in_order():
    rows = [dict(_ROWS[0], **CARD),
            dict(_ROWS[1], device="NVIDIA H100 PCIe", power_limit=""),
            dict(_ROWS[2], **CARD)]
    assert plot_benchmarks.title_device(rows) == (
        "NVIDIA H100 80GB HBM3, 700.00 W; NVIDIA H100 PCIe")
