"""The port's scoreboard (``bossruns_torch.bench``) and tools, on the CPU.

* the port's ``build_inputs`` against the JAX ``bench.build_inputs`` on a
  ~200 kb genome and 300 reads: every layout array and every batch array
  equal element for element;
* the port's ``_aeons_strategy_numpy`` equal to the JAX bench's on the same
  contigs;
* each section at a small size on ``device="cpu"`` prints bench.py's
  metric names with at least bench.py's detail keys;
* ``main`` exits nonzero when a section raises (in the section's own
  process, and through ``main``'s subprocess), and a section overrunning
  its timeout is killed and reported;
* ``tools.check_decision_parity`` reports 0 disagreements a batch.
"""
import json
import os

import numpy as np
import pytest
import torch

import bench as jbench
from bossruns_torch import bench
from bossruns_torch.tools import check_decision_parity

torch.set_num_threads(2)

GENOME = {"chr1": 120_000, "chr2": 100_000}
N_READS = 300

#: bench.py's detail keys of each record (bench.py and scripts/bench_*.py)
DETAIL_KEYS = {
    "strategy_update_p50_latency": {"genome_sites", "reads_per_batch", "bases_per_batch",
                                    "reads_per_s", "cpu_baseline_ms", "f64_ms", "n_samples",
                                    "f32_ms"},
    "aligner_production_trunc_reads_per_s": {"seconds", "backend", "cpu_baseline_reads_per_s",
                                             "records"},
    "aligner_trunc_reads_per_s": {"seconds", "cpu_baseline_reads_per_s", "cpu_baseline_threads",
                                  "mapped_frac", "right_contig", "records",
                                  "production_backend"},
    "aligner_full_reads_per_s": {"seconds", "cpu_baseline_reads_per_s", "cpu_baseline_threads",
                                 "mapped_frac", "right_contig", "records", "production_backend"},
    "sim_batch_p50_latency": {"reads_per_batch", "reads_per_s", "floor_ms", "n_samples",
                              "phase_p50_ms"},
    "conformance_mask_agreement": {"per_batch", "exact_vs_drift_free_oracle", "n_contigs",
                                   "n_sites", "any_on", "residual_unexplained",
                                   "residual_precision", "residual_observed"},
    "conformance_dataplane": {"coverage_exact", "per_batch", "n_sites", "any_on",
                              "residual_unexplained", "residual_precision", "residual_observed"},
    "aeons_batch_p50_latency": {"reads_per_batch", "n_contigs", "shape_warmed", "stage_p50_ms",
                                "strategy_8mb_production_ms", "strategy_8mb_cpu_ms",
                                "strategy_8mb_device_ms", "strategy_40mb_production_ms",
                                "strategy_40mb_cpu_ms", "strategy_40mb_device_ms", "dispatch",
                                "e2e_baseline"},
    "strategy_update_p50_latency_scaled": {"genome_sites", "reads_per_batch"},
}


def _records(text: str) -> list[dict]:
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if "metric" in rec:
                out.append(rec)
    return out


def test_build_inputs_match_jax(monkeypatch):
    monkeypatch.setattr(jbench, "GENOME", GENOME)
    monkeypatch.setattr(jbench, "N_READS", N_READS)
    jl, jb = jbench.build_inputs(np.random.default_rng(11))
    tl, tb = bench.build_inputs(np.random.default_rng(11), GENOME, N_READS)
    arrays = [k for k, v in vars(jl).items() if isinstance(v, np.ndarray)]
    assert "seq_int" in arrays and "offsets" in arrays
    for k in arrays:
        np.testing.assert_array_equal(getattr(tl, k), getattr(jl, k), err_msg=k)
    for k in ("G_pad", "Gd_pad", "NBk_pad", "Wf_pad", "n_fhat"):
        assert getattr(tl, k) == getattr(jl, k), k
    assert sorted(tb) == sorted(jb)
    for k in jb:
        assert tb[k].dtype == jb[k].dtype, k
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_aeons_strategy_numpy_matches_jax():
    pool = bench.strategy_pool(6, np.random.default_rng(5), contig_len=30_000)
    ccl = bench.CCL
    for lam in (6000.0, 9000.0):
        want = jbench._aeons_strategy_numpy(pool, ccl, lam)
        got = bench._aeons_strategy_numpy(pool, ccl, lam)
        assert got == want and want > 0, (got, want)


SECTION_CALLS = {
    "headline": lambda tmp: [bench.section_headline("cpu", genome=GENOME, n_reads=N_READS,
                                                    n_steps=2, n_f32_steps=2, n_oracle=2)],
    "aligner": lambda tmp: bench.section_aligner("cpu", n_reads=150, trials=1,
                                                 lengths=tuple(GENOME.values())),
    "sim_batch": lambda tmp: [bench.section_sim("cpu", genome=GENOME, n_reads=200, n_warm=1,
                                                n_timed=2, cache=tmp)],
    "conformance": lambda tmp: bench.section_conformance(
        "cpu", n_batches=2, reads_per_batch=1500, dp_reads_per_batch=1200,
        lengths={"a": 300_000, "b": 200_000}, cache=tmp),
    "aeons_batch": lambda tmp: [bench.section_aeons("cpu", genome_len=100_000, n_reads=1200,
                                                    batchsize=200, n_timed=1, pools=(2, 3),
                                                    contig_len=20_000, cache=tmp)],
    "scale": lambda tmp: [bench.section_scale("cpu", size_mb=0.4)],
}
SECTION_METRICS = {
    "headline": ["strategy_update_p50_latency"],
    "aligner": ["aligner_production_trunc_reads_per_s", "aligner_trunc_reads_per_s",
                "aligner_full_reads_per_s"],
    "sim_batch": ["sim_batch_p50_latency"],
    "conformance": ["conformance_mask_agreement", "conformance_dataplane"],
    "aeons_batch": ["aeons_batch_p50_latency"],
    "scale": ["strategy_update_p50_latency_scaled"],
}


@pytest.mark.parametrize("section", list(SECTION_CALLS))
def test_section_emits_bench_records(section, tmp_path, capsys):
    returned = SECTION_CALLS[section](tmp_path)
    printed = _records(capsys.readouterr().out)
    assert [r["metric"] for r in printed] == SECTION_METRICS[section]
    assert [r["metric"] for r in returned] == SECTION_METRICS[section]
    for rec in returned:
        assert set(rec) == {"metric", "value", "unit", "vs_baseline", "detail"}
        assert DETAIL_KEYS[rec["metric"]] <= set(rec["detail"]), rec["metric"]
        assert rec["detail"]["device"] == "cpu"
        assert rec["value"] is not None and np.isfinite(rec["value"])
    if section == "headline":
        d = returned[0]["detail"]
        assert d["f32_ms"] is not None and printed[0]["detail"]["f32_ms"] is None
        assert len(d["cpu_baseline_samples_ms"]) == 2
        assert d["cpu_baseline_ms"] == min(d["cpu_baseline_samples_ms"])
    if section == "conformance":
        assert returned[0]["detail"]["exact_vs_drift_free_oracle"]
        assert returned[1]["detail"]["coverage_exact"]


def _fake_card(monkeypatch):
    """main() on the CPU: no card check, no kernel build, a small headline."""
    from pathlib import Path

    from bossruns_torch.ops import kernels

    monkeypatch.setattr(bench, "require_cuda", lambda: torch.device("cpu"))
    monkeypatch.setattr(kernels, "build", lambda: Path("libbosskernels_test.so"))
    monkeypatch.setattr(kernels, "load", lambda: None)
    headline = {"metric": "strategy_update_p50_latency", "value": 1.0, "unit": "ms",
                "vs_baseline": 2.0, "detail": {}}
    monkeypatch.setattr(bench, "section_headline", lambda device: bench.emit(dict(headline)))


@pytest.mark.parametrize("order,rc", [((), 0), (("scale",), 1)])
def test_main_exits_nonzero_when_a_section_fails(order, rc, monkeypatch, capsys):
    """With no section the scoreboard is the headline, first and last, and
    exits 0. The scale section's process finds no card here: it prints
    ``scale_error`` and exits 1, and so does ``main``."""
    _fake_card(monkeypatch)
    monkeypatch.setattr(bench, "ORDER", order)
    monkeypatch.delenv("BENCH_ONLY", raising=False)
    assert bench.main([]) == rc
    recs = _records(capsys.readouterr().out)
    assert recs[0]["metric"] == recs[-1]["metric"] == "strategy_update_p50_latency"
    assert recs[-2]["metric"] == "bench_summary"
    if order:
        err = next(r for r in recs if r["metric"] == "scale_error")
        assert "no CUDA device" in err["detail"]["error"]


def test_section_process_exits_nonzero_when_its_section_raises(monkeypatch, capsys):
    def boom(device):
        raise ValueError("boom")

    monkeypatch.setattr(bench, "require_cuda", lambda: torch.device("cpu"))
    monkeypatch.setitem(bench.SECTIONS, "boom", boom)
    assert bench.main(["--section", "boom"]) == 1
    (rec,) = _records(capsys.readouterr().out)
    assert rec["metric"] == "boom_error" and "boom" in rec["detail"]["error"]


def test_run_section_kills_an_overrunning_section(capsys):
    recs, rc = bench._run_section("scale", 0.2, dict(os.environ))
    assert rc is None and [r["metric"] for r in recs] == ["scale_timeout"]


def test_check_decision_parity_reports_zero_on_cpu(capsys):
    dis = check_decision_parity.main(n_batches=3, device="cpu", genome=GENOME, n_reads=N_READS)
    assert dis == [0, 0, 0]
    assert "TOTAL disagreements over 3 batches: 0" in capsys.readouterr().out
