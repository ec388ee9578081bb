"""Port host modules: byte-identical to the JAX package's, and JAX-free.

* parse_paf, split_runs, split_runs_rows and pack_batch of the port give
  the same arrays as the bossruns_tpu functions on the corpus;
* a subprocess in which neither ``jax`` nor ``bossruns_tpu`` can be
  imported imports the whole port and runs two simulation batches on the
  CPU;
* ``python -m bossruns_torch --toml ... --device cpu`` runs a simulation
  with live alignment in such a subprocess (the AEONS simulation's twin is
  in test_torch_aeons_sim.py); a mesh TOML runs the sharded simulation and
  the AEONS modes ignore ``[tpu]``;
* the scoreboard's headline (``bossruns_torch.bench``) and
  ``tools.check_decision_parity`` run in such a subprocess;
* no source file of the port, nor chip_smoke.py, imports jax or
  bossruns_tpu;
* the kernel build raises a clear error without nvcc instead of falling
  back, and a wrapper given a tensor on neither the CPU nor CUDA raises.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from bossruns_tpu.io import coo_native as jcoo
from bossruns_tpu.io import paf as jpaf
from bossruns_tpu.models.layout import build_layout
from bossruns_tpu.models.runs_sim import load_reference_contigs
from bossruns_torch.io import coo_native as tcoo
from bossruns_torch.io import paf as tpaf
from bossruns_torch.ops import genome_ops as tg
from bossruns_torch.ops import kernels

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PAF_FIELDS = ("qlen", "qstart", "qend", "rev", "tlen", "tstart", "tend", "nmatch",
              "blocklen", "mapq", "align_score", "s1", "primary")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module")
def parsed(corpus):
    out = {}
    for key in ("paf_full", "paf_trunc"):
        text = Path(corpus[key]).read_text()
        out[key] = (jpaf.parse_paf(text), tpaf.parse_paf(text))
    return out


def test_parse_paf_identical(parsed):
    for key, (j, t) in parsed.items():
        assert len(j) == len(t) > 0
        for f in PAF_FIELDS:
            _same(getattr(t, f), getattr(j, f), f"{key}.{f}")
        assert list(t.qname) == list(j.qname) and list(t.tname) == list(j.tname)
        for cj, ct in zip(j.cigars, t.cigars):
            _same(ct, cj, f"{key} cigar")


def _reads(corpus):
    from bossruns_tpu.io.fastq import read_fastx

    seqs, quals = {}, {}
    for name, _c, seq, qual in read_fastx(corpus["fq"]):
        seqs[name], quals[name] = seq, qual
    return seqs, quals


def test_split_runs_and_pack_batch_identical(corpus, parsed):
    lay = build_layout(load_reference_contigs(corpus["ref"]))
    seqs, quals = _reads(corpus)
    full = parsed["paf_full"][0]
    best = list(jpaf.best_per_query(full).values())[:300]
    sets = [(full, best, seqs, quals)]
    pj = jcoo.build_packed_runs(lay, sets)
    pt = tcoo.build_packed_runs(lay, sets)
    for a, b in zip(pt, pj):
        _same(a, b, "packed runs")
    for len_b in (5, 4):
        for a, b in zip(tcoo.split_runs(lay, *pt, 0, len_b), jcoo.split_runs(lay, *pj, 0, len_b)):
            _same(a, b, f"split_runs len_b={len_b}")
    rrow = np.arange(pt[2].shape[0], dtype=np.int32)
    for a, b in zip(tcoo.split_runs_rows(lay, *pt, rrow), jcoo.split_runs_rows(lay, *pj, rrow)):
        _same(a, b, "split_runs_rows")
    rs = (np.arange(512, dtype=np.int32) % 7, np.zeros(512, np.int32), np.ones(512, np.float32))
    bj = jcoo.pack_batch(lay, sets, rs=rs, floors=(5000, 100))
    bt = tcoo.pack_batch(lay, sets, device="cpu", rs=rs, floors=(5000, 100))
    for f in bj._fields:
        _same(getattr(bt, f).numpy(), getattr(bj, f), f"pack_batch.{f}")


JAX_BLOCKED = textwrap.dedent("""
    import sys

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "bossruns_tpu"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, _NoJax())
    sys.path.insert(0, sys.argv[1])
    import importlib
    import pkgutil

    import bossruns_torch
    import torch

    torch.set_num_threads(2)
    for m in pkgutil.walk_packages(bossruns_torch.__path__, "bossruns_torch."):
        importlib.import_module(m.name)
    from bossruns_torch.models.runs_sim import BossRunsSim

    sim = BossRunsSim(ref=sys.argv[2], fq=sys.argv[3], paf_full=sys.argv[4],
                      paf_trunc=sys.argv[5], name="nojax", batchsize=100, maxb=2,
                      out_base=sys.argv[6], device="cpu")
    sim.run(2)
    assert sim.batch == 2 and int(sim.state.coverage.to(torch.int32).sum()) > 0
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "bossruns_tpu")]
    assert not loaded, loaded
    print("NOJAX_OK")
""")


def test_port_runs_with_jax_unimportable(corpus, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", JAX_BLOCKED, str(REPO), corpus["ref"], corpus["fq"],
         corpus["paf_full"], corpus["paf_trunc"], str(tmp_path)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "NOJAX_OK" in proc.stdout, proc.stderr[-3000:]


CLI_JAX_BLOCKED = textwrap.dedent("""
    import runpy
    import sys

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "bossruns_tpu"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, _NoJax())
    sys.path.insert(0, sys.argv[1])
    import torch

    torch.set_num_threads(2)
    sys.argv = ["bossruns_torch", "--toml", sys.argv[2], "--device", "cpu"]
    try:
        runpy.run_module("bossruns_torch", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "bossruns_tpu")]
    assert not loaded, loaded
    print("CLI_OK")
""")


def _toml(path, name, ref=None, **sections):
    text = f'[general]\nname = "{name}"\n' + (f'ref = "{ref}"\n' if ref else "")
    for sec, kv in sections.items():
        text += f"[{sec}]\n" + "".join(f"{k} = {json.dumps(v)}\n" for k, v in kv.items())
    path.write_text(text)
    return path


def test_cli_runs_live_alignment_sim_without_jax(corpus, tmp_path):
    toml = _toml(tmp_path / "sim.toml", "clisim", ref=corpus["ref"],
                 simulation=dict(fq=corpus["fq"], batchsize=100, maxb=2))
    proc = subprocess.run([sys.executable, "-c", CLI_JAX_BLOCKED, str(REPO), str(toml)],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0 and "CLI_OK" in proc.stdout, proc.stderr[-3000:]
    assert (tmp_path / "out_clisim" / "masks" / "boss.npz").exists()
    assert (tmp_path / "out_clisim" / "metrics" / "batches.jsonl").read_text().count("\n") == 2


def test_cli_refuses_aeons_and_mesh(corpus, tmp_path, monkeypatch):
    """Nothing is refused any more: a RUNS TOML with a device mesh runs the
    sharded simulation on the CPU, and an AEONS TOML with one ignores
    ``[tpu]``, as the JAX package's CLI does."""
    from bossruns_torch.__main__ import main
    from bossruns_torch.models import runs_sim
    from bossruns_torch.parallel.mesh import ShardedRunsEngine

    monkeypatch.chdir(tmp_path)
    made = []
    monkeypatch.setattr(runs_sim.BossRunsSim, "cleanup",
                        lambda self, _f=runs_sim.BossRunsSim.cleanup: (made.append(self), _f(self)))
    mesh = _toml(tmp_path / "mesh.toml", "m", ref=corpus["ref"],
                 simulation=dict(fq=corpus["fq"], paf_full=corpus["paf_full"],
                                 paf_trunc=corpus["paf_trunc"], batchsize=100, maxb=2),
                 tpu=dict(mesh_genome=2))
    assert main(["--toml", str(mesh), "--device", "cpu"]) == 0
    (sim,) = made
    assert isinstance(sim.engine, ShardedRunsEngine) and sim.engine.mesh.shape == {"b": 1, "g": 2}
    assert sim.batch == 2 and (tmp_path / "out_m" / "masks" / "boss.npz").exists()
    aeons = _toml(tmp_path / "aeons.toml", "a",
                  simulation=dict(fq=corpus["fq"], batchsize=150, maxb=1, binit=2),
                  tpu=dict(mesh_barcode=2))
    assert main(["--toml", str(aeons), "--device", "cpu"]) == 0
    assert (tmp_path / "out_a" / "masks" / "boss.npz").exists()


BENCH_JAX_BLOCKED = textwrap.dedent("""
    import sys

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "bossruns_tpu"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, _NoJax())
    sys.path.insert(0, sys.argv[1])
    import torch

    from bossruns_torch import bench
    from bossruns_torch.tools import check_decision_parity

    torch.set_num_threads(2)
    genome = {"chr1": 120_000, "chr2": 100_000}
    rec = bench.section_headline("cpu", genome=genome, n_reads=200, n_steps=1, n_f32_steps=1,
                                 n_oracle=1)
    assert rec["detail"]["f32_ms"] is not None
    assert check_decision_parity.main(n_batches=1, device="cpu", genome=genome,
                                      n_reads=200) == [0]
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "bossruns_tpu")]
    assert not loaded, loaded
    print("BENCH_OK")
""")


def test_bench_and_a_tool_run_without_jax(tmp_path):
    """The scoreboard's headline and tools.check_decision_parity run in a
    process where jax and bossruns_tpu cannot be imported."""
    proc = subprocess.run([sys.executable, "-c", BENCH_JAX_BLOCKED, str(REPO)],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0 and "BENCH_OK" in proc.stdout, proc.stderr[-3000:]


def test_port_source_has_no_jax_import():
    """No import statement of jax or of the JAX package in the port's
    sources or in chip_smoke.py (the port keeps copies of the host code)."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|bossruns_tpu)\b", re.M)
    files = list((REPO / "bossruns_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [str(p) for p in files if pat.search(p.read_text())]
    assert not bad, bad


def test_chip_smoke_imports_only_the_port():
    """The on-card smoke reaches shared host helpers through bossruns_torch,
    never through the JAX package by name."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "bossruns_tpu")]
    assert not bad, bad
    assert "bossruns_torch.models.runs_sim" in mods


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "NVCC_FALLBACK", ())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_wrappers_raise_off_cpu_without_cuda():
    """A tensor that is not on the CPU takes the kernel path or raises —
    never the plain version."""
    cov = torch.zeros((1, 5, 100), dtype=torch.uint16, device="meta")
    seq = torch.zeros(100, dtype=torch.int8, device="meta")
    z8 = torch.zeros(1, dtype=torch.uint8, device="meta")
    rows = tg.CovRows(z8, z8.to(torch.uint32), z8.to(torch.uint16), z8.to(torch.uint16),
                      z8.to(torch.uint32))
    with pytest.raises(ValueError, match="CUDA"):
        tg.coverage_update(cov, seq, rows)


def test_kernel_sources_carry_their_notes():
    for name in ("coverage.cu", "scores.cu", "rows.cu", "strategy.cu", "seed.cu",
                 "aeons_strategy.cu"):
        head = (REPO / "bossruns_torch" / "csrc" / name).read_text()[:3000]
        assert "Replaces:" in head and "Bound on the H100" in head and "Design" in head, name


def test_chip_smoke_bounds_count_what_the_inputs_need(monkeypatch):
    """The smoke's bounds, on small CPU inputs: H2 counts the arithmetic of
    the sites that need the contraction only (a nonzero count among the
    model's symbols, unfrozen, valid; LG + LB + 2 special functions and
    2 LB LG + LG + LB FMAs each), which stays below the byte bound on dense
    diploid coverage and binds where the byte rate is higher; the coverage
    bound counts the coverage entries a step changed, read and written
    once."""
    import chip_smoke as cs
    from bossruns_torch.ops import scores as ts
    from bossruns_torch.ops.model import make_model

    rng = np.random.default_rng(2)
    G = 4000
    seq = torch.from_numpy(rng.integers(0, 4, G).astype(np.int8))
    valid = torch.ones(G, dtype=torch.bool)
    valid[:100] = False
    dense = cs.dense_coverage(seq, 1)
    covsum = dense.view(torch.int16).sum(dim=1)
    assert int(covsum.min()) >= 1 and int(covsum.max()) <= 29
    args = dict(coverage=dense, seq=seq, site_valid=valid, freeze_cov=30, tiny=1e-38,
                tables=ts.ScoreTables(make_model(ploidy=2), device="cpu"))
    out = ts.site_scores(**args)
    b = cs.score_bound(args, *out)
    n = G - 100
    sfu = (15 + 5 + 2) * n / (cs.N_SMS * cs.SFU_PER_SM_CLOCK * cs.SM_CLOCK_MHZ * 1e3)
    fma = 2 * (2 * 5 * 15 + 15 + 5) * n / cs.F32_FLOP_PER_MS
    assert b["n_contract"] == n and b["sfu_ms"] == pytest.approx(sfu, rel=1e-12)
    assert b["fma_ms"] == pytest.approx(fma, rel=1e-12)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["byte_ms"] > b["sfu_ms"] > b["fma_ms"]
    assert b["byte_ms"] == b["bytes"] / cs.HBM_BYTES_PER_MS
    monkeypatch.setattr(cs, "HBM_BYTES_PER_MS", cs.HBM_BYTES_PER_MS * 2)
    b = cs.score_bound(args, *out)
    assert b["bound_by"] == "operations" and b["bound_ms"] == b["sfu_ms"] > b["byte_ms"]
    monkeypatch.undo()
    sparse = torch.zeros_like(dense)
    sparse.view(torch.int16)[0, 4, 300:400] = 2           # the fifth (deletion) plane only
    sparse.view(torch.int16)[0, 0, 500:560] = 3
    sparse.view(torch.int16)[0, 1, 550:600] = 40          # frozen from 550 on
    for deletion_error, n in ((0.03, 150), (0.0, 50)):    # LB 5 counts deletions, LB 4 not
        a = dict(args, coverage=sparse, tables=ts.ScoreTables(
            make_model(ploidy=2, deletion_error=deletion_error), device="cpu"))
        b = cs.score_bound(a, *ts.site_scores(**a))
        assert b["n_contract"] == n and b["bound_by"] == "bytes", deletion_error
    after = sparse.clone()
    after.view(torch.int16)[0, 2, 10:17] += 1
    z = torch.zeros(3, dtype=torch.uint8)
    rows = tg.CovRows(z, z.to(torch.int32).view(torch.uint32), z.to(torch.int16).view(torch.uint16),
                      z.to(torch.int16).view(torch.uint16), z.to(torch.int32).view(torch.uint32))
    c = cs.coverage_bound(rows, seq, torch.zeros(G, dtype=torch.bool), sparse, after)
    assert c["entries_changed"] == 7 and c["bytes"] == 3 * 13 + G + G + 4 * 7
