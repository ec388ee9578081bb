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
import os
import subprocess
import sys
import textwrap
import threading
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


# ------------------------------------------------------ coverage rows ---

MU = 400


def _with_records(rec, extra):
    """``rec``'s records, then ``extra``'s (a PafRecords of both)."""
    cols = {f: np.concatenate([getattr(rec, f), getattr(extra, f)])
            for f in PAF_FIELDS + ("qname", "tname")}
    return tpaf.PafRecords(**cols, cigars=list(rec.cigars) + list(extra.cigars))


@pytest.fixture(scope="module")
def rows_case(corpus, parsed):
    """The corpus's first 150 best full and truncated records, and three
    more: an error-free forward read of 70,000 bases (a match run beyond
    65,535), a reverse read with a deletion and an insertion and no
    quality string, and a read on a contig the layout does not have."""
    lay = build_layout(load_reference_contigs(corpus["ref"]))
    seqs, quals = _reads(corpus)
    rng = np.random.default_rng(2024)
    ref = lambda g0, n: "".join("ACGT"[c] for c in lay.seq_int[g0 : g0 + n])  # noqa: E731
    a0, b0 = int(lay.offsets[0]) + 1000, int(lay.offsets[1]) + 5000
    aligned = ref(b0, 1500) + "ACGTA" + ref(b0 + 1510, 1490)   # M1500 D10 I5 M1490
    extra_reads = {"long_fwd": ref(a0, 70_000),
                   "rev_indel": "TT" + tpaf.revcomp(aligned) + "GG",
                   "lost": ref(a0, 500)}
    seqs.update(extra_reads)
    quals["long_fwd"] = "I" * 70_000
    quals["lost"] = "5" * 500
    n3 = lambda *v: np.array(v, np.int64)  # noqa: E731
    extra = tpaf.PafRecords(
        qname=np.array(list(extra_reads), object), qlen=n3(70_000, 2_999, 500),
        qstart=n3(0, 2, 0), qend=n3(70_000, 2_997, 500), rev=np.array([0, 1, 0], np.int8),
        tname=np.array([lay.names[0], lay.names[1], "not_a_contig"], object),
        tlen=n3(*lay.lengths[:2], 500), tstart=n3(1000, 5000, 0), tend=n3(71_000, 8000, 500),
        nmatch=n3(70_000, 2_990, 500), blocklen=n3(70_000, 3_005, 500), mapq=n3(60, 60, 60),
        align_score=n3(0, 0, 0), s1=n3(0, 0, 0), primary=np.ones(3, np.int8),
        cigars=["70000M", np.array([1500 << 4, (10 << 4) | 2, (5 << 4) | 1, 1490 << 4],
                                   np.uint32), "500M"])
    full = _with_records(parsed["paf_full"][1], extra)
    trunc = parsed["paf_trunc"][1]
    n_full = len(parsed["paf_full"][1])
    f_rows = list(tpaf.best_per_query(parsed["paf_full"][1]).values())[:150]
    f_rows = f_rows[:75] + [n_full, n_full + 1, n_full + 2] + f_rows[75:]
    t_rows = list(tpaf.best_per_query(trunc).values())[:150]
    t_seqs = {r: s[:MU] for r, s in seqs.items()}
    t_quals = {r: quals.get(r, "")[: len(t_seqs[r])] for r in seqs}
    for i in t_rows:   # Q2: a reverse truncated record's text is the read's last mu bases
        if trunc.rev[i]:
            rid = trunc.qname[i]
            t_seqs[rid], t_quals[rid] = seqs[rid][-MU:], quals.get(rid, "")[-MU:]
    assert trunc.rev[t_rows].any() and not trunc.rev[t_rows].all()
    bc = {r: int(rng.integers(0, 4)) for r in seqs}
    read_rows = {r: int(i) for i, r in enumerate(rng.permutation(list(seqs)))}
    sets = {"full": [(full, f_rows, seqs, quals)],
            "trunc_q2": [(trunc, t_rows, t_seqs, t_quals)],
            "pack_batch": [(full, f_rows, seqs, quals), (trunc, t_rows, t_seqs, t_quals)],
            "empty": [(full, [], seqs, quals), (full, [n_full + 2], seqs, quals)]}
    return lay, sets, bc, read_rows


def _serial_rows(lay, sets, bc, read_rows, tid_of, **kw):
    """The serial composition: build_packed_runs, then split_runs_rows."""
    rrow = np.array([read_rows[rec.qname[i]] for rec, rows, _s, _q in sets
                     for i in rows if rec.tname[i] in tid_of], np.int32)
    return tcoo.split_runs_rows(lay, *tcoo.build_packed_runs(lay, sets, bc), rrow, **kw)


def _built(fn):
    """``fn()`` under the profiler, and the ``coo.build`` spans it made."""
    from bossruns_torch.utils import spans

    n = len(spans.recorded())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, [r for r in spans.recorded()[n:]
                 if isinstance(r, spans.Span) and r.name == "coo.build"]


@pytest.mark.parametrize("case", ["full", "trunc_q2", "pack_batch", "empty"])
@pytest.mark.parametrize("chunks", [1, 2, 7, "records"])
def test_coverage_rows_equal_serial_and_numpy_at_every_chunk_count(rows_case, case, chunks,
                                                                    monkeypatch):
    """The record-parallel pass gives the serial native path's arrays and
    the NumPy fallback's, byte for byte: the gated sets with their read
    rows (reverse strands, the Q2 truncated windows, a run over 65,535, a
    record on an unknown contig), pack_batch's padded fields over both
    sets, and sets with nothing on a known contig; with 1, 2 and 7 chunks
    a set and with more chunks asked for than the set has records."""
    lay, sets, bc, read_rows = rows_case
    sets = sets[case]
    tid_of = {n: i for i, n in enumerate(lay.names)}
    known = [[i for i in rows if rec.tname[i] in tid_of] for rec, rows, _s, _q in sets]
    bases = [int((rec.tend[k] - rec.tstart[k]).sum()) for (rec, *_), k in zip(sets, known)]
    monkeypatch.setattr(tcoo, "CHUNKS_PER_WORKER", 10 ** 6)
    if chunks == 1:
        monkeypatch.setattr(tcoo, "CHUNK_BASES", 1 << 40)
    elif chunks == "records":
        monkeypatch.setattr(tcoo, "CHUNK_BASES", 1)
    else:
        monkeypatch.setattr(tcoo, "CHUNK_BASES", max(1, min(b for b in bases if b) // chunks)
                            if any(bases) else 1)
    rs = (np.arange(512, dtype=np.int32) % 7, np.zeros(512, np.int32),
          np.ones(512, np.float32))
    if case == "pack_batch":
        kw = dict(barcodes=bc, rs=rs, floors=(5000, 100), qt=10, len_b=4)
        got, built = _built(lambda: tcoo.pack_batch(lay, sets, device=None, **kw))
        serial = tcoo.pad_split(tcoo.split_runs(lay, *tcoo.build_packed_runs(lay, sets, bc),
                                                10, 4), (5000, 100))
        serial.update(rs_row=rs[0], rs_strand=rs[1], rs_w=rs[2])
        assert set(got) == set(serial)
        got, serial = [got[k] for k in sorted(got)], [serial[k] for k in sorted(serial)]
        monkeypatch.setattr(tcoo.native_mod, "_lib", False)
        plain = tcoo.pack_batch(lay, sets, device=None, **kw)
        plain = [plain[k] for k in sorted(plain)]
    else:
        got, built = _built(lambda: tcoo.coverage_rows(lay, sets, bc, read_rows=read_rows))
        serial = _serial_rows(lay, sets, bc, read_rows, tid_of)
        monkeypatch.setattr(tcoo.native_mod, "_lib", False)
        plain = tcoo.coverage_rows(lay, sets, bc, read_rows=read_rows)
    assert len(got) == len(serial) == len(plain)
    for a, b, c in zip(got, serial, plain):
        _same(a, b, f"{case} against serial")
        _same(a, c, f"{case} against numpy")
    if case == "empty":
        assert not any(a.size for a in got) and not built
        return
    assert len(built) == 1
    attrs = built[0].attrs
    assert attrs["records"] == sum(map(len, known)) and attrs["bases"] == sum(bases)
    if chunks == 1:
        assert attrs["chunks"] == len(sets) and attrs["workers"] == 1
    else:   # cut at records, so a long record can take two cuts' places
        most = attrs["records"] if chunks == "records" else chunks * len(sets)
        assert len(sets) < attrs["chunks"] <= most
    if attrs["chunks"] > len(sets):
        assert attrs["workers"] == len(os.sched_getaffinity(0))
    if case == "full":
        assert int(got[2].max()) == 65_535    # the 70,000-base run, cut at 65,535


def test_small_set_runs_as_one_chunk_on_the_calling_thread(rows_case, monkeypatch):
    """A set under twice CHUNK_BASES covered bases is one chunk: its
    native calls run on the calling thread, and no pool is made."""
    lay, sets, bc, read_rows = rows_case
    rec, rows, seqs, quals = sets["full"][0]
    small = [(rec, rows[:20], seqs, quals)]
    assert int((rec.tend[rows[:20]] - rec.tstart[rows[:20]]).sum()) < 2 * tcoo.CHUNK_BASES
    monkeypatch.setattr(tcoo, "_pool", None)

    def no_pool():
        raise AssertionError("a pool was asked for")

    monkeypatch.setattr(tcoo, "_workers", no_pool)
    threads, run = [], tcoo._run
    monkeypatch.setattr(tcoo, "_run", lambda calls: threads.append(threading.get_ident())
                        or run(calls))
    got, built = _built(lambda: tcoo.coverage_rows(lay, small, bc, read_rows=read_rows))
    assert threads == [threading.get_ident()] and tcoo._pool is None
    assert [b.attrs["chunks"] for b in built] == [1] and built[0].attrs["workers"] == 1
    tid_of = {n: i for i, n in enumerate(lay.names)}
    for a, b in zip(got, _serial_rows(lay, small, bc, read_rows, tid_of)):
        _same(a, b, "one chunk against serial")


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
