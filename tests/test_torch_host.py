"""Port host modules: byte-identical to the JAX package's, and JAX-free.

* parse_paf, split_runs, split_runs_rows and pack_batch of the port give
  the same arrays as the bossruns_tpu functions on the corpus;
* a subprocess in which ``jax`` cannot be imported imports the whole port
  and runs two simulation batches on the CPU;
* the kernel build raises a clear error without nvcc instead of falling
  back, and a wrapper given a tensor on neither the CPU nor CUDA raises.
"""
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
            if name.split(".")[0] in ("jax", "jaxlib"):
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
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
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


def test_port_source_has_no_jax_import():
    import re

    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
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
    for name in ("coverage.cu", "scores.cu", "rows.cu", "strategy.cu"):
        head = (REPO / "bossruns_torch" / "csrc" / name).read_text()[:3000]
        assert "Replaces:" in head and "Bound on the H100" in head and "Design" in head, name
