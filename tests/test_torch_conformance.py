"""The port's f64 oracle and its zymo conformance drives, on the CPU.

* ``bossruns_torch.oracle`` equals ``bossruns_tpu.oracle`` bit for bit:
  ``full_update`` on one engine, state and batch (haploid and diploid,
  with and without reference_quirks, with the oracle's own f64 scores and
  with the engine's as ``scores_override``), ``fhat_pointmass`` at alpha 1
  and 2, and ``ReferenceQuirkOracle.step`` over two batches (masks and
  drift-free masks). Tolerance zero: the same NumPy arithmetic.
* the twin of tests/test_conformance_zymo.py with the same asserts: the
  port's engine (quirk mode, on the CPU) exact against the drift-free f64
  oracle and >= 0.995 / 0.996 agreement with the complete bug-compatible
  oracle, at 1.3 Mb and at the 12.6 Mb zymo shape, and through the port's
  simulation data plane (coverage bit-exact; haploid, diploid, barcoded).
* the port's drives equal the JAX package's at 1.3 Mb: coverage and
  masks on every batch (zymo drive), agreements and final masks (data
  plane). F6: ``residual_unexplained`` is zero by construction, so the
  port is judged by these equalities, not by it.

Every generator is seeded here (numpy), never taken from the session rng.
"""
import numpy as np
import pytest
import torch

from bossruns_tpu import conformance as jconf
from bossruns_tpu import oracle as joracle
from bossruns_tpu import oracle_quirks as jquirks
from bossruns_tpu.models import runs as jruns
from bossruns_torch import conformance as tconf
from bossruns_torch import oracle as toracle
from bossruns_torch import oracle_quirks as tquirks
from bossruns_torch.models import runs as truns
from bossruns_torch.models.convert import batch_from_numpy, state_to_numpy
from bossruns_torch.models.layout import build_layout
from bossruns_torch.ops.model import make_model
from bossruns_torch.utils.misc import read_strategy_npz
from test_engine_parity import _random_batch

torch.set_num_threads(2)

SMALL = {"a": 600_000, "b": 400_000, "c": 180_000, "d": 120_000}
CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
TIME_COST = 5300.0


def _same_dict(a: dict, b: dict, what: str) -> None:
    assert set(a) == set(b), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (what, k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {k}")


# ------------------------------------------------------------- the oracle ---

@pytest.mark.parametrize("ploidy,quirks", [(1, False), (1, True), (2, False), (2, True)])
def test_port_full_update_equals_jax_oracle(ploidy, quirks):
    """Two steps of the port's engine (CPU) make a state with buckets on;
    from it both oracles take the same batch, with their own f64 scores
    and with the engine's f32 scores: every output equal bit for bit."""
    rng = np.random.default_rng(81 + ploidy + 2 * quirks)
    lay = build_layout({"a": rng.integers(0, 4, 150_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 110_000).astype(np.uint8)})
    model = make_model(ploidy=ploidy)
    eng = truns.RunsEngine(lay, model, truns.RunsConfig(debug_aux=True, reference_quirks=quirks),
                           device="cpu")
    state = eng.init_state()
    params = eng.make_params(CCL, TIME_COST)
    for _ in range(2):
        b = _random_batch(rng, lay, n_obs=150_000, len_b=model.len_b)
        state, aux = eng.step(state, batch_from_numpy(b, "cpu"), params)
    st_np = state_to_numpy(state)
    st_np["read_starts"] = st_np["read_starts"].astype(np.float64)
    assert st_np["bucket_on"].any()
    b = _random_batch(rng, lay, n_obs=150_000, len_b=model.len_b)
    _, aux = eng.step(state, batch_from_numpy(b, "cpu"), params)
    override = aux.scores.numpy()
    for kw in ({}, {"scores_override": override}):
        got_s, got_a = toracle.full_update(eng, dict(st_np), b, CCL, TIME_COST,
                                           reference_quirks=quirks, **kw)
        want_s, want_a = joracle.full_update(eng, dict(st_np), b, CCL, TIME_COST,
                                             reference_quirks=quirks, **kw)
        what = f"ploidy {ploidy} quirks {quirks} override {bool(kw)}"
        _same_dict(got_s, want_s, what + " state")
        _same_dict(got_a, want_a, what + " aux")
        assert got_a["updated"], what


@pytest.mark.parametrize("alpha", [1.0, 2.0])
def test_port_fhat_pointmass_equals_jax(alpha):
    rng = np.random.default_rng(83)
    rs = rng.integers(0, 6, (700, 2)).astype(np.float64)
    rs[rng.random(700) < 0.4] = 0.0
    got = toracle.fhat_pointmass(rs, alpha=alpha, p0=0.1)
    want = joracle.fhat_pointmass(rs, alpha=alpha, p0=0.1)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_port_quirk_oracle_equals_jax():
    """ReferenceQuirkOracle over two batches of ONT-profile observations:
    masks and drift-free masks equal bit for bit in both packages."""
    rng = np.random.default_rng(85)
    lengths = {"a": 260_000, "b": 150_000, "c": 104_000}
    contigs = {n: rng.integers(0, 4, L).astype(np.uint8) for n, L in lengths.items()}
    lay = build_layout(contigs)
    qos = (tquirks.ReferenceQuirkOracle(contigs, make_model(ploidy=1)),
           jquirks.ReferenceQuirkOracle(contigs, make_model(ploidy=1)))
    n_on = 0
    for step in range(2):
        (sym, _rs, rlen, cid, _rev, start_local, fwd, rev) = tconf.ont_observation_batch(
            rng, lay, 900)
        base_off = np.concatenate([[0], np.cumsum(rlen)[:-1]])
        outs = []
        for qo in qos:
            for i, name in enumerate(lay.names):
                sel = np.flatnonzero(cid == i)
                pos = np.concatenate([np.arange(start_local[j], start_local[j] + rlen[j])
                                      for j in sel])
                psym = np.concatenate([sym[base_off[j]: base_off[j] + rlen[j]] for j in sel])
                qo.increment(name, pos, psym.astype(np.int64))
            qo.count_read_starts(fwd, rev)
            outs.append(qo.step(CCL, TIME_COST, also_drift_free=True))
        (tm, tdf), (jm, jdf) = outs
        _same_dict(tm, jm, f"masks step {step}")
        _same_dict(tdf, jdf, f"drift-free masks step {step}")
        n_on += sum(int((~m).sum()) for m in tm.values())
    assert n_on > 0, "the quirk oracle never rejected a row"


# ---------------------------------------------------- conformance (twin) ---

def test_small_scale_agreement_exercises_decisions():
    out = tconf.drive_zymo_conformance(n_batches=3, reads_per_batch=1500, lengths=SMALL,
                                       device="cpu")
    assert out["any_on"], "bucket switches never flipped"
    assert out["exact_vs_drift_free"], out["exact_batches"]
    assert out["min_agreement"] >= 0.995, out
    assert out["residual_unexplained"] == 0, out


def test_zymo_scale_agreement():
    """9 contigs / 12.6 Mb / ~3.3x coverage per batch, the port's engine on
    the CPU: the twin of tests/test_conformance_zymo.py, with its asserts.
    About 80 s on one CPU worker, where the port's plain versions run the
    12.6 Mb step; chip_smoke.py phase 16 runs the same drive on the card."""
    out = tconf.drive_zymo_conformance(n_batches=3, reads_per_batch=12_000, device="cpu")
    assert out["n_contigs"] == 9
    assert out["n_sites"] == sum(tconf.ZYMO_LIKE_LENGTHS.values())
    assert out["any_on"], "bucket switches never flipped"
    assert out["exact_vs_drift_free"], out["exact_batches"]
    assert out["min_agreement"] >= 0.996, out
    assert out["residual_unexplained"] == 0, out
    assert out["residual_precision"] <= 0.05 * max(out["residual_observed"], 1), out
    print(f"port zymo conformance: quirk-oracle agreement {out['per_batch']}, "
          f"exact vs drift-free {out['exact_batches']}")


@pytest.mark.parametrize("variant", ["haploid", "diploid", "barcoded"])
def test_dataplane_conformance_variants(variant, tmp_path):
    kw = {"haploid": {}, "diploid": {"ploidy": 2}, "barcoded": {"barcoded": True}}[variant]
    out = tconf.drive_dataplane_conformance(n_batches=3, reads_per_batch=1200, lengths=SMALL,
                                            work_dir=tmp_path, device="cpu", **kw)
    assert out["any_on"], "bucket switches never flipped"
    assert out["coverage_exact"], out["coverage_exact_batches"]
    assert out["min_agreement"] >= 0.995, out
    assert out["residual_unexplained"] == 0, out


def test_dataplane_conformance_zymo_scale(tmp_path):
    out = tconf.drive_dataplane_conformance(n_batches=2, reads_per_batch=8000,
                                            work_dir=tmp_path, device="cpu")
    assert out["n_contigs"] == 9
    assert out["n_sites"] == sum(tconf.ZYMO_LIKE_LENGTHS.values())
    assert out["any_on"]
    assert out["coverage_exact"], out["coverage_exact_batches"]
    assert out["min_agreement"] >= 0.996, out
    assert out["residual_unexplained"] == 0, out


@pytest.mark.skipif("not __import__('os').environ.get('BOSS_FULL_CONFORMANCE')",
                    reason="full-scale diploid/barcoded drives take minutes; "
                           "set BOSS_FULL_CONFORMANCE=1")
@pytest.mark.parametrize("variant", ["diploid", "barcoded"])
def test_dataplane_conformance_zymo_scale_variants(variant, tmp_path):
    kw = {"diploid": {"ploidy": 2}, "barcoded": {"barcoded": True}}[variant]
    out = tconf.drive_dataplane_conformance(n_batches=2, reads_per_batch=8000,
                                            work_dir=tmp_path, device="cpu", **kw)
    assert out["any_on"]
    assert out["coverage_exact"], out["coverage_exact_batches"]
    assert out["min_agreement"] >= 0.996, out
    assert out["residual_unexplained"] == 0, out


# ------------------------------------------------------- port == JAX -------

def _capture_masks(monkeypatch, cls, to_np):
    """Record (coverage, strat_dict) each time a drive reads an engine's masks."""
    seen = []
    orig = cls.strat_dict

    def strat_dict(self, state):
        out = orig(self, state)
        seen.append((to_np(state.coverage), out))
        return out

    monkeypatch.setattr(cls, "strat_dict", strat_dict)
    return seen


def test_port_zymo_drive_equals_jax_drive(monkeypatch):
    """Same seed and lengths through both packages' drives: coverage and
    masks equal on every batch, and each engine exact against its own
    oracle given its own scores."""
    port = _capture_masks(monkeypatch, truns.RunsEngine, lambda c: c.cpu().numpy().copy())
    jax = _capture_masks(monkeypatch, jruns.RunsEngine, np.asarray)
    kw = dict(n_batches=3, reads_per_batch=1500, lengths=SMALL)
    t = tconf.drive_zymo_conformance(device="cpu", **kw)
    j = jconf.drive_zymo_conformance(**kw)
    assert t["exact_vs_drift_free"] and j["exact_vs_drift_free"], (t, j)
    assert len(port) == len(jax) == 3
    for b, ((tc, tm), (jc, jm)) in enumerate(zip(port, jax)):
        np.testing.assert_array_equal(tc, jc, err_msg=f"coverage batch {b}")
        n_diff = sum(int((tm[n] != jm[n]).sum()) for n in jm)
        print(f"batch {b}: {n_diff} mask cells differ between the port and JAX")
        assert n_diff == 0, (
            f"batch {b}: {n_diff} mask cells differ; each engine reproduces its own f64 "
            f"oracle's masks (exact_vs_drift_free), so they come from f32 score ulps (F5)")
    assert t["per_batch"] == j["per_batch"]


def test_port_dataplane_drive_equals_jax_drive(tmp_path):
    kw = dict(n_batches=2, reads_per_batch=1200, lengths=SMALL)
    t = tconf.drive_dataplane_conformance(work_dir=tmp_path / "t", device="cpu", **kw)
    j = jconf.drive_dataplane_conformance(work_dir=tmp_path / "j", **kw)
    assert t["coverage_exact"] and j["coverage_exact"]
    assert t["per_batch"] == j["per_batch"], (t["per_batch"], j["per_batch"])
    tm = read_strategy_npz(tmp_path / "t" / "out_dpc" / "masks" / "boss.npz")
    jm = read_strategy_npz(tmp_path / "j" / "out_dpc" / "masks" / "boss.npz")
    _same_dict(tm, jm, "final masks")
