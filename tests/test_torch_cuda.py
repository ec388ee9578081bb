"""The CUDA kernels against their plain versions, on a card (marker ``cuda``).

Skipped where torch sees no GPU; on a machine with one run
``python -m pytest tests/test_torch_cuda.py -m cuda -q``. Two barcodes,
so the per-barcode index math is exercised (chip_smoke.py runs one). The
engine on the card is also held against the f64 NumPy oracle's decisions,
the contract tests/test_torch_engine.py holds on the CPU.
"""
import numpy as np
import pytest
import torch

from bossruns_tpu import oracle
from bossruns_tpu.models.layout import build_layout
from bossruns_torch.models import runs as truns
from bossruns_torch.models.convert import batch_from_numpy, state_to_numpy
from bossruns_torch.ops import genome_ops as tg
from bossruns_torch.ops import scores as ts
from test_engine_parity import _random_batch

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def setup(dev):
    rng = np.random.default_rng(3)
    lay = build_layout({"a": rng.integers(0, 4, 150_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 120_000).astype(np.uint8)}, n_barcodes=2)
    eng = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True), device=dev)
    state = eng.init_state()
    params = eng.make_params(CCL, 5300.0)
    for _ in range(3):
        b = batch_from_numpy(_random_batch(rng, lay, n_obs=120_000, nb=2), dev)
        state, _ = eng.step(state, b, params)
    batch = batch_from_numpy(_random_batch(rng, lay, n_obs=120_000, nb=2), dev)
    return eng, state, batch, params


def _clone(d):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in d.items()}


def test_engine_on_card_matches_cpu(setup, dev):
    eng, _, _, _ = setup
    rng = np.random.default_rng(9)
    cpu = truns.RunsEngine(eng.layout, config=eng.config, device="cpu")
    sg, sc = eng.init_state(), cpu.init_state()
    params = eng.make_params(CCL, 5300.0)
    for step in range(6):
        b = _random_batch(rng, eng.layout, n_obs=120_000, nb=2)
        sg, ag = eng.step(sg, batch_from_numpy(b, dev), params)
        sc, ac = cpu.step(sc, batch_from_numpy(b, "cpu"), params)
        g, c = state_to_numpy(sg), state_to_numpy(sc)
        for k in ("coverage", "zeroed", "bucket_on", "read_starts"):
            np.testing.assert_array_equal(g[k], c[k], err_msg=f"{k} step {step}")
        np.testing.assert_allclose(ag.scores.cpu().numpy(), ac.scores.numpy(),
                                   rtol=1e-5, atol=5e-5)
        assert bool(ag.updated) == bool(ac.updated)


def test_coverage_kernel_exact(setup):
    eng, state, batch, _ = setup
    rows = tg.CovRows(batch.mr_bc, batch.mr_g, batch.mr_len, batch.ex_bcsym, batch.ex_g)
    a, b = _clone(eng.coverage_args(state, rows)), _clone(eng.coverage_args(state, rows))
    assert torch.equal(tg.coverage_update(**a), tg.coverage_update_plain(**b))
    assert torch.equal(a["coverage"].view(torch.int16), b["coverage"].view(torch.int16))


def test_score_kernel_within_f32_tolerance(setup):
    eng, state, _, _ = setup
    args = eng.score_args(state)
    sk, ck = ts.site_scores(**args)
    sp, cp = ts.site_scores_plain(**args)
    assert torch.equal(ck, cp)
    torch.testing.assert_close(sk, sp, rtol=1e-5, atol=5e-5)


def test_row_and_benefit_kernels(setup, dev):
    eng, state, batch, params = setup
    rows = tg.CovRows(batch.mr_bc, batch.mr_g, batch.mr_len, batch.ex_bcsym, batch.ex_g)
    changed = tg.coverage_update_plain(**_clone(eng.coverage_args(state, rows)))
    scores, covsum = ts.site_scores(**eng.score_args(state))
    aux = torch.zeros(4, dtype=torch.float32, device=dev)
    args = eng.row_args(state, scores, covsum, changed, aux, params,
                        batch.rs_row, batch.rs_strand, rs_w=batch.rs_w)
    a, b = _clone(args), _clone(args)
    for x, y in zip(tg.row_stage(**a), tg.row_stage_plain(**b)):
        assert torch.equal(x, y)
    for k in ("scores", "zeroed", "bucket_on", "read_starts", "aux"):
        assert torch.equal(a[k], b[k]), k
    ds, fe = tg.row_stage_plain(**_clone(args))
    bargs = eng.benefit_args(state, ds, fe, a["aux"], params)
    a, b = _clone(bargs), _clone(bargs)
    smu_k, ben_k, thr_k = tg.benefit_strategy(**a)
    smu_p, ben_p, _ = tg.benefit_strategy_plain(**b)
    atol = 256 * np.finfo(np.float64).eps * float(ds.sum(dim=1).max())
    torch.testing.assert_close(smu_k, smu_p, rtol=1e-12, atol=atol)
    torch.testing.assert_close(ben_k, ben_p, rtol=1e-12, atol=atol)
    ref = tg.find_strategy(ben_k, smu_k, fe[None].expand_as(ben_k), bargs["time_cost"])
    assert float(ref.threshold) == float(thr_k)


def test_row_kernel_gated_exact(setup, dev):
    """H3 with read-start weights from per-read bits (the gated flow)."""
    eng, state, batch, params = setup
    rng = np.random.default_rng(12)
    n_rs = batch.rs_row.shape[0]
    rs_read = torch.arange(n_rs, dtype=torch.int32, device=dev)
    bits = torch.from_numpy((rng.random(n_rs) < 0.5).astype(np.uint8)).to(dev)
    scores, covsum = ts.site_scores(**eng.score_args(state))
    changed = torch.ones(scores.shape[-1], dtype=torch.bool, device=dev)
    aux = torch.zeros(4, dtype=torch.float32, device=dev)
    args = eng.row_args(state, scores, covsum, changed, aux, params, batch.rs_row,
                        batch.rs_strand, rs_read=rs_read, bits=bits)
    a, b = _clone(args), _clone(args)
    for x, y in zip(tg.row_stage(**a), tg.row_stage_plain(**b)):
        assert torch.equal(x, y)
    for k in ("scores", "zeroed", "bucket_on", "read_starts", "aux"):
        assert torch.equal(a[k], b[k]), k
    added = float(a["read_starts"].sum()) - float(args["read_starts"].sum())
    assert added == float(bits.sum())


def test_engine_on_card_matches_oracle_decisions(dev):
    """Given the card's own f32 scores, coverage, bucket_on, read_starts and
    strat equal the f64 oracle exactly, step by step."""
    rng = np.random.default_rng(21)
    lay = build_layout({"a": rng.integers(0, 4, 150_000).astype(np.uint8),
                        "b": rng.integers(0, 4, 120_000).astype(np.uint8)})
    eng = truns.RunsEngine(lay, config=truns.RunsConfig(debug_aux=True), device=dev)
    state = eng.init_state()
    st_np = state_to_numpy(state)
    st_np["read_starts"] = st_np["read_starts"].astype(np.float64)
    params = eng.make_params(CCL, 5300.0)
    updated = 0
    for step in range(10):
        b = _random_batch(rng, lay, n_obs=120_000)
        state, aux = eng.step(state, batch_from_numpy(b, dev), params)
        st_np, aux_o = oracle.full_update(eng, st_np, b, CCL, 5300.0,
                                          scores_override=aux.scores.cpu().numpy())
        got = state_to_numpy(state)
        assert bool(aux.updated) == aux_o["updated"], step
        for k in ("coverage", "bucket_on", "strat"):
            np.testing.assert_array_equal(got[k], st_np[k], err_msg=f"{k} step {step}")
        np.testing.assert_array_equal(got["read_starts"].astype(np.float64), st_np["read_starts"])
        if aux_o["updated"]:
            updated += 1
            np.testing.assert_allclose(float(aux.threshold), aux_o["threshold"], rtol=1e-12)
    assert updated >= 5
