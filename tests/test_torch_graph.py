"""Device StepParams and the captured step (models/graphs.py) on the CPU.

(a) ``make_params`` gives the JAX engine's StepParams on the engine's
    device (approx_ccl int32 [10], time_cost and bucket_threshold f32, views
    of one block), and the port's step with them equals the JAX engine with
    its own StepParams for the default engine, fhat_alpha=1.7,
    dtype="float64", dtype="float16" and benefit_dtype="float32": coverage,
    zeroed, bucket_on and read_starts exact, and, given the JAX engine's
    own scores, strategy, threshold and aux bit for bit (the port scans the
    benefit cumsum tile by tile away from the default dtypes, where XLA does
    not: with f64 scores the strategy is exact and the threshold within
    rtol 1e-12, as test_torch_options.py (c) holds it; with f32 decisions
    the strat cells that differ follow its one-bin rule (d));
(b) the values the device computes from the parameters round as the host
    did: the CCL windows clip(approx_ccl // 100, 1, clamp) and H4's
    tc = time_cost // 100 (Python's float floor division, in f64), over
    negative, exact-multiple, tiny and huge values;
(c) tier invariance: a batch padded into a larger tier gives the same
    state and aux bit for bit, through step, step_from_numpy, step_gated
    and the in-process mesh on the CPU;
(d) the graph cache, with a stand-in graph whose replay reruns the body it
    recorded (on the static buffers, as a CUDA graph replays its
    kernels): the first step of a key runs eagerly, the second captures
    and replays; one spec gives one entry, a new spec or window bound a
    new one; a state object the cache has not seen drops every graph and
    is bound instead; every step equals the eager engine's bit for bit; a
    replay's inputs, params and outputs live in the key's static buffers;
    a wire reaches the card only from a staging buffer, with its spec; the
    mesh's step_from_numpy is its step.
The cuda-marked cases of tests/test_torch_cuda.py hold the real CUDA graphs
against eager steps on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bossruns_tpu.models import runs as jruns
from bossruns_tpu.models.layout import build_layout
from bossruns_torch.io.coo import _pad_len
from bossruns_torch.models import runs as truns
from bossruns_torch.models.convert import batch_from_numpy, state_to_numpy, tensors_from_numpy
from bossruns_torch.models.graphs import GraphCache
from bossruns_torch.ops import genome_ops as tg
from bossruns_torch.parallel import mesh as tmesh
from bossruns_torch.utils.staging import PinnedStaging
from test_engine_parity import _random_batch
from test_torch_f16 import _override_scores
from test_torch_options import _benefit, _threshold_rule
from test_torch_wire import _gated_from_batch

torch.set_num_threads(2)

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
STATE = ("coverage", "zeroed", "bucket_on", "read_starts")
OPTIONS = {
    "default": {},
    "alpha_1.7": dict(fhat_alpha=1.7),
    "float64": dict(dtype="float64"),
    "float16": dict(dtype="float16"),
    "decisions_f32": dict(benefit_dtype="float32"),
}


def _layout(seed: int, nb: int = 1, align: int = 1):
    rng = np.random.default_rng(seed)
    return build_layout({"a": rng.integers(0, 4, 130_000).astype(np.uint8),
                         "b": rng.integers(0, 4, 110_000).astype(np.uint8)}, n_barcodes=nb,
                        align_chunks=align)


def _jbatch(b):
    return jruns.ReadBatch(**{k: jnp.asarray(v) for k, v in b.items()})


class Rerun:
    """Stand-in for models.graphs.CudaGraph: capture records the body
    without running it, replay reruns it."""

    def __init__(self, pool):
        self.fn = None

    @staticmethod
    def new_pool():
        return None

    def capture(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


class HostStaging(PinnedStaging):
    """Stand-in for PinnedStaging on the CPU: plain host buffers (pinning
    needs the card) and no event (a CPU copy is done when it returns)."""

    @staticmethod
    def _buffer(n_words):
        return torch.empty(n_words, dtype=torch.int32)

    @staticmethod
    def _new_event():
        return None


def _graphed(eng):
    eng.graphs = GraphCache("cpu", graph=Rerun)
    if not isinstance(eng, tmesh.ShardedRunsEngine):  # the mesh packs no staged wire
        eng._staging = HostStaging()
    return eng


# ------------------------------------------------------------------- (a) ----

def test_make_params_are_device_tensors():
    eng = truns.RunsEngine(_layout(1), config=truns.RunsConfig(bucket_threshold=5.3),
                           device="cpu")
    p = eng.make_params(CCL.astype(np.int64), 5300.7)
    assert p.approx_ccl.dtype == torch.int32 and tuple(p.approx_ccl.shape) == (10,)
    assert p.time_cost.dtype == p.bucket_threshold.dtype == torch.float32
    assert p.time_cost.dim() == p.bucket_threshold.dim() == 0
    for t in (p.approx_ccl, p.time_cost, p.bucket_threshold):
        assert t.device == eng.device and t.untyped_storage().data_ptr() == p.block.data_ptr()
    np.testing.assert_array_equal(p.approx_ccl.numpy(), CCL)
    assert float(p.time_cost) == float(np.float32(5300.7))
    assert float(p.bucket_threshold) == float(np.float32(5.3))
    assert p.win_bucket == 512  # 30000 // 100 = 300 rows -> 512
    assert eng.win_cap(p, 4096) == 512 and eng.win_cap(p, 100) == 100
    jp = jruns.RunsEngine(_layout(1), config=jruns.RunsConfig(bucket_threshold=5.3)).make_params(
        CCL, 5300.7)
    for k in ("approx_ccl", "time_cost", "bucket_threshold"):
        np.testing.assert_array_equal(getattr(p, k).numpy(), np.asarray(getattr(jp, k)), err_msg=k)
        assert getattr(p, k).numpy().dtype == np.asarray(getattr(jp, k)).dtype, k


@pytest.mark.parametrize("option", list(OPTIONS))
def test_device_params_match_jax(option, monkeypatch):
    cfg = dict(debug_aux=True, **OPTIONS[option])
    lay = _layout(11, nb=2)
    je = jruns.RunsEngine(lay, config=jruns.RunsConfig(**cfg))
    te = truns.RunsEngine(lay, config=truns.RunsConfig(**cfg), device="cpu")
    given = truns.RunsEngine(lay, config=truns.RunsConfig(**cfg), device="cpu")
    js, ts, gs = je.init_state(), te.init_state(), given.init_state()
    jp, tp = je.make_params(CCL, 5300.0), te.make_params(CCL, 5300.0)
    rng = np.random.default_rng(11)
    box, updated = {}, 0
    for step in range(4):
        b = _random_batch(rng, lay, n_obs=200_000, nb=2)
        js, ja = je.step(js, _jbatch(b), jp)
        ts, ta = te.step(ts, batch_from_numpy(b, "cpu"), tp)
        got = state_to_numpy(ts)
        for k in STATE:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                          err_msg=f"{k} step {step}")
        assert bool(ta.updated) == bool(ja.updated)
        updated += bool(ja.updated)
        # the decision stages given the JAX engine's own scores
        box["scores"] = np.asarray(ja.scores)
        with monkeypatch.context() as mp:
            _override_scores(mp, box)
            gs, ga = given.step(gs, batch_from_numpy(b, "cpu"), tp)
        g_np = state_to_numpy(gs)
        for k in STATE:
            np.testing.assert_array_equal(g_np[k], np.asarray(getattr(js, k)),
                                          err_msg=f"{k} given JAX's scores, step {step}")
        if option == "decisions_f32":
            diff = torch.from_numpy(g_np["strat"] != np.asarray(js.strat))
            if bool(diff.any()):
                _threshold_rule(float(ja.threshold), float(ga.threshold), diff,
                                *_benefit(given, ga.scores))
            continue
        np.testing.assert_array_equal(g_np["strat"], np.asarray(js.strat),
                                      err_msg=f"strat given JAX's scores, step {step}")
        if option == "float64":  # f64 sums of f64 scores: the scan's order shows
            np.testing.assert_allclose(float(ga.threshold), float(ja.threshold), rtol=1e-12)
            np.testing.assert_array_equal(ga.vec.numpy()[[0, 1, 3]], np.asarray(ja.vec)[[0, 1, 3]])
            continue
        assert float(ga.threshold) == float(ja.threshold), step
        np.testing.assert_array_equal(ga.vec.numpy(), np.asarray(ja.vec))
    assert updated >= 2


# ------------------------------------------------------------------- (b) ----

def test_device_windows_round_as_the_host():
    rng = np.random.default_rng(2)
    ccl = np.concatenate([rng.integers(-2**31, 2**31 - 1, 4000),
                          rng.integers(-1000, 1000, 4000),
                          np.arange(-1000, 1001, 100), [0, 1, 99, 100, 101, 409_600, 409_700]])
    ccl = np.resize(ccl, -(-ccl.shape[0] // 10) * 10).astype(np.int32)
    for clamp in (1, 300, 4096):
        got = tg.ccl_windows(torch.from_numpy(ccl), clamp).numpy()
        want = [min(max(int(c) // 100, 1), clamp) for c in ccl]
        np.testing.assert_array_equal(got, want, err_msg=f"clamp {clamp}")


def test_device_tc_rounds_as_python_floor_division():
    rng = np.random.default_rng(3)
    tcs = np.concatenate([
        rng.normal(0, 1e4, 3000), rng.uniform(-1e9, 1e9, 1000), np.arange(-1000, 1001, 50),
        [0.0, -0.0, 99.99999, 100.0, 5300.0, 5300.7, 1e-30, -1e-30, 3.4e38, -3.4e38],
    ]).astype(np.float32)
    counts = torch.ones(192, dtype=torch.float64)
    norm, ubar0 = torch.tensor(2.0, dtype=torch.float64), torch.tensor(0.1, dtype=torch.float64)
    for t in tcs:
        got = torch.div(torch.tensor(t).double(), tg.scalar(100, torch.float64, "cpu"),
                        rounding_mode="floor")
        want = float(t) // 100
        assert float(got) == want or (np.isnan(want) and np.isnan(float(got))), (t, float(got))
    # the scan takes tc from the device tensor as it took the host float
    for t in (5300.0, -250.5, 1e-3):
        a = tg.threshold_from_bins(counts, counts * 0.5, norm, ubar0,
                                   torch.tensor(t, dtype=torch.float32), 192)
        b = tg.threshold_from_bins(counts, counts * 0.5, norm, ubar0, float(np.float32(t)), 192)
        assert float(a) == float(b)


# ------------------------------------------------------------------- (c) ----

def _pad_batch(b: dict, extra: int) -> dict:
    """``b`` padded by ``extra`` rows beyond its next _pad_len tier:
    mr_len 0, ex_g EX_PAD, read starts of weight 0."""
    out = dict(b)
    for fam, fill in (("mr", {"mr_len": 0}), ("ex", {"ex_g": tg.EX_PAD})):
        keys = [k for k in b if k.startswith(fam)]
        m = _pad_len(b[keys[0]].shape[0]) * 2 + extra
        for k in keys:
            a = np.full(m, fill.get(k, 0), b[k].dtype)
            a[: b[k].shape[0]] = b[k]
            out[k] = a
    m = 2 * b["rs_row"].shape[0] + extra
    for k in ("rs_row", "rs_strand", "rs_w"):
        a = np.zeros(m, b[k].dtype)
        a[: b[k].shape[0]] = b[k]
        out[k] = a
    return out


def _pad_gated(d: dict, extra: int) -> dict:
    out = dict(d)
    for pre in ("f_", "t_"):
        for fam, fill in (("mr", {"mr_len": 0}), ("ex", {"ex_g": tg.EX_PAD})):
            keys = [k for k in d if k.startswith(pre + fam)]
            m = 2 * _pad_len(d[keys[0]].shape[0]) + extra
            for k in keys:
                a = np.full(m, fill.get(k[len(pre):], 0), d[k].dtype)
                a[: d[k].shape[0]] = d[k]
                out[k] = a
    m = 2 * d["rs_row"].shape[0] + extra
    for k, fill in (("rs_row", 0), ("rs_strand", 0), ("rs_read", -1)):
        a = np.full(m, fill, d[k].dtype)
        a[: d[k].shape[0]] = d[k]
        out[k] = a
    return out


def _assert_same(s1, a1, s2, a2, what):
    n1, n2 = state_to_numpy(s1), state_to_numpy(s2)
    for k, v in n1.items():
        np.testing.assert_array_equal(n2[k], v, err_msg=f"{k}: {what}")
    assert torch.equal(a1.vec, a2.vec) and torch.equal(a1.threshold, a2.threshold), what


@pytest.mark.parametrize("path", ["step", "step_from_numpy", "step_gated"])
def test_padded_tier_gives_the_same_step(path):
    lay = _layout(21, nb=2)
    cfg = truns.RunsConfig()
    small = _graphed(truns.RunsEngine(lay, config=cfg, device="cpu"))
    large = _graphed(truns.RunsEngine(lay, config=cfg, device="cpu"))
    s1, s2 = small.init_state(), large.init_state()
    p = small.make_params(CCL, 5300.0)
    rng = np.random.default_rng(21)
    for step in range(4):
        b = _random_batch(rng, lay, n_obs=200_000, nb=2)
        if path == "step_gated":
            d = _gated_from_batch(rng, b, 300)
            bits = torch.from_numpy((rng.random(300) < 0.6).astype(np.uint8))
            s1, a1 = small.step_gated(s1, tensors_from_numpy(d, "cpu"), bits, p)
            wire, spec = large.pack_gated(_pad_gated(d, 7), out=large.stage)
            s2, a2 = large.step_gated(s2, large.unpack_gated(large.upload_wire(wire, spec), spec),
                                      bits, p)
        elif path == "step_from_numpy":
            s1, a1 = small.step_from_numpy(s1, b, p)
            s2, a2 = large.step_from_numpy(s2, _pad_batch(b, 5), p)
        else:
            s1, a1 = small.step(s1, batch_from_numpy(b, "cpu"), p)
            s2, a2 = large.step(s2, batch_from_numpy(_pad_batch(b, 3), "cpu"), p)
        _assert_same(s1, a1, s2, a2, f"{path} step {step}")
    assert bool(s1.bucket_on.any())
    assert large.graphs.replays[path] == 3 and large.graphs.eager[path] == 1


def test_padded_tier_gives_the_same_mesh_step():
    lay = _layout(22, nb=2, align=2)
    mesh = tmesh.make_mesh(["cpu"] * 4, barcode_shards=2)
    small = _graphed(tmesh.ShardedRunsEngine(lay, mesh))
    large = _graphed(tmesh.ShardedRunsEngine(lay, mesh))
    single = truns.RunsEngine(lay, device="cpu")
    s1, s2, s0 = small.init_state(), large.init_state(), single.init_state()
    p = small.make_params(CCL, 5300.0)
    rng = np.random.default_rng(22)
    for step in range(4):
        b = _random_batch(rng, lay, n_obs=200_000, nb=2)
        s1, a1 = small.step(s1, batch_from_numpy(b, "cpu"), p)
        s2, a2 = large.step(s2, batch_from_numpy(_pad_batch(b, 9), "cpu"), p)
        s0, a0 = single.step(s0, batch_from_numpy(b, "cpu"), p)
        n1, n2 = small.state_numpy(s1), large.state_numpy(s2)
        for k, v in state_to_numpy(s0).items():
            np.testing.assert_array_equal(n1[k], v, err_msg=f"{k} mesh vs single step {step}")
            np.testing.assert_array_equal(n2[k], v, err_msg=f"{k} padded mesh step {step}")
        assert torch.equal(a1.vec, a0.vec) and torch.equal(a2.vec, a0.vec)
        assert torch.equal(a1.threshold, a0.threshold) and torch.equal(a2.threshold, a0.threshold)
    assert large.graphs.replays["step"] == 3


# ------------------------------------------------------------------- (d) ----

def test_graph_cache_keys_and_state_binding():
    lay = _layout(31)
    cfg = truns.RunsConfig(debug_aux=True)
    eng = _graphed(truns.RunsEngine(lay, config=cfg, device="cpu"))
    ref = truns.RunsEngine(lay, config=cfg, device="cpu")
    g = eng.graphs
    st, sr = eng.init_state(), ref.init_state()
    p = eng.make_params(CCL, 5300.0)
    rng = np.random.default_rng(31)
    batches = [_random_batch(rng, lay, n_obs=60_000) for _ in range(9)]

    def both(b, params=p, pad=None):
        nonlocal st, sr
        st, a = eng.step_from_numpy(st, b if pad is None else _pad_batch(b, pad), params)
        sr, r = ref.step(sr, batch_from_numpy(b, "cpu"), params)
        _assert_same(sr, r, st, a, "graph cache vs eager")
        assert torch.equal(a.scores, r.scores)
        return a

    # one spec: eager, then capture + replay, then replay; one entry, and a
    # replay's outputs are the entry's static buffers
    both(batches[0])
    assert (g.eager["step_from_numpy"], len(g.captures), len(g.entries)) == (1, 0, 0)
    a1 = both(batches[1])
    a2 = both(batches[2])
    assert (g.replays["step_from_numpy"], len(g.captures), len(g.entries)) == (2, 1, 1)
    assert a1.vec is a2.vec and a1.threshold is a2.threshold and a1.scores is a2.scores
    (entry,) = g.entries.values()
    assert entry.params.block.data_ptr() != p.block.data_ptr()
    # the wire landed in the tier's own buffer: the inputs are its views
    spec = eng.pack_wire(batches[2])[1]
    wire = g.wires[spec]
    assert all(t.untyped_storage().data_ptr() == wire.untyped_storage().data_ptr()
               for t in entry.inputs.values())
    # a new spec: a new key (eager first), the old entry kept
    both(batches[3], pad=11)
    assert g.eager["step_from_numpy"] == 2 and len(g.entries) == 1
    both(batches[4], pad=11)
    assert len(g.entries) == 2 and len(g.wires) == 2
    # new params of the same window bound replay; a new bound is a new key
    p2 = eng.make_params(CCL * 2, 4100.0)
    assert p2.win_bucket == 1024
    both(batches[5], params=p2)
    assert len(g.entries) == 2 and g.eager["step_from_numpy"] == 3
    # a state object the cache has not seen drops every graph, and its
    # next step per key captures anew (the key's warm-up is kept)
    st = eng.state_from_numpy(state_to_numpy(st))
    both(batches[6])
    assert len(g.entries) == 1 and len(g.captures) == 3 and g.eager["step_from_numpy"] == 3
    both(batches[7])
    assert g.replays["step_from_numpy"] == 5
    # the classic path keys on its own
    st, a = eng.step(st, batch_from_numpy(batches[8], "cpu"), p)
    assert g.eager["step"] == 1


def test_graph_cache_classic_inputs_are_copied():
    lay = _layout(32)
    eng = _graphed(truns.RunsEngine(lay, device="cpu"))
    ref = truns.RunsEngine(lay, device="cpu")
    st, sr = eng.init_state(), ref.init_state()
    p = eng.make_params(CCL, 5300.0)
    rng = np.random.default_rng(32)
    for step in range(4):
        b = batch_from_numpy(_random_batch(rng, lay, n_obs=60_000), "cpu")
        st, a = eng.step(st, b, p)
        sr, r = ref.step(sr, b, p)
        _assert_same(sr, r, st, a, f"step {step}")
        if step:
            (entry,) = eng.graphs.entries.values()
            for k, v in b._asdict().items():
                assert entry.inputs[k].data_ptr() != v.data_ptr()
                assert torch.equal(entry.inputs[k], v), k
    assert eng.graphs.replays["step"] == 3


def test_upload_wire_takes_a_staged_wire_and_its_spec():
    lay = _layout(33)
    eng = _graphed(truns.RunsEngine(lay, device="cpu"))
    b = _random_batch(np.random.default_rng(33), lay, n_obs=60_000)
    wire, spec = eng.pack_wire(b, out=eng.stage)
    dst = eng.upload_wire(wire, spec)
    assert dst is eng.graphs.wires[spec]
    np.testing.assert_array_equal(dst.numpy(), eng.pack_wire(b)[0])
    with pytest.raises(ValueError, match="spec"):
        eng.upload_wire(wire)
    with pytest.raises(ValueError, match="stage buffer"):
        eng.upload_wire(eng.pack_wire(b)[0], spec)


def test_mesh_step_from_numpy_is_its_step():
    lay = _layout(34, nb=2, align=2)
    mesh = tmesh.make_mesh(["cpu"] * 4, barcode_shards=2)
    graphed = _graphed(tmesh.ShardedRunsEngine(lay, mesh))
    plain = tmesh.ShardedRunsEngine(lay, mesh)
    s1, s2 = graphed.init_state(), plain.init_state()
    p = plain.make_params(CCL, 5300.0)
    rng = np.random.default_rng(34)
    for step in range(3):
        b = _random_batch(rng, lay, n_obs=200_000, nb=2)
        s1, a1 = graphed.step_from_numpy(s1, b, p)
        s2, a2 = plain.step(s2, batch_from_numpy(b, "cpu"), p)
        n1, n2 = graphed.state_numpy(s1), plain.state_numpy(s2)
        for k, v in n2.items():
            np.testing.assert_array_equal(n1[k], v, err_msg=f"{k} step {step}")
        assert torch.equal(a1.vec, a2.vec) and torch.equal(a1.threshold, a2.threshold)
    assert graphed.graphs.replays["step"] == 2 and graphed.graphs.eager["step"] == 1


def test_capture_counts_only_its_own_thread(monkeypatch):
    import threading

    from bossruns_torch.ops import kernels as K

    k = K.KERNELS["benefit_strategy"]
    monkeypatch.setattr(k, "_fn", lambda *a: 0)
    K.reset_launches()
    k()
    with K.recording() as rec:
        k()
        k()
        other = threading.Thread(target=k)  # a launch made meanwhile elsewhere
        other.start()
        other.join()
    assert rec == {"benefit_strategy": 2} and K.launches()["benefit_strategy"] == 2
    K.add_launches(rec)  # one replay
    assert K.launches()["benefit_strategy"] == 4
    K.reset_launches()
