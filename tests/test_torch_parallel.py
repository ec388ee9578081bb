"""The port's sharded update step (K11) against the single engine and JAX.

* ``local_run_indices`` / ``local_ex_indices`` equal the JAX functions'
  uint32 wrap-around semantics on random rows (positions beyond 2^31, runs
  straddling a shard edge, EX_PAD rows, mr_len 0 rows);
* on the in-process CPU mesh at (1, 8), (2, 4) and (1, 2) the sharded engine
  equals the single torch engine bit for bit (state, threshold, aux) and
  JAX's ShardedRunsEngine on the 8 virtual CPU devices in coverage, zeroed,
  bucket_on, read_starts and strat. The threshold is not compared across
  packages: the two packages' f32 scores differ in their last bits (F5),
  so their norms, and with them thresholds, may differ while every
  decision agrees;
* a JAX state carries into the sharded engine and its gathered state back;
* with ``debug_aux`` the sharded engine's gathered scores equal the single
  engine's bit for bit and the JAX ShardedRunsEngine's within the port's
  f32 score tolerance, and the f64 oracle given those scores makes the
  sharded engine's decisions exactly (the test_engine_parity contract);
* ``demo_sharded_step(8, 2)`` gives JAX's demo mask;
* ``BossRunsSim(mesh_shards=(1, 4))`` equals the unsharded classic sim, and
  a sharded checkpoint resumes into either engine.

Every input is made from a generator seeded inside its test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bossruns_torch.io.coo_native import pad_split, split_runs
from bossruns_torch.models.convert import batch_from_numpy
from bossruns_torch.models.layout import build_layout
from bossruns_torch.models.runs import RunsEngine
from bossruns_torch.ops.model import make_model
from bossruns_torch.parallel import mesh as tmesh
from bossruns_torch.utils.misc import read_strategy_npz

torch.set_num_threads(2)

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
FIELDS = ("coverage", "zeroed", "bucket_on", "read_starts", "strat")
EX_PAD = 0xFFFFFFFF


# ------------------------------------------------------------ local indices --

@pytest.mark.parametrize("b0,g0,nb_l,Gl", [
    (0, 0, 2, 5_000),
    (1, 2**31 + 70_000, 1, 100_000),
    (2, 3_000_000_000, 2, 1_000_000),
])
def test_local_indices_match_jax(b0, g0, nb_l, Gl):
    from bossruns_tpu.parallel import mesh as jmesh

    rng = np.random.default_rng(b0 * 7 + nb_l)
    n = 4000
    # positions around the shard: left of it, straddling both edges, inside, right of it
    g = (g0 + rng.integers(-3 * Gl // 2, 5 * Gl // 2, n)).clip(0, 2**32 - 70_000)
    g[:50] = g0 - rng.integers(1, 600, 50)                # runs straddling the left edge
    g[50:100] = g0 + Gl - rng.integers(1, 600, 50)        # and the right edge
    mr_g = g.astype(np.uint32)
    mr_len = rng.integers(0, 65_536, n).astype(np.uint16)
    mr_len[100:200] = 0
    mr_bc = rng.integers(0, 4, n).astype(np.uint8)
    ex_g = mr_g.copy()
    ex_g[200:400] = EX_PAD
    ex_bcsym = (rng.integers(0, 4, n) * 5 + rng.integers(0, 5, n)).astype(np.uint16)

    js, je = jmesh.local_run_indices(jnp.asarray(mr_bc), jnp.asarray(mr_g), jnp.asarray(mr_len),
                                     b0, jnp.uint32(g0), nb_l, Gl)
    ts, te = tmesh.local_run_indices(torch.from_numpy(mr_bc), torch.from_numpy(mr_g),
                                     torch.from_numpy(mr_len), b0, g0, nb_l, Gl)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je).astype(np.int64))
    jx = jmesh.local_ex_indices(jnp.asarray(ex_bcsym), jnp.asarray(ex_g), b0, jnp.uint32(g0),
                                nb_l, Gl)
    tx = tmesh.local_ex_indices(torch.from_numpy(ex_bcsym), torch.from_numpy(ex_g), b0, g0,
                                nb_l, Gl)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx).astype(np.int64))
    # the cases are exercised: rows in the shard, out of it, and dropped pads
    assert 0 < int((ts.numpy() < nb_l * Gl).sum()) < n
    assert (tx.numpy()[200:400] == nb_l * 5 * Gl).all()


# ----------------------------------------------------------------- engines --

def _case(seed: int, nb: int, Sg: int):
    """test_parallel.py's genome (130 kb + 110 kb) and dense batches (768
    runs of 2048 bases, 8% errors incl. deletions), enough for the buckets
    to switch on and the strategy to update within three steps."""
    rng = np.random.default_rng(seed)
    contigs = {"a": rng.integers(0, 4, 130_000).astype(np.uint8),
               "b": rng.integers(0, 4, 110_000).astype(np.uint8)}
    layout = build_layout(contigs, n_barcodes=nb, align_chunks=Sg)
    batches = []
    for _ in range(3):
        n_runs, run_len = 768, 2048
        lens = np.array(list(map(len, contigs.values())))
        cid = rng.integers(0, 2, n_runs)
        rstart = (layout.offsets[cid] + rng.integers(0, lens[cid] - run_len)).astype(np.int64)
        pos = np.concatenate([np.arange(s0, s0 + run_len) for s0 in rstart])
        sym = layout.seq_int[pos].astype(np.int8)
        flip = rng.random(pos.shape[0]) < 0.08
        sym[flip] = rng.integers(0, 5, int(flip.sum()))
        split = split_runs(layout, sym, np.full(pos.shape[0], 40, np.int8), rstart,
                           np.full(n_runs, run_len, np.int32),
                           rng.integers(0, nb, n_runs).astype(np.int32))
        batches.append(dict(pad_split(split),
                            rs_row=rng.integers(0, layout.n_fhat, 512).astype(np.int32),
                            rs_strand=rng.integers(0, 2, 512).astype(np.int32),
                            rs_w=np.ones(512, np.float32)))
    return layout, batches


@pytest.mark.parametrize("Sb,Sg,ploidy,nb", [(1, 8, 1, 1), (2, 4, 2, 2), (1, 2, 2, 1)])
def test_sharded_engine_matches_single_and_jax(Sb, Sg, ploidy, nb):
    from bossruns_tpu.models.runs import ReadBatch as JBatch
    from bossruns_tpu.parallel import mesh as jmesh

    layout, batches = _case(11 + Sg, nb, Sg)
    model = make_model(ploidy=ploidy)
    single = RunsEngine(layout, model, device="cpu")
    sharded = tmesh.ShardedRunsEngine(layout, tmesh.make_mesh(["cpu"] * (Sb * Sg), Sb), model)
    jeng = jmesh.ShardedRunsEngine(layout, jmesh.make_mesh(jax.devices()[: Sb * Sg], Sb), model)
    s1, ss, js = single.init_state(), sharded.init_state(), jeng.init_state()
    params = single.make_params(CCL, 5300.0)
    updated = False
    for i, b in enumerate(batches):
        s1, a1 = single.step(s1, batch_from_numpy(b, "cpu"), params)
        ss, a_s = sharded.step(ss, batch_from_numpy(b, "cpu"), params)
        js, _ = jeng.step(js, jeng.put_batch(JBatch(**{k: jnp.asarray(v) for k, v in b.items()})),
                          jeng.make_params(CCL, 5300.0))
        got, want = sharded.state_numpy(ss), single.state_numpy(s1)
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} vs single, step {i}")
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                          err_msg=f"{k} vs JAX, step {i}")
        assert float(a_s.threshold) == float(a1.threshold), i
        assert torch.equal(a_s.vec, a1.vec), (i, a_s.vec, a1.vec)
        updated |= bool(sharded.pull_aux(a_s).updated)
    assert updated, "the strategy never updated: the case does not reach the decisions"
    strat = sharded.strat_dict(ss)
    assert all(np.array_equal(strat[k], v) for k, v in single.strat_dict(s1).items())


@pytest.mark.parametrize("Sb,Sg,ploidy", [(1, 2, 1), (1, 2, 2), (2, 2, 1), (2, 2, 2)])
def test_sharded_scores_match_single_jax_and_oracle(Sb, Sg, ploidy):
    """debug_aux on the sharded engine: its [NB, G_pad] post-mask scores
    equal the single engine's bit for bit and JAX's sharded engine's within
    rtol 1e-5 / atol 5e-5 (the two f32 closed forms, F5); given them, the
    f64 oracle's coverage, bucket_on, read_starts and strat equal the
    sharded engine's exactly, and its threshold within 1e-12."""
    from bossruns_tpu import oracle
    from bossruns_tpu.models.runs import ReadBatch as JBatch
    from bossruns_tpu.models.runs import RunsConfig as JConfig
    from bossruns_tpu.parallel import mesh as jmesh
    from bossruns_torch.models.runs import RunsConfig

    nb = 2 if Sb > 1 else 1
    layout, batches = _case(31 + 2 * Sb + ploidy, nb, Sg)
    model = make_model(ploidy=ploidy)
    cfg = RunsConfig(debug_aux=True)
    single = RunsEngine(layout, model, cfg, device="cpu")
    sharded = tmesh.ShardedRunsEngine(layout, tmesh.make_mesh(["cpu"] * (Sb * Sg), Sb), model,
                                      cfg)
    jeng = jmesh.ShardedRunsEngine(layout, jmesh.make_mesh(jax.devices()[: Sb * Sg], Sb), model,
                                   JConfig(debug_aux=True))
    s1, ss, js = single.init_state(), sharded.init_state(), jeng.init_state()
    st_np = sharded.state_numpy(ss)
    st_np["read_starts"] = st_np["read_starts"].astype(np.float64)
    params = single.make_params(CCL, 5300.0)
    updated = 0
    for i, b in enumerate(batches):
        s1, a1 = single.step(s1, batch_from_numpy(b, "cpu"), params)
        ss, a_s = sharded.step(ss, batch_from_numpy(b, "cpu"), params)
        js, ja = jeng.step(js, jeng.put_batch(JBatch(**{k: jnp.asarray(v) for k, v in b.items()})),
                           jeng.make_params(CCL, 5300.0))
        assert a_s.scores.shape == (layout.n_barcodes, layout.G_pad)
        assert torch.equal(a_s.scores, a1.scores), i
        np.testing.assert_allclose(a_s.scores.numpy(), np.asarray(ja.scores), rtol=1e-5,
                                   atol=5e-5, err_msg=f"vs JAX, step {i}")
        st_np, aux_o = oracle.full_update(sharded, st_np, b, CCL, 5300.0,
                                          scores_override=a_s.scores.numpy())
        got = sharded.state_numpy(ss)
        assert bool(a_s.any_on) == aux_o["any_on"], i
        assert bool(a_s.updated) == aux_o["updated"], i
        for k in ("coverage", "bucket_on", "strat"):
            np.testing.assert_array_equal(got[k], st_np[k], err_msg=f"{k} vs oracle, step {i}")
        np.testing.assert_array_equal(got["read_starts"].astype(np.float64), st_np["read_starts"])
        if aux_o["updated"]:
            updated += 1
            np.testing.assert_allclose(float(a_s.threshold), aux_o["threshold"], rtol=1e-12)
    assert updated >= 1
    # the scores are the post-dropout ones: every zeroed site scores 0
    zeroed = torch.from_numpy(got["zeroed"])
    assert bool(zeroed.any()) and not bool(a_s.scores[zeroed].any())


def test_state_carries_across_packages():
    """A JAX GenomeState (as numpy) loads into the sharded engine; two more
    steps in each package agree; the gathered state loads back into JAX."""
    from bossruns_tpu.models.runs import GenomeState as JState
    from bossruns_tpu.models.runs import ReadBatch as JBatch
    from bossruns_tpu.models.runs import RunsEngine as JEngine

    layout, batches = _case(5, 2, 4)
    jeng = JEngine(layout)
    sharded = tmesh.ShardedRunsEngine(layout, tmesh.make_mesh(["cpu"] * 4, 2))
    jb = [JBatch(**{k: jnp.asarray(v) for k, v in b.items()}) for b in batches]
    jp = jeng.make_params(CCL, 5300.0)
    js = jeng.init_state()
    js, _ = jeng.step(js, jb[0], jp)
    ss = sharded.state_from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS})
    for i in (1, 2):
        js, _ = jeng.step(js, jb[i], jp)
        ss, _ = sharded.step(ss, batch_from_numpy(batches[i], "cpu"),
                             sharded.make_params(CCL, 5300.0))
    got = sharded.state_numpy(ss)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)), err_msg=k)
    back = JState(**{k: jnp.asarray(v) for k, v in got.items()})
    j2, _ = jeng.step(back, jb[0], jp)
    j1, _ = jeng.step(js, jb[0], jp)
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j2, k)), np.asarray(getattr(j1, k)))


def test_demo_matches_jax():
    from bossruns_tpu.parallel import mesh as jmesh

    eng, state, aux = tmesh.demo_sharded_step(8, 2)
    jeng, jstate, jaux = jmesh.demo_sharded_step(n_devices=8, barcode_shards=2)
    assert eng.mesh.shape == dict(jeng.mesh.shape) == {"b": 2, "g": 4}
    got, want = eng.strat_dict(state), jeng.strat_dict(jstate)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    total = sum(m.size for m in got.values())
    frac = sum(int(m.sum()) for m in got.values()) / total
    assert round(frac, 3) == 0.444  # JAX's dry run (MULTICHIP_r05.json)
    assert eng.pull_aux(aux).any_on and bool(jaux.any_on)


# -------------------------------------------------------------- simulation --

@pytest.fixture(scope="module")
def mesh_corpus(tmp_path_factory):
    """Two contigs of 3 and 1 chunks (4 in all), so the unsharded layout and
    those of meshes with 2 or 4 genome shards have the same padding."""
    from bossruns_torch.utils.datagen import write_corpus

    return write_corpus(tmp_path_factory.mktemp("mesh_corpus"), rng=np.random.default_rng(23),
                        contig_lengths={"cA": 300_000, "cB": 100_000}, n_reads=900,
                        mean_len=5000.0)


def _sim(corpus, base, name="m", **kw):
    from bossruns_torch.models.runs_sim import BossRunsSim

    return BossRunsSim(ref=corpus["ref"], fq=corpus["fq"], paf_full=corpus["paf_full"],
                       paf_trunc=corpus["paf_trunc"], name=name, batchsize=150, maxb=3,
                       out_base=base, device="cpu", **kw)


def test_sim_with_mesh_matches_unsharded(mesh_corpus, tmp_path):
    sharded = _sim(mesh_corpus, tmp_path / "s", mesh_shards=(1, 4))
    plain = _sim(mesh_corpus, tmp_path / "p", gated=False)
    assert isinstance(sharded.engine, tmesh.ShardedRunsEngine) and not sharded._gated
    with pytest.raises(ValueError, match="classic flow"):
        _sim(mesh_corpus, tmp_path / "g", mesh_shards=(1, 4), gated=True)
    for i in range(3):
        sharded.process_batch()
        plain.process_batch()
        assert sharded._last_decisions == plain._last_decisions, i
        assert (sharded.read_cache.time_boss, sharded.read_cache.time_control) == (
            plain.read_cache.time_boss, plain.read_cache.time_control), i
        got, want = sharded.engine.state_numpy(sharded.state), plain.engine.state_numpy(plain.state)
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k}, batch {i}")
    masks = [read_strategy_npz(s.out_dir / "masks" / "boss.npz") for s in (sharded, plain)]
    assert set(masks[0]) == set(masks[1])
    for k in masks[1]:
        np.testing.assert_array_equal(masks[0][k], masks[1][k], err_msg=k)
    assert bool(plain.state.bucket_on.any())
    sharded.cleanup()
    plain.cleanup()


@pytest.mark.parametrize("resume_mesh", [(1, 1), (1, 2)])
def test_sharded_checkpoint_resumes_into_either_engine(mesh_corpus, tmp_path, resume_mesh):
    ref = _sim(mesh_corpus, tmp_path / "ref", gated=False)
    for _ in range(3):
        ref.process_batch()
    first = _sim(mesh_corpus, tmp_path, mesh_shards=(1, 4))
    first.checkpoint_every = 1
    for _ in range(2):
        first.process_batch()
    first.cleanup()
    second = _sim(mesh_corpus, tmp_path, mesh_shards=resume_mesh, resume=True, gated=False)
    assert second.batch == 2
    second.process_batch()
    got, want = second.engine.state_numpy(second.state), ref.engine.state_numpy(ref.state)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (second.read_cache.time_boss, second.read_cache.time_control) == (
        ref.read_cache.time_boss, ref.read_cache.time_control)
    ref.cleanup()
    second.cleanup()
