"""(e) of test_torch_options.py: the sharded engine under each engine option.

* ``ShardedRunsEngine`` on in-process CPU meshes (1, 2) and (2, 2) equals
  the single engine bit for bit (state, aux, threshold, scores) with
  ``fhat_alpha=1.7``, ``dtype="float64"``, ``benefit_dtype="float32"`` and
  both dtypes at once. The layout puts the shard bounds on the 4096-row
  tiles of the benefit scan (``align_chunks = 4 * Sg``): under the last
  three options that cumsum is not exact, and the single step scans tile
  by tile as a shard does;
* a JAX state with f64 scores carries into the port (single and sharded)
  through models/convert.py, both packages stay equal over two more steps,
  and the port's state loads back into the JAX engine;
* a checkpoint written at one score dtype loads at the other, its read
  starts cast.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bossruns_tpu.models import runs as jruns
from bossruns_torch.models import runs as truns
from bossruns_torch.models.convert import batch_from_numpy, state_from_numpy, state_to_numpy
from bossruns_torch.models.layout import build_layout
from bossruns_torch.parallel import mesh as tmesh
from test_engine_parity import _random_batch

torch.set_num_threads(2)

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
FIELDS = ("coverage", "zeroed", "bucket_on", "read_starts", "strat")
OPTIONS = {
    "alpha": dict(fhat_alpha=1.7),
    "s64": dict(dtype="float64"),
    "d32": dict(benefit_dtype="float32"),
    "s64_d32": dict(dtype="float64", benefit_dtype="float32"),
}


def _layout(seed: int, nb: int, align: int):
    rng = np.random.default_rng(seed)
    return build_layout({"a": rng.integers(0, 4, 160_000).astype(np.uint8),
                         "b": rng.integers(0, 4, 110_000).astype(np.uint8)},
                        n_barcodes=nb, align_chunks=align)


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("Sb,Sg", [(1, 2), (2, 2)])
def test_sharded_engine_equals_single_under_option(option, Sb, Sg):
    nb = 2 if Sb > 1 else 1
    lay = _layout(Sb * 10 + Sg, nb, 4 * Sg)
    cfg = truns.RunsConfig(debug_aux=True, **OPTIONS[option])
    single = truns.RunsEngine(lay, config=cfg, device="cpu")
    sharded = tmesh.ShardedRunsEngine(lay, tmesh.make_mesh(["cpu"] * (Sb * Sg), Sb), config=cfg)
    assert sharded.Gdl % 4096 == 0
    rng = np.random.default_rng(len(option) + Sb)
    s1, s2 = single.init_state(), sharded.init_state()
    params = single.make_params(CCL, 5300.0)
    updated = 0
    for step in range(4):
        b = _random_batch(rng, lay, n_obs=90_000 * nb, nb=nb)
        s1, a1 = single.step(s1, batch_from_numpy(b, "cpu"), params)
        s2, a2 = sharded.step(s2, batch_from_numpy(b, "cpu"), params)
        got = sharded.state_numpy(s2)
        want = state_to_numpy(s1)
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} step {step}")
        assert torch.equal(a2.vec, a1.vec), step
        assert torch.equal(a2.threshold, a1.threshold), step
        assert torch.equal(a2.scores, a1.scores), step
        updated += bool(a1.updated)
    assert updated >= 1


def _jbatch(b):
    return jruns.ReadBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def test_f64_state_carries_across_packages():
    rng = np.random.default_rng(77)
    lay = _layout(4, 2, 4)
    je = jruns.RunsEngine(lay, config=jruns.RunsConfig(dtype="float64"))
    cfg = truns.RunsConfig(dtype="float64")
    single = truns.RunsEngine(lay, config=cfg, device="cpu")
    sharded = tmesh.ShardedRunsEngine(lay, tmesh.make_mesh(["cpu"] * 4, 2), config=cfg)
    batches = [_random_batch(rng, lay, n_obs=80_000, nb=2) for _ in range(4)]
    jp, tp = je.make_params(CCL, 5300.0), single.make_params(CCL, 5300.0)
    js = je.init_state()
    for b in batches[:2]:
        js, _ = je.step(js, _jbatch(b), jp)
    jnp_state = {k: np.asarray(getattr(js, k)) for k in FIELDS}
    assert jnp_state["read_starts"].dtype == np.float64
    assert jnp_state["read_starts"].any()
    s1 = single.state_from_numpy(jnp_state)
    s2 = sharded.state_from_numpy(jnp_state)
    assert s1.read_starts.dtype == torch.float64
    np.testing.assert_array_equal(s1.read_starts.numpy(), jnp_state["read_starts"])
    for b in batches[2:]:
        js, _ = je.step(js, _jbatch(b), jp)
        s1, _ = single.step(s1, batch_from_numpy(b, "cpu"), tp)
        s2, _ = sharded.step(s2, batch_from_numpy(b, "cpu"), tp)
    for got in (state_to_numpy(s1), sharded.state_numpy(s2)):
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)), err_msg=k)
    back = jruns.GenomeState(**{k: jnp.asarray(v) for k, v in state_to_numpy(s1).items()})
    j1, _ = je.step(js, _jbatch(batches[0]), jp)
    j2, _ = je.step(back, _jbatch(batches[0]), jp)
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j2, k)), np.asarray(getattr(j1, k)))


@pytest.mark.parametrize("write,read", [(torch.float32, torch.float64),
                                        (torch.float64, torch.float32)])
def test_checkpoint_loads_at_another_dtype(tmp_path, write, read):
    from bossruns_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    lay = _layout(3, 1, 1)
    names = {torch.float32: "float32", torch.float64: "float64"}
    rng = np.random.default_rng(5)
    eng = truns.RunsEngine(lay, config=truns.RunsConfig(dtype=names[write]), device="cpu")
    state, _ = eng.step(eng.init_state(), batch_from_numpy(
        _random_batch(rng, lay, n_obs=40_000), "cpu"), eng.make_params(CCL, 5300.0))
    save_checkpoint(tmp_path, state, {"batch": 1})
    loaded, host, _ = load_checkpoint(tmp_path, "cpu", dtype=read)
    assert host["batch"] == 1 and loaded.read_starts.dtype == read
    assert torch.equal(loaded.read_starts, state.read_starts.to(read))
    for k in ("coverage", "zeroed", "bucket_on", "strat"):
        assert torch.equal(getattr(loaded, k), getattr(state, k)), k
    other = truns.RunsEngine(lay, config=truns.RunsConfig(dtype=names[read]), device="cpu")
    fields = {k: v for k, v in state_to_numpy(state).items()}
    assert other.state_from_numpy(fields).read_starts.dtype == read
    assert state_from_numpy(fields, "cpu").read_starts.dtype == torch.float32
