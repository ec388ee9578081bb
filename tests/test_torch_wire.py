"""The JAX engine's host-batch wire entry points in the port.

* ``RunsEngine.pack_wire`` / ``pack_gated`` give the JAX package's uint32
  buffer and spec, byte for byte, for the same numpy batch;
* ``unpack_wire`` / ``unpack_gated`` reproduce every field, in the dtypes
  the kernels take (views of the one buffer, each 4-byte aligned);
* ``step_from_numpy`` == ``step`` on the same batch, bit for bit, and the
  gated step from the unpacked wire == the gated step from the dict;
* ``wire_capable``: True on RunsEngine, False on ShardedRunsEngine, as in
  the JAX package; the classic sim and the live experiment take the wire
  where the JAX package does (its own tests hold the sims to JAX's).
"""
import numpy as np
import pytest
import torch

from bossruns_tpu.models import runs as jruns
from bossruns_tpu.models.layout import build_layout
from bossruns_tpu.parallel import mesh as jmesh
from bossruns_torch.models import runs as truns
from bossruns_torch.models.convert import batch_from_numpy, state_to_numpy, tensors_from_numpy
from bossruns_torch.parallel import mesh as tmesh
from test_engine_parity import _random_batch

torch.set_num_threads(2)

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])


def _odd_batch(rng, n: int = 1001) -> dict:
    """Every field of the wire at an odd length, so uint8 and uint16
    fields end off a 4-byte boundary."""
    return dict(
        mr_bc=rng.integers(0, 3, n).astype(np.uint8),
        mr_g=rng.integers(0, 2**32 - 1, n).astype(np.uint32),
        mr_len=rng.integers(0, 65535, n).astype(np.uint16),
        ex_bcsym=rng.integers(0, 65535, n - 4).astype(np.uint16),
        ex_g=rng.integers(0, 2**32 - 1, n - 4).astype(np.uint32),
        rs_row=rng.integers(-2**31, 2**31 - 1, 511).astype(np.int32),
        rs_strand=rng.integers(0, 2, 511).astype(np.int32),
        rs_w=rng.random(511).astype(np.float32),
    )


def _gated_dict(rng) -> dict:
    d = {}
    for pre, n_mr, n_ex in (("f_", 333, 77), ("t_", 129, 5)):
        d[pre + "mr_bc"] = rng.integers(0, 2, n_mr).astype(np.uint8)
        d[pre + "mr_g"] = rng.integers(0, 2**32 - 1, n_mr).astype(np.uint32)
        d[pre + "mr_len"] = rng.integers(0, 65535, n_mr).astype(np.uint16)
        d[pre + "mr_read"] = rng.integers(0, 200, n_mr).astype(np.uint32)
        d[pre + "ex_bcsym"] = rng.integers(0, 10, n_ex).astype(np.uint16)
        d[pre + "ex_g"] = rng.integers(0, 2**32 - 1, n_ex).astype(np.uint32)
        d[pre + "ex_read"] = rng.integers(0, 200, n_ex).astype(np.uint32)
    d["rs_row"] = rng.integers(0, 50, 31).astype(np.int32)
    d["rs_strand"] = rng.integers(0, 2, 31).astype(np.int32)
    d["rs_read"] = rng.integers(-1, 200, 31).astype(np.int32)
    return d


def test_pack_wire_equals_jax():
    rng = np.random.default_rng(1)
    b = _odd_batch(rng)
    for batch in (b, jruns.ReadBatch(**b)):
        want, wspec = jruns.RunsEngine.pack_wire(batch)
        got, gspec = truns.RunsEngine.pack_wire(batch)
        assert got.dtype == np.uint32 and gspec == wspec
        np.testing.assert_array_equal(got, want)


def test_pack_gated_equals_jax():
    d = _gated_dict(np.random.default_rng(2))
    want, wspec = jruns.RunsEngine.pack_gated(d)
    got, gspec = truns.RunsEngine.pack_gated(d)
    assert gspec == wspec
    np.testing.assert_array_equal(got, want)


def test_unpack_wire_reproduces_every_field():
    rng = np.random.default_rng(3)
    b = _odd_batch(rng)
    wire, spec = truns.RunsEngine.pack_wire(b)
    out = truns.RunsEngine.unpack_wire(torch.from_numpy(wire), spec)
    want = batch_from_numpy(b, "cpu")
    for f in truns.ReadBatch._fields:
        t = getattr(out, f)
        assert t.dtype == getattr(want, f).dtype, f          # the kernels' dtypes
        assert t.data_ptr() % 4 == 0, f
        np.testing.assert_array_equal(t.numpy(), b[f], err_msg=f)
    d = _gated_dict(rng)
    wire, spec = truns.RunsEngine.pack_gated(d)
    g = truns.RunsEngine.unpack_gated(torch.from_numpy(wire), spec)
    ref = tensors_from_numpy(d, "cpu")
    assert list(g) == [n for n, _ in truns.RunsEngine._GATED_FIELDS]
    for k, t in g.items():
        assert t.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(t.numpy(), d[k], err_msg=k)


def _layout(seed: int):
    rng = np.random.default_rng(seed)
    return build_layout({"a": rng.integers(0, 4, 150_000).astype(np.uint8),
                         "b": rng.integers(0, 4, 120_000).astype(np.uint8)})


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_step_from_numpy_equals_step(dtype):
    lay = _layout(4)
    cfg = truns.RunsConfig(debug_aux=True, dtype=dtype)
    e1 = truns.RunsEngine(lay, config=cfg, device="cpu")
    e2 = truns.RunsEngine(lay, config=cfg, device="cpu")
    s1, s2 = e1.init_state(), e2.init_state()
    p = e1.make_params(CCL, 5300.0)
    rng = np.random.default_rng(4)
    for step in range(3):
        b = _random_batch(rng, lay, n_obs=120_000)
        s1, a1 = e1.step(s1, batch_from_numpy(b, "cpu"), p)
        s2, a2 = e2.step_from_numpy(s2, b, p)
        for k, v in state_to_numpy(s1).items():
            np.testing.assert_array_equal(state_to_numpy(s2)[k], v, err_msg=f"{k} step {step}")
        assert torch.equal(a1.vec, a2.vec) and torch.equal(a1.threshold, a2.threshold)
        assert torch.equal(a1.scores, a2.scores)
    assert bool(s1.bucket_on.any())


def _gated_from_batch(rng, b: dict, n_reads: int) -> dict:
    """A gated dict whose full family is ``b``'s rows and whose trunc
    family is the first half of them, each row given a read."""
    d = {}
    for pre, sl in (("f_", slice(None)), ("t_", slice(0, None, 2))):
        mr = {k: b[k][sl] for k in ("mr_bc", "mr_g", "mr_len")}
        ex = {k: b[k][sl] for k in ("ex_bcsym", "ex_g")}
        for k, v in {**mr, **ex}.items():
            d[pre + k] = np.ascontiguousarray(v)
        d[pre + "mr_read"] = rng.integers(0, n_reads, mr["mr_g"].shape[0]).astype(np.uint32)
        d[pre + "ex_read"] = rng.integers(0, n_reads, ex["ex_g"].shape[0]).astype(np.uint32)
    n_rs = b["rs_row"].shape[0]
    d.update(rs_row=b["rs_row"], rs_strand=b["rs_strand"],
             rs_read=rng.integers(-1, n_reads, n_rs).astype(np.int32))
    return d


def test_gated_step_from_wire_equals_dict():
    lay = _layout(5)
    cfg = truns.RunsConfig(debug_aux=True)
    e1 = truns.RunsEngine(lay, config=cfg, device="cpu")
    e2 = truns.RunsEngine(lay, config=cfg, device="cpu")
    s1, s2 = e1.init_state(), e2.init_state()
    p = e1.make_params(CCL, 5300.0)
    rng = np.random.default_rng(5)
    for step in range(3):
        d = _gated_from_batch(rng, _random_batch(rng, lay, n_obs=120_000), 300)
        bits = torch.from_numpy((rng.random(300) < 0.6).astype(np.uint8))
        s1, a1 = e1.step_gated(s1, tensors_from_numpy(d, "cpu"), bits, p)
        wire, spec = e2.pack_gated(d)
        s2, a2 = e2.step_gated(s2, e2.unpack_gated(e2.upload_wire(wire), spec), bits, p)
        for k, v in state_to_numpy(s1).items():
            np.testing.assert_array_equal(state_to_numpy(s2)[k], v, err_msg=f"{k} step {step}")
        assert torch.equal(a1.vec, a2.vec) and torch.equal(a1.scores, a2.scores)


def test_wire_capable_flags():
    assert truns.RunsEngine.wire_capable is jruns.RunsEngine.wire_capable is True
    assert tmesh.ShardedRunsEngine.wire_capable is jmesh.ShardedRunsEngine.wire_capable is False


def test_sims_take_the_wire_where_jax_does(corpus, tmp_path, monkeypatch):
    """The classic sim and the gated sim go through step_from_numpy and
    pack_gated on the single engine (and gated == classic still holds,
    tests/test_torch_sim.py)."""
    from bossruns_torch.models.runs_sim import BossRunsSim

    calls = {"step_from_numpy": 0, "pack_gated": 0}

    def counting(name, real):
        def counted(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return counted

    monkeypatch.setattr(truns.RunsEngine, "step_from_numpy",
                        counting("step_from_numpy", truns.RunsEngine.step_from_numpy))
    monkeypatch.setattr(truns.RunsEngine, "pack_gated",
                        staticmethod(counting("pack_gated", truns.RunsEngine.pack_gated)))
    for gated in (False, True):
        sim = BossRunsSim(ref=corpus["ref"], fq=corpus["fq"], paf_full=corpus["paf_full"],
                          paf_trunc=corpus["paf_trunc"], name=f"w{int(gated)}", batchsize=200,
                          maxb=2, out_base=tmp_path / f"w{int(gated)}", gated=gated,
                          device="cpu")
        sim.process_batch()
        sim.process_batch()
        sim.cleanup()
    assert calls["step_from_numpy"] == 2 and calls["pack_gated"] >= 2
