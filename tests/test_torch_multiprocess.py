"""The port's sharded step across two OS processes (gloo on the CPU).

The twin of tests/test_multiprocess.py: two ranks of one torch.distributed
group, joined through BOSS_COORDINATOR / BOSS_NUM_PROCESSES /
BOSS_PROCESS_ID, each holding one genome shard. Started once through the
dry-run entry (``python -m bossruns_torch.parallel dryrun 2``) and once
through the CLI with a mesh TOML; the strategies must be bit-identical to
the in-process mesh of the same shape, and only the primary writes files.
With debug_aux every rank returns the same all-gathered scores.
Every subprocess has a timeout and a free port. Ranks map to cards one to
one; more ranks than cards are refused.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bossruns_torch.parallel import distributed
from bossruns_torch.parallel.mesh import demo_sharded_step, make_mesh
from bossruns_torch.utils.misc import read_strategy_npz

REPO = Path(__file__).resolve().parent.parent
NPROC = 2


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(cmd: list[str], cwd: Path, timeout: int = 300) -> list[str]:
    env = dict(os.environ, BOSS_COORDINATOR=f"127.0.0.1:{_free_port()}",
               BOSS_NUM_PROCESSES=str(NPROC), OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(cmd, cwd=cwd, env=dict(env, BOSS_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(NPROC)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += "\nTIMEOUT"
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed (rc={p.returncode}):\n{out[-3000:]}"
    return outs


def test_offset_cache_sidecar_is_replaced_whole(tmp_path):
    """F11: the ranks of one run scan the same PAF and stamp the same size
    sidecar. A sidecar being written reads as stale (it once raised
    ValueError on an empty file and failed a rank), and a stamp replaces
    the sidecar by a rename (a new inode), never truncating it in place."""
    import os

    from bossruns_torch.io.sampler import _cache_fresh, _stamp_cache, scan_paf_offsets

    paf = tmp_path / "x.paf"
    paf.write_text("".join(f"r{i}\t100\t0\t100\t+\tc\t1000\t0\t100\t100\t100\t60\n"
                           for i in range(50)))
    names, offs, lens = scan_paf_offsets(paf)
    cache = Path(f"{paf}.offsets.npz")
    side = Path(f"{cache}.size")
    assert _cache_fresh(paf, cache)
    side.write_text("")  # what a reader saw between another rank's truncate and write
    assert not _cache_fresh(paf, cache)
    again = scan_paf_offsets(paf)
    np.testing.assert_array_equal(again[1], offs)
    assert list(again[0]) == list(names) and int(side.read_text()) == paf.stat().st_size
    ino = os.stat(side).st_ino
    _stamp_cache(paf, cache)
    assert os.stat(side).st_ino != ino and _cache_fresh(paf, cache)
    assert not list(tmp_path.glob("*.tmp*"))


def test_offset_cache_sidecar_stress(tmp_path):
    """F11 under load: three processes stamp one sidecar while nine check
    the cache, more processes than this machine's cores; every check sees a
    whole sidecar (fresh, never an error)."""
    import multiprocessing as mp

    from proc_torch_cache_stress import check_loop, stamp_loop

    path, cache = tmp_path / "x.paf", tmp_path / "x.paf.offsets.npz"
    path.write_text("x" * 1000)
    cache.write_text("c")
    Path(f"{cache}.size").write_text(str(path.stat().st_size))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=stamp_loop, args=(str(path), str(cache), 1.5)) for _ in range(3)]
    procs += [ctx.Process(target=check_loop, args=(str(path), str(cache), 1.5, q))
              for _ in range(9)]
    for p in procs:
        p.start()
    results = [q.get(timeout=120) for _ in range(9)]
    for p in procs:
        p.join(timeout=60)
    assert not any(p.is_alive() for p in procs)
    assert all(p.exitcode == 0 for p in procs)
    assert all(err is None for _, _, err in results), results
    assert all(stale == 0 for _, stale, _ in results), results
    assert sum(n for n, _, _ in results) > 1000, results


def test_rank_device_one_rank_per_card(monkeypatch):
    monkeypatch.setenv(distributed.ENV_COORD, "127.0.0.1:1")
    monkeypatch.setenv(distributed.ENV_NPROC, "2")
    monkeypatch.setenv(distributed.ENV_PID, "1")
    assert distributed.rank_device("cpu") == torch.device("cpu")
    assert distributed.rank_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.rank_device() == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one rank per card"):
        distributed.rank_device("cuda")


def test_two_process_dryrun_matches_in_process(tmp_path):
    outs = _run_ranks([sys.executable, "-m", "bossruns_torch.parallel", "dryrun", str(NPROC),
                       "--device", "cpu", "--out", str(tmp_path)], cwd=tmp_path)
    lines = [[ln for ln in o.splitlines() if ln.startswith("dryrun_multichip OK")] for o in outs]
    assert all(len(x) == 1 for x in lines) and lines[0] == lines[1], outs
    assert "mesh {'b': 1, 'g': 2}" in lines[0][0]
    eng, state, _ = demo_sharded_step(mesh=make_mesh(["cpu"] * NPROC))
    want = eng.strat_dict(state)
    got = dict(np.load(tmp_path / "strat.npz"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_two_process_debug_scores_match_in_process(tmp_path):
    """debug_aux across two gloo ranks: each rank's StepAux.scores is the
    all-gathered [NB, G_pad] array, the same on both ranks and equal to the
    in-process mesh's."""
    code = (
        "import sys, numpy as np\n"
        "from bossruns_torch.models.runs import RunsConfig\n"
        "from bossruns_torch.parallel import distributed\n"
        "from bossruns_torch.parallel.mesh import demo_sharded_step, process_group_mesh\n"
        "distributed.init_from_env('cpu')\n"
        f"mesh = process_group_mesh(1, {NPROC}, 'cpu')\n"
        "_, _, aux = demo_sharded_step(mesh=mesh, config=RunsConfig(debug_aux=True))\n"
        "np.save(f'scores{distributed.process_index()}.npy', aux.scores.numpy())\n"
        "distributed.close()\n"
    )
    _run_ranks([sys.executable, "-c", code], cwd=tmp_path)
    from bossruns_torch.models.runs import RunsConfig

    eng, _, aux = demo_sharded_step(mesh=make_mesh(["cpu"] * NPROC),
                                    config=RunsConfig(debug_aux=True))
    want = aux.scores.numpy()
    assert want.shape == (1, eng.layout.G_pad) and (want > 0).any()
    for r in range(NPROC):
        np.testing.assert_array_equal(np.load(tmp_path / f"scores{r}.npy"), want, err_msg=str(r))


def test_two_process_f16_matches_in_process(tmp_path):
    """dtype="float16" across two gloo ranks: the gathered state (uint16
    coverage and f16 read starts, which gloo gathers only as bytes: F14),
    aux and gathered f16 scores of the process-group mesh equal the
    in-process mesh's on both ranks."""
    code = (
        "import numpy as np\n"
        "from bossruns_torch.models.runs import RunsConfig\n"
        "from bossruns_torch.parallel import distributed\n"
        "from bossruns_torch.parallel.mesh import demo_sharded_step, process_group_mesh\n"
        "distributed.init_from_env('cpu')\n"
        f"mesh = process_group_mesh(1, {NPROC}, 'cpu')\n"
        "cfg = RunsConfig(debug_aux=True, dtype='float16')\n"
        "eng, state, aux = demo_sharded_step(mesh=mesh, config=cfg)\n"
        "st = eng.state_numpy(state)\n"
        "r = distributed.process_index()\n"
        "np.savez(f'f16_{r}.npz', scores=aux.scores.numpy(), vec=aux.vec.numpy(), **st)\n"
        "distributed.close()\n"
    )
    _run_ranks([sys.executable, "-c", code], cwd=tmp_path)
    from bossruns_torch.models.runs import RunsConfig

    eng, state, aux = demo_sharded_step(mesh=make_mesh(["cpu"] * NPROC),
                                        config=RunsConfig(debug_aux=True, dtype="float16"))
    want = dict(eng.state_numpy(state), scores=aux.scores.numpy(), vec=aux.vec.numpy())
    assert want["read_starts"].dtype == np.float16 and want["scores"].dtype == np.float16
    assert (want["scores"] > 0).any() and want["strat"].any()
    for r in range(NPROC):
        got = np.load(tmp_path / f"f16_{r}.npz")
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{k} rank {r}")


def test_two_process_cli_sim_matches_in_process(tmp_path):
    from bossruns_torch.utils.datagen import write_corpus

    corpus = write_corpus(tmp_path / "corpus", rng=np.random.default_rng(31),
                          contig_lengths={"cA": 200_000, "cB": 120_000}, n_reads=900,
                          mean_len=4000.0)
    toml = tmp_path / "mesh.toml"
    toml.write_text(
        f'[general]\nname = "mp"\nref = "{corpus["ref"]}"\n'
        f'[simulation]\nfq = "{corpus["fq"]}"\npaf_full = "{corpus["paf_full"]}"\n'
        f'paf_trunc = "{corpus["paf_trunc"]}"\nbatchsize = 200\nmaxb = 3\n'
        f'[tpu]\nmesh_genome = {NPROC}\n')
    cmd = [sys.executable, "-m", "bossruns_torch", "--toml", str(toml), "--device", "cpu"]
    mp, sp = tmp_path / "mp", tmp_path / "sp"
    mp.mkdir()
    sp.mkdir()
    _run_ranks(cmd, cwd=mp)
    proc = subprocess.run(cmd, cwd=sp, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = read_strategy_npz(mp / "out_mp" / "masks" / "boss.npz")
    want = read_strategy_npz(sp / "out_mp" / "masks" / "boss.npz")
    assert set(got) == set(want) == {"cA", "cB"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # one writer: no stray tmp files, one metrics line per batch
    assert not list((mp / "out_mp" / "masks").glob("*_tmp*"))
    lines = (mp / "out_mp" / "metrics" / "batches.jsonl").read_text().splitlines()
    ref = (sp / "out_mp" / "metrics" / "batches.jsonl").read_text().splitlines()
    assert len(lines) == len(ref) == 3
    for a, b in zip(lines, ref):
        a, b = json.loads(a), json.loads(b)
        assert (a["time_boss"], a["threshold"], a["n_accepted"]) == (
            b["time_boss"], b["threshold"], b["n_accepted"])
