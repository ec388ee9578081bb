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
