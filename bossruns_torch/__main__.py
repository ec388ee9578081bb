"""CLI entry point of the port: one TOML, the experiment mode it selects.

    python -m bossruns_torch --toml config.toml [--device cuda|cpu]

The TOML schema is the JAX package's, in the port's copy ``config`` (it
needs pydantic, so it is imported here and nowhere in the library). As there, ``simulation.fq`` selects a simulation and
``general.ref`` selects BOSS-RUNS; without ``general.ref`` the mode is the
reference-free BOSS-AEONS. The port runs all four: the live RUNS
experiment (``models.experiment.BossRuns``), the RUNS simulation
(``models.runs_sim.BossRunsSim``), the live AEONS experiment
(``aeons.core.BossAeons``) and the AEONS simulation
(``aeons.simulation.BossAeonsSim``). ``[tpu] mesh_barcode`` and
``mesh_genome`` shard the RUNS simulation's update step
(``parallel.mesh.ShardedRunsEngine``); the live RUNS experiment and both
AEONS modes ignore them, as in the JAX package. With ``BOSS_COORDINATOR``,
``BOSS_NUM_PROCESSES`` and ``BOSS_PROCESS_ID`` set, each process is one rank
of a ``torch.distributed`` group (``parallel.distributed.init_from_env``,
NCCL on a card, one per rank, gloo on the CPU) and holds one shard.

--device defaults to the CUDA card (``device.require_cuda``, which raises
when there is none); the CPU runs only when asked for.
"""
from __future__ import annotations

import argparse
import logging
import sys

from .device import as_device
from .parallel import distributed

logger = logging.getLogger("boss_torch")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bossruns_torch")
    parser.add_argument("--device", default=None,
                        help="torch device: cuda (default, needs a card) or cpu")
    ns, rest = parser.parse_known_args(argv)
    dev = as_device(distributed.rank_device(ns.device))
    distributed.init_from_env(dev)
    from .config import Config

    args = Config(parse=True, argv=rest).args
    # Config sets up the console and log-file handlers of the JAX package's
    # logger; the port logs under its own name to the same handlers
    src = logging.getLogger("boss_tpu")
    logger.setLevel(src.level)
    for h in src.handlers:
        logger.addHandler(h)
    sim = bool(args.simulation.fq)

    if not args.general.ref:
        if sim:
            from .aeons.simulation import BossAeonsSim

            BossAeonsSim(args, device=dev).run()
            logger.info("simulation finished")
        else:
            from .aeons.core import BossAeons

            BossAeons(args, device=dev).run()
    elif not sim:
        from .models.experiment import BossRuns

        exp = BossRuns(args, device=dev)
        exp.run()
    else:
        from .models.runs_sim import BossRunsSim

        exp = BossRunsSim(
            ref=args.general.ref,
            fq=args.simulation.fq,
            paf_full=args.simulation.paf_full,
            paf_trunc=args.simulation.paf_trunc,
            name=args.general.name,
            batchsize=args.simulation.batchsize,
            maxb=args.simulation.maxb,
            dumptime=args.simulation.dumptime,
            barcodes=args.general.barcodes,
            reject_refs=args.optional.reject_refs,
            ploidy=args.optional.ploidy,
            accept_unmapped=args.simulation.accept_unmapped,
            resume=args.optional.resume,
            mesh_shards=(args.tpu.mesh_barcode, args.tpu.mesh_genome),
            device=dev,
        )
        exp.run()
        logger.info("simulation finished")
    if distributed.is_initialized():
        distributed.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
