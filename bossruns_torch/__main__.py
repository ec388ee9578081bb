"""CLI entry point of the port: one TOML, the experiment mode it selects.

    python -m bossruns_torch --toml config.toml [--device cuda|cpu]

The TOML schema is the JAX package's (``bossruns_tpu.config``, which
imports no JAX; it needs pydantic, so it is imported here and nowhere in
the library). As there, ``simulation.fq`` selects a simulation and
``general.ref`` selects BOSS-RUNS; without ``general.ref`` the mode is the
reference-free BOSS-AEONS. The port runs all four: the live RUNS
experiment (``models.experiment.BossRuns``), the RUNS simulation
(``models.runs_sim.BossRunsSim``), the live AEONS experiment
(``aeons.core.BossAeons``) and the AEONS simulation
(``aeons.simulation.BossAeonsSim``). A device mesh (``[tpu] mesh_* != 1``)
raises NotImplementedError.

--device defaults to the CUDA card (``device.require_cuda``, which raises
when there is none); the CPU runs only when asked for.
"""
from __future__ import annotations

import argparse
import logging
import sys

from .device import as_device, require_cuda

logger = logging.getLogger("boss_torch")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bossruns_torch")
    parser.add_argument("--device", default=None,
                        help="torch device: cuda (default, needs a card) or cpu")
    ns, rest = parser.parse_known_args(argv)
    from bossruns_tpu.config import Config

    args = Config(parse=True, argv=rest).args
    # Config sets up the console and log-file handlers of the JAX package's
    # logger; the port logs under its own name to the same handlers
    src = logging.getLogger("boss_tpu")
    logger.setLevel(src.level)
    for h in src.handlers:
        logger.addHandler(h)
    sim = bool(args.simulation.fq)
    if (args.tpu.mesh_barcode, args.tpu.mesh_genome) != (1, 1):
        raise NotImplementedError(
            "[tpu] mesh_* != 1: the multi-GPU engine is ROADMAP Queue 1 item 11")
    dev = as_device(ns.device) if ns.device is not None else require_cuda()

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
            device=dev,
        )
        exp.run()
        logger.info("simulation finished")
    return 0


if __name__ == "__main__":
    sys.exit(main())
