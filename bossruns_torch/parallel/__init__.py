"""Sharding of the RUNS update step over a mesh of devices or processes
(``mesh``) and the ``torch.distributed`` plumbing (``distributed``); the
port of ``bossruns_tpu.parallel``. ``python -m bossruns_torch.parallel
dryrun N`` runs the sharded step on a small genome."""
