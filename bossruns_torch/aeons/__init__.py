"""BOSS-AEONS, the reference-free mode, on PyTorch (the port of
``bossruns_tpu.aeons``).

Ported here: the overlap search (``ava``, seeding kernel H6), the contig
strategies (``benefit``, kernel H7), the initial assembly, the repeat
filter, the live experiment (``core.BossAeons``) and the simulation
(``simulation.BossAeonsSim``). The host state and its algorithms — the
sequence pool, the overlap store and classification, k-mer statistics and
the unitig walk — are copies of the JAX package's host modules at the same
paths, and a checkpoint pickled by either package loads in the other.
"""
