"""Initial assembly of BOSS-AEONS on the port's overlap search.

``walk_unitigs``, the string-graph unitig walk, is the JAX package's
(``bossruns_tpu.aeons.assembly`` is host Python and imports no JAX).
``initial_assembly`` is a copy of that module's, run on the port's
``PoolIndex``/``find_overlaps`` on an explicit device.
"""
from __future__ import annotations

import logging

from bossruns_tpu.aeons.assembly import walk_unitigs
from bossruns_tpu.aeons.pool import LinkStore, SequencePool

from .ava import PoolIndex, find_overlaps, rows_to_records

logger = logging.getLogger("boss_torch")

__all__ = ["initial_assembly", "walk_unitigs"]


def initial_assembly(reads: dict[str, str], min_seq_len: int = 3000,
                     min_votes: int = 4, *, device) -> SequencePool:
    """miniasm-equivalent first assembly from a pile of raw reads: ava ->
    classify -> drop contained -> unitig walk. Only the unitigs survive, as
    with miniasm; leftover reads rejoin through later batches' overlaps."""
    pool = SequencePool(min_len=min_seq_len)
    pool.ingest(reads)
    if pool.is_empty():
        return SequencePool(min_len=min_seq_len)
    store = LinkStore(tetra=False)
    pidx = PoolIndex(pool.seqdict(), device=device)
    rec = rows_to_records(find_overlaps(pool.seqdict(), pidx, min_votes=min_votes, merge=True))
    containments, _ovl = store.load_records(rec, pool)
    contained = pool.increment(containments)
    store.remove_links(contained)
    pool.remove_sequences(contained)
    unitigs, used = walk_unitigs(pool, store, min_seq_len=min_seq_len)
    logger.info(
        f"initial assembly: {len(reads)} reads -> {len(unitigs.sequences)} unitigs"
    )
    return unitigs
