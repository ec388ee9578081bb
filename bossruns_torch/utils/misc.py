"""Output helpers of the port: the JAX package's, which are NumPy only.

The strategy npz writer and reader, output directories and run ids are
shared with ``bossruns_tpu.utils.misc``, which imports no JAX, so that both
packages publish ``masks/boss.npz`` in one format.
"""
from bossruns_tpu.utils.misc import (
    make_output_dirs,
    random_id,
    read_strategy_npz,
    write_strategy_npz,
)

__all__ = ["make_output_dirs", "random_id", "read_strategy_npz", "write_strategy_npz"]
