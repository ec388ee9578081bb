"""BOSS-RUNS adaptive sampling on PyTorch and CUDA (NVIDIA Hopper).

The port of ``bossruns_tpu`` to PyTorch. Module paths mirror the JAX
package, so ``bossruns_torch.models.runs`` is the counterpart of
``bossruns_tpu.models.runs``. The port imports nothing of ``bossruns_tpu``:
the host modules it needs (layout, observation model, fastq/sampler, PAF
records, read-length distribution, checkpoint writer, corpus writer, the
AEONS pool and the config schema) are copies at the mirrored paths.

The update step's device work runs in four hand-written CUDA kernels under
``csrc/`` and the aligner's seeding in a fifth (built at first use by
``ops.kernels``), each beside a plain PyTorch version that CPU tensors
take. Entry points: ``models.runs_sim.BossRunsSim`` (with precomputed PAFs
or aligning live), ``models.experiment.BossRuns`` (the live experiment),
``live.mapper.TorchMapperPlugin`` (the readfish-side mapper),
``parallel.mesh.ShardedRunsEngine`` (the genome- and barcode-sharded
update step over a mesh of devices or processes) and ``python -m
bossruns_torch --toml ...``; ``python -m bossruns_torch.bench`` is the
scoreboard and ``tools`` holds the measuring scripts. This package never
imports JAX.
"""
