"""BOSS-RUNS adaptive sampling on PyTorch and CUDA (NVIDIA Hopper).

The port of ``bossruns_tpu`` to PyTorch. Module paths mirror the JAX
package, so ``bossruns_torch.models.runs`` is the counterpart of
``bossruns_tpu.models.runs``. Host modules of ``bossruns_tpu`` that import
no JAX (layout, observation model, fastq/sampler, read-length distribution,
checkpoint writer, corpus writer) are imported from there, not copied; a
host module is ported only where importing it would pull in JAX.

The update step's device work runs in four hand-written CUDA kernels under
``csrc/`` and the aligner's seeding in a fifth (built at first use by
``ops.kernels``), each beside a plain PyTorch version that CPU tensors
take. Entry points: ``models.runs_sim.BossRunsSim`` (with precomputed PAFs
or aligning live), ``models.experiment.BossRuns`` (the live experiment),
``live.mapper.TorchMapperPlugin`` (the readfish-side mapper) and
``python -m bossruns_torch --toml ...``. This package never imports JAX.
"""
