"""Aligner counterpart of ``bossruns_tpu.aligner``.

Holds only the jax-free native loader (``native``) until the aligner's
device path is ported. Unlike ``bossruns_tpu/aligner/__init__.py`` this
package imports nothing at its top, so ``from bossruns_torch.aligner import
native`` never pulls in a seeding module.
"""
