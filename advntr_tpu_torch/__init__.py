"""adVNTR-TPU on PyTorch + CUDA: the Illumina genotype path of
``advntr_tpu`` ported to one NVIDIA GPU.

The JAX package ``advntr_tpu`` stays the reference.  This package imports
``torch`` and never ``jax``, and nothing of ``advntr_tpu``: it keeps its
own copy of the host layers it needs (``dna``, ``config``, ``models.*``,
``io.*``, ``engine.{genotype,simulate,coverage_bias}``, ``utils.*``), in
the reference's layout, and owns every module whose reference counterpart
imports jax.  Both Viterbi kernels (fused forward with provenance,
backward origin walk with analytics) are hand-written CUDA C++ under
``csrc/``, built with nvcc at first use.
"""

__version__ = "0.1.0"
