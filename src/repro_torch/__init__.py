"""PyTorch/CUDA port of the Aladdin serving system (``repro``).

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it or JAX. Framework-free modules (``configs``, most of
``core``, ``serving.length_predictor``) are verbatim copies of the
reference with only their import statements renamed. The serving path
(``serving.cluster`` -> ``serving.engine`` -> ``models.model``) runs on a
CUDA device through the hand-written Hopper kernels under ``kernels/``.
"""
