"""aniportrait_tpu_torch: the PyTorch + CUDA port of ``aniportrait_tpu`` for
one NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``schedulers/``, ``pipelines/``, ``utils/``,
``weights/``, ``factory.py``) and imports no JAX.  Attention kernels that the
JAX package wrote in Pallas are hand-written CUDA kernels here
(``csrc/``, bound in ``ops/kernels/``).
"""

__version__ = "0.1.0"
