"""microrank_tpu_torch — the PyTorch / CUDA port of microrank_tpu.

The JAX package (``microrank_tpu``) is the reference this package is
held against; this package imports nothing of it, and nothing of JAX or
pandas. It runs the native ``run`` lane — C++ span ingest, fused C++
detection, the C++ graph build, and a per-window PageRank + spectrum
program on torch tensors whose products go through hand-written CUDA
kernels: the coverage pattern pairs of the default ``kernel="auto"``
(kind / packed_bf16, ``csrc/pattern_pair.cu``) and the COO SpMV
(``csrc/coo_spmv.cu``). Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from .config import (
    CompatConfig,
    DetectorConfig,
    MicroRankConfig,
    PageRankConfig,
    RuntimeConfig,
    SpectrumConfig,
    WindowConfig,
)

__all__ = [
    "CompatConfig",
    "DetectorConfig",
    "MicroRankConfig",
    "PageRankConfig",
    "RuntimeConfig",
    "SpectrumConfig",
    "WindowConfig",
]
