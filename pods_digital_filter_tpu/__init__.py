"""pods_digital_filter_tpu — turbulence-inlet generation + PODFS compression
on an accelerator (an NVIDIA GPU; the CPU for tests).

A from-scratch JAX/XLA framework with the capabilities of the reference
``sidbannet/PODS-digital-filter`` pipeline (Klein-2003 digital-filter synthetic
turbulence + snapshot-POD/Fourier-series "PODFS" compression), re-designed for
batched device execution:

* the reference's sequential rolling-noise-buffer time loop
  (``digitalfilters.py:1403-1481``) is reformulated as a fully parallel
  noise -> batched separable 2-D filter (GEMMs) -> causal temporal FIR
  chain — every time window is independently computable (stateless
  counter-indexed PRNG), which is what makes generation shardable over a
  device mesh with zero halo communication for the noise;
* snapshot POD (``PODFS.py:1294-1393``) uses a symmetric eigendecomposition of
  the Gram matrix, with the Gram product sharded over plane tiles and reduced
  with ``psum``;
* the O(Ns^2) direct DFT Fourier compression (``PODFS.py:1562-1573``) becomes
  one batched FFT;
* all file formats (``PODFS.dat``, ``.prf``, ``.hdf5``) are byte-level
  compatible with the reference (``docs/usage/CFDCodeIntegration.rst:26-74``).
"""

__version__ = "0.2.0"

PROG = "pods-digital-filter-tpu"

from pods_digital_filter_tpu.config import (  # noqa: F401
    FilterConfig,
    PlaneConfig,
    PODFSConfig,
    PipelineConfig,
)
