"""PyTorch + CUDA port of the Monte Carlo localization filter.

The counterpart of the JAX package `montecarlolocalisation_tpu`, which
stays the reference: plain tensor code is torch, and the filter tick's
kernels (beam weights, systematic expansion, k-means) are hand-written
CUDA C++ for Hopper (csrc/), built at first use.  Configurations are the
JAX package's own dataclasses (montecarlolocalisation_tpu.config, which
imports no JAX), so a config means the same thing in both packages.
"""
from .config import DEFAULT_CONFIG, FilterConfig

__version__ = "0.1.0"
__all__ = ["FilterConfig", "DEFAULT_CONFIG"]
