"""spectral_tpu_torch — the PyTorch / CUDA port of spectral_tpu for NVIDIA Hopper.

The package mirrors ``spectral_tpu``'s module paths, so each ported function
sits under the same name as its JAX counterpart. It imports torch and never
jax; it reuses the JAX-free host modules of ``spectral_tpu`` (``config``,
``core.windows``, ``render.lut``, ``render.png``) so both packages take one
config object and one colormap table.

Importing the package itself loads nothing heavy: torch is imported by the
submodules that need it.
"""

from spectral_tpu.config import SpecConfig

__all__ = ["SpecConfig"]
