"""spectral_tpu_torch — the PyTorch / CUDA port of spectral_tpu for NVIDIA Hopper.

The package mirrors ``spectral_tpu``'s module paths, so each ported function
sits under the same name as its JAX counterpart. It imports torch and never
jax, and nothing of ``spectral_tpu`` either: the host modules it needs
(``config``, ``core/windows.py``, ``render/lut.py``, ``render/png.py``,
``io/wav.py``) are its own copies, held to the JAX package's by the tests.

Importing the package itself loads nothing heavy: torch is imported by the
submodules that need it.
"""

from spectral_tpu_torch.config import SpecConfig

__all__ = ["SpecConfig"]
