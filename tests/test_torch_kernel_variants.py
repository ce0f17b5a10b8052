"""tools/torch_kernel_variants.py's table, held to the CUDA source on the
CPU: each variant of each kernel is a textual edit that must match
csrc/stft_psd.cu exactly once (the tool refuses to build one that does
not), so a change to the source that leaves a variant behind shows here
and not first on the card."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import torch_kernel_variants as tkv  # noqa: E402

VARIANTS = [(kernel, name) for kernel, kern in tkv.KERNELS.items()
            for name in kern.variants]


@pytest.mark.parametrize("kernel,name", VARIANTS)
def test_variant_edits_match_the_source_once(kernel, name):
    with open(tkv.SOURCE) as fh:
        src = fh.read()
    what, edits = tkv.KERNELS[kernel].variants[name]
    assert what and edits
    out = tkv.variant_source(src, edits, name)
    assert out != src
    for old, new in edits:
        assert old != new


def test_variant_source_refuses_a_stale_edit():
    with pytest.raises(SystemExit, match="0 times, not once"):
        tkv.variant_source("int a;", [("int b;", "int c;")])
    with pytest.raises(SystemExit, match="2 times, not once"):
        tkv.variant_source("int a; int a;", [("int a;", "int c;")])


def test_every_kernel_names_its_routes_and_configs():
    """The kernels the table times are the STFT/PSD route's FFT kernels,
    the pass engine's Rader plans (the mixed route's and the odd route's)
    and the GEMM route's small-K tile, each on configs of its own
    routes."""
    import importlib
    stft_cuda = importlib.import_module("spectral_tpu_torch.ops.stft_cuda")
    from spectral_tpu_torch import SpecConfig
    assert set(tkv.KERNELS) == {"r2", "mixed", "conv", "rader", "small"}
    for kern in tkv.KERNELS.values():
        for k in kern.nperseg:
            assert stft_cuda.route(SpecConfig.scipy_default(k)) in kern.routes
        for label, k, _ in kern.paths:
            cfg = (SpecConfig.north_star(k, 256) if label.startswith(
                "path 1 ") else SpecConfig.scipy_default(k))
            assert stft_cuda.route(cfg) in kern.routes
