"""tools/torch_kernel_variants.py's table, held to the CUDA sources on the
CPU: each variant of each kernel is a textual edit that must match its
source (csrc/stft_psd.cu, csrc/stft_grad.cu for the radix-2 backward, or
csrc/stft_grad_mixed.cu for the mixed, odd and Bluestein routes'
backward, csrc/hmm.cu for the HMM kernels, csrc/display.cu for the display
backward, csrc/mel.cu for the mel projection) exactly
once (the tool refuses to build one that does not), so a change
to the source that leaves a variant behind shows here and not first on
the card."""

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
    source = os.path.join(tkv.CSRC, f"{tkv.KERNELS[kernel].source}.cu")
    with open(source) as fh:
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
    the pass engine's Rader plans (the mixed route's and the odd route's),
    the GEMM route's small-K tile, the radix-2 route's backward, the
    mixed and odd routes' backward, the Bluestein route's and the GEMM
    route's small-K backward, each on configs of its own routes; and the
    HMM, display backward and mel sets, H2 chunked's, H2's block form's
    and the mel backward's among them."""
    import importlib
    stft_cuda = importlib.import_module("spectral_tpu_torch.ops.stft_cuda")
    from spectral_tpu_torch import SpecConfig
    assert set(tkv.KERNELS) == {"r2", "mixed", "conv", "rader", "small",
                                "grad", "grad_mixed", "grad_bluestein",
                                "grad_small", "hmm", "h2", "display_grad",
                                "mel", "mel_grad", "h2_block"}
    for kern in tkv.KERNELS.values():
        for k in kern.nperseg:
            assert stft_cuda.route(SpecConfig.scipy_default(k)) in kern.routes
        for label, k, _ in kern.paths:
            cfg = (SpecConfig.north_star(k, 256) if label.startswith(
                "path 1 ") else SpecConfig.scipy_default(k))
            assert stft_cuda.route(cfg) in kern.routes


def test_the_hmm_set_names_its_variants_and_groups():
    """The hmm set: the ablations (no_chain, no_scan, no_stats), the
    parent's step (old_step), H1's chains in one warp (one_warp), the
    scan's transfers from global memory (scan_global), and EM_GROUP 1, 4,
    8 and 16, each on csrc/hmm.cu; the ptxas pattern names every HMM
    kernel."""
    import re
    hmm = tkv.KERNELS["hmm"]
    assert hmm.source == "hmm" and not hmm.routes
    assert {"no_chain", "no_scan", "no_stats", "old_step", "one_warp",
            "scan_global"} <= set(hmm.variants)
    assert tkv.HMM_EM_GROUPS == (1, 4, 8, 16)
    with open(os.path.join(tkv.CSRC, "hmm.cu")) as fh:
        src = fh.read()
    kernels = set(re.findall(r"^(\w+_kernel)\(", src, re.M))
    pattern = re.compile(hmm.ptxas[0])
    for name in kernels:
        assert pattern.search(f"_ZN{name}ILi4EE"), name


def test_the_display_grad_and_mel_sets_name_their_kernels():
    """The display_grad set (csrc/display.cu) and the mel set (csrc/mel.cu):
    their ptxas patterns name the display backward's and the mel kernels'
    entries, and each set holds the ablations its PERF.md split reads."""
    import re
    for kernel, source, names, ablations in (
            ("display_grad", "display", ("display_grad_kernelILb1E",
                                         "display_grad_prep_kernel"),
             {"no_math", "no_log10", "no_extrema", "no_fallback"}),
            ("mel", "mel", ("mel_project_kernel", "mel_backward_kernel"),
             {"no_sums", "no_scan"})):
        kern = tkv.KERNELS[kernel]
        assert kern.source == source and not kern.routes
        assert ablations <= set(kern.variants)
        pattern = re.compile(kern.ptxas[0])
        for name in names:
            m = pattern.search(f"_ZN{name}EEEv")
            assert m and kern.ptxas[1](m), name
