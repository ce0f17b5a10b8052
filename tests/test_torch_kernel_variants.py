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
    and the mel backward's among them, and the Bluestein kernel past 8192
    (large_bluestein)."""
    import importlib
    stft_cuda = importlib.import_module("spectral_tpu_torch.ops.stft_cuda")
    from spectral_tpu_torch import SpecConfig
    assert set(tkv.KERNELS) == {"r2", "mixed", "conv", "rader", "small",
                                "grad", "grad_mixed", "grad_bluestein",
                                "grad_small", "hmm", "h2", "display_grad",
                                "mel", "mel_grad", "h2_block",
                                "large_bluestein"}
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
            ("mel", "mel", ("mel_project_kernel", "mel_chunked_kernel",
                            "mel_backward_kernel"),
             {"no_sums", "no_scan"})):
        kern = tkv.KERNELS[kernel]
        assert kern.source == source and not kern.routes
        assert ablations <= set(kern.variants)
        pattern = re.compile(kern.ptxas[0])
        for name in names:
            m = pattern.search(f"_ZN{name}EEEv")
            assert m and kern.ptxas[1](m), name


def test_the_large_bluestein_set_names_its_forms_and_phases():
    """The large_bluestein set: the parent's design (the split by bin
    parity turned off in blue_split alone), the cluster kernel's
    cumulative stops in phase order, each one cut later than the one
    before, the phases named for PERF.md's split; its configs on the
    Bluestein route, the split ones split and the phase ones on four and
    eight ranks; the ptxas pattern names both Bluestein kernels, SPLIT
    included; the mel set's parent and chunked variants."""
    import re
    from spectral_tpu_torch import SpecConfig
    from spectral_tpu_torch.core import stft as tstft
    from spectral_tpu_torch.ops import stft_cuda
    kern = tkv.KERNELS["large_bluestein"]
    assert kern.source == "stft_psd" and kern.routes == ("bluestein",)
    assert set(kern.variants) == {"parent"} | set(
        tkv.LARGE_BLUESTEIN_STOPS[:-1])
    assert tkv.LARGE_BLUESTEIN_STOPS[-1] == "this"
    assert len(tkv.LARGE_BLUESTEIN_PHASES) == len(tkv.LARGE_BLUESTEIN_STOPS)
    parent = kern.variants["parent"][1]
    assert len(parent) == 1 and "blue_split" in parent[0][0]
    # each stop keeps the one before's cut and adds none after it: the
    # cluster kernel returns after its conv_transform (every stop but the
    # last), which the earlier stops cut shorter
    for stop in tkv.LARGE_BLUESTEIN_STOPS[:4]:
        assert tkv.CL_RETURN in kern.variants[stop][1], stop
    for k in tkv.LARGE_SPLIT_PATH + tkv.LARGE_SPLIT_SWEEP:
        assert stft_cuda.route(SpecConfig.scipy_default(k)) == "bluestein"
        assert tstft.bluestein_halves(k) == 2, k
    for k in tkv.LARGE_CLUSTER_PATH:
        assert tstft.bluestein_route_plan(k).ranks in (4, 8), k
    pattern = re.compile(kern.ptxas[0])
    for mangled, label in (
            ("_Z25stft_bluestein_psd_kernelILi2ELb0ELb1ELb1EEvPKf",
             "bluestein<RANKS 2, TWO 0, EXT, SPLIT>"),
            ("_Z33stft_bluestein_cluster_psd_kernelILi8ELb0EEvPKf",
             "cluster<RANKS 8>")):
        assert kern.ptxas[1](pattern.search(mangled)) == label
    mel = tkv.KERNELS["mel"].variants
    assert {"parent", "chunked_everywhere", "chunk64", "chunk256"} <= \
        set(mel)
