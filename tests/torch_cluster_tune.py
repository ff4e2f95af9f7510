"""Tuning record of the NN sweeps' cluster split, on the card.

    python3 tests/torch_cluster_tune.py        (an NVIDIA GPU and nvcc)

Not a test: a measuring script for ``PERF.md``. It launches
``csrc/nn_kernel.cu`` through its C entry, replayed from a CUDA graph (no
host time), and prints microseconds a launch:

1. ``[span]`` lines: cluster size S x chunk length (``span``) x fill of dst
   (a random 0.9 mask, valid prefixes of 10-100%) at the ICP loop's shapes,
   for the elementwise and the sentinel form. They show what
   ``nn_kernel.launch_plan`` and ``nn_kernel.cluster_span`` were set from.
2. ``[parts]`` lines: where a cluster launch's time goes. The source is
   built three more times with one piece cut out (by text substitution,
   which fails loudly if the source has moved on): ``nosweep`` stages dst
   and merges but skips the candidates, ``nomerge`` skips the cluster
   barriers and the merge, ``nocluster`` is ``nomerge`` launched without
   the cluster attribute. Their results are wrong on purpose; only their
   time is read. The matcher's index-output sweeps (7 x 4096 x 4096 and
   14 x 1024 x 4096, at the cluster size ``launch_plan`` gives them) get
   the same ``[parts]`` lines.
"""

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from icpflow_tpu_torch.ops.cuda import library, nn_kernel  # noqa: E402

SHAPES = ((7, 1024, 4096), (1, 1024, 4096), (14, 256, 4096), (4, 512, 512))
FORMS = ("elementwise", "sentinel")
INDEX_SHAPES = ((7, 4096, 4096), (14, 1024, 4096), (8, 512, 512))
CUTS = {
    "nosweep": [("    __syncthreads();\n    // groups of kGroup candidates",
                 "    __syncthreads();\n    if (kMode == kCluster) continue;"
                 "\n    // groups of kGroup candidates")],
    "nomerge": [("    if (sweep) {\n      __shared__ int2 mine",
                 "    if (false) {\n      __shared__ int2 mine")],
}
CUTS["nocluster"] = CUTS["nomerge"] + [
    ("    config.numAttrs = 1;", "    config.numAttrs = 0;"),
    ("    const unsigned rank = cluster.block_rank();",
     "    const unsigned rank = blockIdx.z;")]


def build_cuts():
    """The library and its three cut-down builds, compiled side by side."""
    source = (library.CSRC / "nn_kernel.cu").read_text()
    library.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in CUTS.items():
        text = source
        for old, new in cuts:
            assert text.count(old) == 1, f"{name}: the source has moved on"
            text = text.replace(old, new)
        cu = library.BUILD_DIR / f"tune_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [library.find_nvcc(), *library.NVCC_FLAGS[:-2], "-o",
             str(cu.with_suffix(".so")), str(cu)])
    libs = {"whole": library.load()}
    for name, proc in procs.items():
        assert proc.wait() == 0, f"nvcc failed on the {name} build"
        libs[name] = ctypes.CDLL(str(library.BUILD_DIR / f"tune_{name}.so"))
    for lib in libs.values():
        lib.icpflow_masked_nn.argtypes = nn_kernel.ARGTYPES
        lib.icpflow_masked_nn.restype = ctypes.c_int
    return libs


def replay_us(lib, form, s, d, mk, slices, span, points=True):
    """Microseconds a launch of one sweep, graph-replayed."""
    b, n, m = s.shape[0], s.shape[1], d.shape[1]
    out = torch.empty((b, n, 3), device="cuda") if points else torch.empty(
        (b, n), dtype=torch.int32, device="cuda")
    dist = torch.empty((b, n), device="cuda")

    def launch():
        err = lib.icpflow_masked_nn(
            s.data_ptr(), d.data_ptr(), mk.data_ptr(), None, b, n, m,
            nn_kernel.FORMS.index(form), int(points),
            nn_kernel.SPLITS.index("cluster" if slices > 1 else "none"),
            slices, span, out.data_ptr(), dist.data_ptr(), None,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"cudaError {err}"

    return chip_smoke._device_ms(launch, iters=50) * 1e3


def main():
    card = chip_smoke.phase_environment()
    libs = build_cuts()
    for shape in SHAPES:
        b, n, m = shape
        src, dst, mask = chip_smoke._inputs(*shape, 200)
        s, d, mk = (torch.as_tensor(a, device="cuda")
                    for a in (src, dst, mask))
        fills = {"random 0.9": mk}
        for share in (0.1, 0.25, 0.5, 0.83, 1.0):
            fills[f"prefix {share}"] = torch.as_tensor(
                np.tile(np.arange(m) < int(share * m), (b, 1)), device="cuda")
        spans = (512, 256, 128, 64) if m > 512 else (None,)
        for form in FORMS:
            for fill, valid in fills.items():
                if form == "sentinel" and fill not in ("random 0.9",
                                                       "prefix 0.5"):
                    continue            # the sentinel form skips no padding
                one = replay_us(libs["whole"], form, s, d, valid, 1, 512)
                line = f"S=1 {one:.1f}"
                for slices in (2, 4, 8):
                    for span in spans:
                        span = span or nn_kernel.cluster_span(m, slices)
                        us = replay_us(libs["whole"], form, s, d, valid,
                                       slices, span)
                        line += f" | S={slices}/{span} {us:.1f}"
                print(f"[span] {form} {shape} {fill}: {line} us | {card}",
                      flush=True)
        slices = nn_kernel.launch_plan(b, n, m, "elementwise", True, 132)
        span = nn_kernel.cluster_span(m, slices)
        for form in FORMS:
            line = " ".join(
                f"{name} {replay_us(lib, form, s, d, mk, slices, span):.2f}"
                for name, lib in libs.items())
            print(f"[parts] {form} {shape} random 0.9 S={slices}/{span}: "
                  f"{line} us | {card}", flush=True)
    for shape in INDEX_SHAPES:
        b, n, m = shape
        src, dst, mask = chip_smoke._inputs(*shape, 200)
        s, d, mk = (torch.as_tensor(a, device="cuda")
                    for a in (src, dst, mask))
        slices = nn_kernel.launch_plan(b, n, m, "elementwise", False, 132)
        span = nn_kernel.cluster_span(m, slices)
        for form in FORMS + ("expanded",):
            one = replay_us(libs["whole"], form, s, d, mk, 1, 512, False)
            line = " ".join(
                f"{name} "
                f"{replay_us(lib, form, s, d, mk, slices, span, False):.2f}"
                for name, lib in libs.items())
            print(f"[parts] {form} index {shape} random 0.9 S=1 {one:.2f} "
                  f"S={slices}/{span}: {line} us | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
