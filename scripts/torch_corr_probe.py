#!/usr/bin/env python3
"""What bounds the correlation kernels, on one CUDA card: their time under
variants of ``pathtracker_torch/csrc/correlation.cu``.

    python3 scripts/torch_corr_probe.py [--forward] [variant ...]

Without ``--forward`` the variants patch and time the backward kernels
(``correlation_bwd_f1``, ``correlation_bwd_f2``); with it, the forward
(``correlation_fwd``).

A variant is ``as_is`` or patch names joined by ``+`` (``no_gload+no_store``).
Each patch is a textual substitution in a copy of the file under
``build/corr_probe/`` (the repository's source is not touched; a patch that
no longer matches the file exactly once stops the script). The variants run
in the order given, twice over; each is timed like ``chip_smoke.py`` times a
wrapper call (CUDA graph of calls, replayed, CUDA events) at the rntsm
serving shape (N=504 images of 32x32x64, patch 15) and the train step's
(N=252) on ``chip_smoke.py``'s seeded inputs, and checked against the plain
version where its arithmetic is still the kernel's.

Backward patches:
  th4        4 rows (warps) a block, two blocks an SM
  no_stagger every warp issues its copies before it computes a step
  stages2    two steps in flight (the one computed and one loading)
  fma_one    one multiply-add per (pixel, window column) instead of eight:
             every shared-memory load stays, the arithmetic is an eighth
  no_gload   the cotangent is not read from device memory: its staging is
             zero-filled in shared memory without a load
  no_store   the outputs are not written (a branch the compiler cannot
             prove taken returns before the stores)
  no_gstage  the cotangent is not staged at all (no copies issued)
  no_fstage  the feature rows are not staged (16-byte copies; no copies
             issued)
  no_compute the inner loop is not run (a branch the compiler cannot prove
             never taken)
Without arguments: as_is, no_stagger, th4, stages2, fma_one, no_gload, no_gstage,
no_fstage, no_compute, no_store.

Forward patches:
  direct_store  each lane stores its 15 sums of a step from registers (4 bytes
                every 900) instead of staging 5 steps and writing runs
  ss1, ss3      1 or 3 displacement rows staged before a warp writes them
                (runs of 60 or 180 bytes a pixel), instead of 5
  th4, stages2  as for the backward
  stages4    three steps loading while one is computed
  fma_one    one multiply-add per (pixel, halo column) instead of eight:
             every shared-memory load and shuffle stays
  no_shuffle the reduction over the channel lanes adds the lane's own sums
             instead of its partner's: its selects and adds stay, its
             shuffles go
  no_store   the volume is not written
  no_fstage  the f2 rows are not staged (no copies issued)
  no_compute neither products nor shuffles (a branch the compiler cannot
             prove never taken)
Without arguments: as_is, direct_store, ss1, ss3, th4, stages2, stages4,
fma_one, no_shuffle, no_fstage, no_compute, no_store.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from pathtracker_torch.ops import _native  # noqa: E402
from pathtracker_torch.ops import correlation as Co  # noqa: E402

FILE = "correlation.cu"
FMA8 = '''  a[0] = fmaf(gv, fa.x, a[0]);
  a[1] = fmaf(gv, fa.y, a[1]);
  a[2] = fmaf(gv, fa.z, a[2]);
  a[3] = fmaf(gv, fa.w, a[3]);
  a[4] = fmaf(gv, fb.x, a[4]);
  a[5] = fmaf(gv, fb.y, a[5]);
  a[6] = fmaf(gv, fb.z, a[6]);
  a[7] = fmaf(gv, fb.w, a[7]);
'''
# patch name -> [(old, new)]
PATCHES = {
    "th4": [("constexpr int BTH_MAX = 8;", "constexpr int BTH_MAX = 4;"),
            ("constexpr int BBLOCKS_PER_SM = 1;", "constexpr int BBLOCKS_PER_SM = 2;")],
    "stages2": [("constexpr int BSTAGES = 3;", "constexpr int BSTAGES = 2;")],
    "fma_one": [(FMA8, "  a[0] = fmaf(gv, (fa.x + fa.y) + (fa.z + fa.w) + "
                       "(fb.x + fb.y) + (fb.z + fb.w), a[0]);\n")],
    "no_gload": [("cp_async_16(dst, g + at, true);", "cp_async_16(dst, g + at, false);")],
    "no_store": [("  if (y >= H) return;\n#pragma unroll",
                  "  if (y >= H || W > 0) return;\n#pragma unroll")],
    "no_gstage": [("    if (y >= H || row < 0 || row >= H) return;",
                   "    if (y >= H || row < 0 || row >= H || W > 0) return;")],
    "no_fstage": [("        if (row < 0 || row >= H) continue;\n        cp_async_16(",
                   "        if (row < 0 || row >= H || W > 0) continue;\n        cp_async_16(")],
    "no_compute": [("    if (y < H && row >= 0 && row < H) {\n      accumulate",
                    "    if (y < H && row >= 0 && row < H && W < 0) {\n      accumulate")],
    "no_stagger": [("const bool early = warp < (th + 1) / 2;", "const bool early = true;")],
}
DOT8 = """  s = fmaf(a.x, fa.x, s);
  s = fmaf(a.y, fa.y, s);
  s = fmaf(a.z, fa.z, s);
  s = fmaf(a.w, fa.w, s);
  s = fmaf(b.x, fb.x, s);
  s = fmaf(b.y, fb.y, s);
  s = fmaf(b.z, fb.z, s);
  s = fmaf(b.w, fb.w, s);
"""
FLUSH = "      if (e % FSS == FSS - 1 || e == P - 1) {"
PUT = "          if (dx0 + k < P) put[dx0 + k] = acc[0][k];"
FSTAGE = "      for (int i = tid; i < (hi - lo) * (BCH / per); i += blockDim.x) {"
FORWARD_PATCHES = {
    "direct_store": [(PUT, "          if (dx0 + k < P && y < H && x0 + lane < W)\n"
                           "            out[((n * H + y) * W + x0 + lane) * PP"
                           " + (long long)e * P + dx0 + k] = acc[0][k];"),
                     (FLUSH, "      if (W < 0) {")],
    "ss1": [("constexpr int FSS = 5;", "constexpr int FSS = 1;")],
    "ss3": [("constexpr int FSS = 5;", "constexpr int FSS = 3;")],
    "th4": PATCHES["th4"],
    "stages2": PATCHES["stages2"],
    "stages4": [("constexpr int BSTAGES = 3;", "constexpr int BSTAGES = 4;")],
    "fma_one": [(DOT8, "  s = fmaf((a.x + a.y) + (a.z + a.w) + (b.x + b.y) + (b.z + b.w), "
                       "(fa.x + fa.y) + (fa.z + fa.w) + (fb.x + fb.y) + (fb.z + fb.w), s);\n")],
    "no_shuffle": [("__shfl_xor_sync(0xffffffffu, send, half)", "send")],
    "no_store": [("        if (y < H) {\n          float* dst = out",
                  "        if (y < H && W < 0) {\n          float* dst = out")],
    "no_fstage": [(FSTAGE, FSTAGE.replace("i < (hi", "W < 0 && i < (hi"))],
    "no_compute": [("        if (in) {\n          fwd_products",
                    "        if (in && W < 0) {\n          fwd_products")],
}
# Patches that change what the kernel computes: no comparison with the plain version.
UNCHECKED = {"fma_one", "no_gload", "no_store", "no_gstage", "no_fstage", "no_compute",
             "no_shuffle"}
BACKWARD = (PATCHES, ["as_is", "no_stagger", "th4", "stages2", "fma_one", "no_gload",
                      "no_gstage", "no_fstage", "no_compute", "no_store"],
            ("correlation_bwd_f1", "correlation_bwd_f2"), "corr_bwd")
FORWARD = (FORWARD_PATCHES, ["as_is", "direct_store", "ss1", "ss3", "th4", "stages2", "stages4",
                             "fma_one", "no_shuffle", "no_fstage", "no_compute", "no_store"],
           ("correlation_fwd",), "corr_fwd")


def patched_source(variant: str, text: str, patches: dict) -> str:
    for name in ([] if variant == "as_is" else variant.split("+")):
        for old, new in patches[name]:
            if text.count(old) != 1:
                sys.exit(f"patch {name}: {text.count(old)} matches of {old!r}")
            text = text.replace(old, new)
    return text


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    patches, default, names, prefix = FORWARD if "--forward" in args else BACKWARD
    variants = [a for a in args if a != "--forward"] or default
    print(chip_smoke.card_line(), flush=True)
    shapes = {}
    for n in (chip_smoke.CORR_N, chip_smoke.CORR_TRAIN_N):
        f1, f2, g = chip_smoke.correlation_inputs(Co, n, chip_smoke.SIDE, chip_smoke.SIDE,
                                                  chip_smoke.CORR_C, chip_smoke.PATCH, 3)
        plain = {"correlation_fwd": lambda: Co.correlation_plain(f1, f2, chip_smoke.PATCH),
                 "correlation_bwd_f1": lambda: Co.correlation_bwd_f1_plain(g, f2, chip_smoke.PATCH),
                 "correlation_bwd_f2": lambda: Co.correlation_bwd_f2_plain(g, f1, chip_smoke.PATCH)}
        want = {name: plain[name]() for name in names}
        shapes[n] = (f1, f2, g, want)

    # Every variant's source, built at once (one nvcc each).
    original = (_native.CSRC / FILE).read_text()
    folders = {}
    for variant in variants:
        folders[variant] = folder = _native.BUILD / "corr_probe" / variant
        folder.mkdir(parents=True, exist_ok=True)
        (folder / FILE).write_text(patched_source(variant, original, patches))
    builds = []
    for folder in folders.values():
        _native.CSRC = folder
        lib = _native.library_path("correlation")
        if not lib.exists():
            builds.append((lib, subprocess.Popen(
                [_native._nvcc(), *_native.NVCC_FLAGS, "-o", str(lib), str(folder / FILE)],
                stdout=open(lib.with_suffix(".log"), "w"), stderr=subprocess.STDOUT)))
    for lib, proc in builds:
        if proc.wait() != 0:
            sys.exit(f"nvcc failed: {lib.with_suffix('.log').read_text()}")
    for turn in range(2):
        for variant in variants:
            _native.CSRC = folders[variant]
            _native._libs.clear()
            _native.build(["correlation"])
            checked = not (set(variant.split("+")) & UNCHECKED)
            parts = []
            for n, (f1, f2, g, want) in shapes.items():
                for name in names:
                    wrapper, args = chip_smoke.correlation_call(Co, name, f1, f2, g)
                    got = wrapper(*args, chip_smoke.PATCH, 1)
                    torch.cuda.synchronize()
                    note = "not compared"
                    if checked:
                        err = (got - want[name]).abs().max().item()
                        atol = (chip_smoke.CORR_ATOL_FWD if name == "correlation_fwd"
                                else chip_smoke.CORR_ATOL_BWD)
                        note = f"max_abs_err {err:.3g}, {'held' if err <= atol else 'FAILS'}"
                    t = chip_smoke.correlation_timing(Co, name, f1, f2, g, plain=False)
                    parts.append(f"{name} N={n} {t['ms']:.4f} ms "
                                 f"({t['bound_ms'] / t['ms']:.1%} of bound; {note})")
            if turn == 0:
                parts += [line for line in chip_smoke.resource_lines(
                    _native.build_log("correlation")) if line.startswith(prefix)]
            print(f"{variant}, turn {turn}: " + " | ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
