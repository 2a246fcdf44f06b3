#!/usr/bin/env python3
"""What bounds the correlation backward kernels (``correlation_bwd_f1``,
``correlation_bwd_f2``), on one CUDA card: their time under variants of
``pathtracker_torch/csrc/correlation.cu``.

    python3 scripts/torch_corr_probe.py [variant ...]

A variant is ``as_is`` or patch names joined by ``+`` (``no_gload+no_store``).
Each patch is a textual substitution in a copy of the file under
``build/corr_probe/`` (the repository's source is not touched; a patch that
no longer matches the file exactly once stops the script). The variants run
in the order given, twice over; each is timed like ``chip_smoke.py`` times a
wrapper call (CUDA graph of calls, replayed, CUDA events) at the rntsm
serving shape (N=504 images of 32x32x64, patch 15) and the train step's
(N=252) on ``chip_smoke.py``'s seeded inputs, and checked against the plain
version where its arithmetic is still the kernel's.

Patches:
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
"""

from __future__ import annotations

import os
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
# Patches that change what the kernel computes: no comparison with the plain version.
UNCHECKED = {"fma_one", "no_gload", "no_store", "no_gstage", "no_fstage", "no_compute"}
DEFAULT = ["as_is", "no_stagger", "th4", "stages2", "fma_one", "no_gload", "no_gstage",
           "no_fstage", "no_compute", "no_store"]
NAMES = ("correlation_bwd_f1", "correlation_bwd_f2")


def patched_source(variant: str, text: str) -> str:
    for name in ([] if variant == "as_is" else variant.split("+")):
        for old, new in PATCHES[name]:
            if text.count(old) != 1:
                sys.exit(f"patch {name}: {text.count(old)} matches of {old!r}")
            text = text.replace(old, new)
    return text


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    variants = sys.argv[1:] or DEFAULT
    print(chip_smoke.card_line(), flush=True)
    shapes = {}
    for n in (chip_smoke.CORR_N, chip_smoke.CORR_TRAIN_N):
        f1, f2, g = chip_smoke.correlation_inputs(Co, n, chip_smoke.SIDE, chip_smoke.SIDE,
                                                  chip_smoke.CORR_C, chip_smoke.PATCH, 3)
        want = {name: Co.correlation_bwd_f1_plain(g, f2, chip_smoke.PATCH)
                if name == "correlation_bwd_f1"
                else Co.correlation_bwd_f2_plain(g, f1, chip_smoke.PATCH) for name in NAMES}
        shapes[n] = (f1, f2, g, want)

    original = (_native.CSRC / FILE).read_text()
    for turn in range(2):
        for variant in variants:
            folder = _native.BUILD / "corr_probe" / variant
            folder.mkdir(parents=True, exist_ok=True)
            (folder / FILE).write_text(patched_source(variant, original))
            _native.CSRC = folder
            _native._libs.clear()
            _native.build(["correlation"])
            checked = not (set(variant.split("+")) & UNCHECKED)
            parts = []
            for n, (f1, f2, g, want) in shapes.items():
                for name in NAMES:
                    wrapper, args = chip_smoke.correlation_call(Co, name, f1, f2, g)
                    got = wrapper(*args, chip_smoke.PATCH, 1)
                    torch.cuda.synchronize()
                    note = "not compared"
                    if checked:
                        err = (got - want[name]).abs().max().item()
                        note = (f"max_abs_err {err:.3g}, "
                                f"{'held' if err <= chip_smoke.CORR_ATOL_BWD else 'FAILS'}")
                    t = chip_smoke.correlation_timing(Co, name, f1, f2, g, plain=False)
                    parts.append(f"{name} N={n} {t['ms']:.4f} ms "
                                 f"({t['bound_ms'] / t['ms']:.1%} of bound; {note})")
            if turn == 0:
                parts += [line for line in chip_smoke.resource_lines(
                    _native.build_log("correlation")) if line.startswith("corr_bwd")]
            print(f"{variant}, turn {turn}: " + " | ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
