#!/usr/bin/env python3
"""What bounds the K2 and K3 backward kernels, on one CUDA card: their time
under variants of ``pathtracker_torch/csrc/int_cell_bwd.cu``.

    python3 scripts/torch_bwd_probe.py [variant ...]

A variant is ``as_is`` or patch names joined by ``+`` (``no_math+no_store``).
Each patch is a textual substitution in a copy of the source under
``build/probe/`` (the repository's source is not touched; a patch that no
longer matches the source exactly once stops the script). The variants run
in the order given, twice over, each timed like ``chip_smoke.py`` times a
wrapper call (CUDA graph of 20 calls, replayed, CUDA events) at 131,072 x 32
on ``chip_smoke.py``'s seeded inputs, and checked against the plain version
where its arithmetic is still the kernel's. First it prints what the card
streams: a copy and an add of 128 MB f32 arrays through PyTorch.

Patches:
  no_math      softplus, sigmoid replaced by x and 0.5: no transcendentals
  no_store     the staged outputs are not copied out to device memory
  no_load      every row is zero-filled in shared memory instead of loaded
  math_apiece  each softplus and sigmoid with its own expf and an IEEE
               quotient, as the kernels this design replaced computed them
  math_fast    __expf and __logf for expf and log1pf
  k2_stages3, k3_7x3, k2_12warps, k3_10warps   other ring shapes
Without arguments: as_is, the three math variants, the two one-sided
memory floors and the ring shapes.
"""

from __future__ import annotations

import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from pathtracker_torch.ops import _native  # noqa: E402
from pathtracker_torch.ops import int_fused as F  # noqa: E402

SHARED = '''  const float e = expf(-fabsf(x));
  sp = fmaxf(x, 0.0f) + log1pf(e);
  sg = __fdividef(x >= 0.0f ? 1.0f : e, 1.0f + e);
'''
GATE = "  return __fdividef(1.0f, 1.0f + expf(-x));\n"
PATCHES = {
    "no_math": [(SHARED, "  sp = x;\n  sg = 0.5f;\n"),
                (GATE, "  return 0.5f + 1e-3f * x;\n")],
    "no_store": [("    if (row0 + r < rows)\n      *reinterpret_cast<uint4*>(base",
                  "    if (row0 + r < rows && rows < 0)\n      *reinterpret_cast<uint4*>(base")],
    "no_load": [("    const bool in = row0 + r < rows;\n    cp_async_16(",
                 "    const bool in = false;\n    cp_async_16(")],
    "math_apiece": [(SHARED, "  sp = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));\n"
                             "  sg = 1.0f / (1.0f + expf(-x));\n"),
                    (GATE, "  return 1.0f / (1.0f + expf(-x));\n")],
    "math_fast": [(SHARED, "  const float e = __expf(-fabsf(x));\n"
                           "  sp = fmaxf(x, 0.0f) + __logf(1.0f + e);\n"
                           "  sg = __fdividef(x >= 0.0f ? 1.0f : e, 1.0f + e);\n"),
                  (GATE, "  return __fdividef(1.0f, 1.0f + __expf(-x));\n")],
    "k2_stages3": [("K2_WARPS = 8, K2_STAGES = 2;", "K2_WARPS = 8, K2_STAGES = 3;")],
    "k3_7x3": [("K3_WARPS = 8, K3_STAGES = 2;", "K3_WARPS = 7, K3_STAGES = 3;")],
    "k2_12warps": [("K2_WARPS = 8, K2_STAGES = 2;", "K2_WARPS = 12, K2_STAGES = 2;")],
    "k3_10warps": [("K3_WARPS = 8, K3_STAGES = 2;", "K3_WARPS = 10, K3_STAGES = 2;")],
}
# Patches that change what the kernel computes: no comparison with the plain version.
UNCHECKED = {"no_math", "no_store", "no_load"}
DEFAULT = ["as_is", "math_apiece", "math_fast", "no_math", "no_math+no_store",
           "no_math+no_load", "no_store", "k2_stages3", "k3_7x3", "k2_12warps",
           "k3_10warps"]


def patched_source(variant: str, source: str) -> str:
    for name in ([] if variant == "as_is" else variant.split("+")):
        for old, new in PATCHES[name]:
            if source.count(old) != 1:
                sys.exit(f"patch {name}: {source.count(old)} matches of {old!r}")
            source = source.replace(old, new)
    return source


def streaming_yardstick(dev) -> None:
    n = 32 * 1024 * 1024
    a, b = torch.randn(n, device=dev), torch.randn(n, device=dev)
    c = torch.empty(n, device=dev)
    for label, fn, nbytes in (("copy c = a", lambda: c.copy_(a), 8 * n),
                              ("add c = a + b", lambda: torch.add(a, b, out=c), 12 * n)):
        ms = chip_smoke.device_ms(fn, calls=5, replays=4)
        print(f"card streams, {label} ({nbytes / 1e6:.0f} MB moved): {ms * 1e3:.1f} us, "
              f"{nbytes / ms / 1e9:.3f} TB/s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    variants = sys.argv[1:] or DEFAULT
    dev = torch.device("cuda")
    print(chip_smoke.card_line(), flush=True)
    streaming_yardstick(dev)

    d = chip_smoke.kernel_inputs(torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    shape = (chip_smoke.ROWS, chip_smoke.C)
    for _ in range(2):  # chip_smoke draws dgated and datt before dnew
        torch.randn(shape, generator=gen, device=dev)
    dnew = torch.randn(shape, generator=gen, device=dev)
    k2 = ("conv_i", "mean0", "rstd0", "scale0", "bias0", "inp", "gi_x", "inh",
          "i_u", "i_u_b", "alpha", "mu")
    k3 = ("conv_e", "mean1", "rstd1", "scale1", "bias1", "new_inh", "inh", "gated",
          "exc", "e_w", "e_w_b", "e_u", "e_u_b", "kappa", "gamma")
    cases = [("k2_inhibition_bwd", F.k2_inhibition_bwd, [d[k] for k in k2] + [dnew]),
             ("k3_excitation_bwd", F.k3_excitation_bwd, [d[k] for k in k3] + [dnew])]
    wants = {"k2_inhibition_bwd": F.k2_inhibition_bwd_plain(*cases[0][2]),
             "k3_excitation_bwd": F.k3_excitation_bwd_plain(*cases[1][2])}

    original = (_native.CSRC / "int_cell_bwd.cu").read_text()
    for turn in range(2):
        for variant in variants:
            folder = _native.BUILD / "probe" / variant
            folder.mkdir(parents=True, exist_ok=True)
            (folder / "int_cell_bwd.cu").write_text(patched_source(variant, original))
            _native.CSRC = folder
            _native._libs.clear()
            _native.build(["int_cell_bwd"])
            checked = not (set(variant.split("+")) & UNCHECKED)
            parts = []
            for name, wrapper, args in cases:
                got = wrapper(*args)
                torch.cuda.synchronize()
                if checked:
                    try:
                        _, _, share = chip_smoke.backward_errors(
                            name, chip_smoke.ROWS, got, wants[name])
                        note = f"gates hold, {share:.3g} of elements past the tight tolerance"
                    except SystemExit:
                        note = "GATES FAIL"
                else:
                    note = "not compared"
                ms = chip_smoke.device_ms(lambda: wrapper(*args))
                parts.append(f"{name} {ms * 1e3:.2f} us ({note})")
            if turn == 0:
                parts += [line for line in chip_smoke.resource_lines(
                    _native.build_log("int_cell_bwd")) if re.match(r"k[23]_bwd", line)]
            print(f"{variant}, turn {turn}: " + " | ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
