#!/usr/bin/env python3
"""What bounds the InT cell's ring kernels (K1, K2 and K3 backward, K2
forward), on one CUDA card: their time under variants of
``pathtracker_torch/csrc/{int_cell.cu,int_cell_bwd.cu,ring.cuh}``.

    python3 scripts/torch_bwd_probe.py [variant ...]

A variant is ``as_is`` or patch names joined by ``+`` (``no_math+no_store``).
Each patch is a textual substitution in a copy of one of the three files
under ``build/probe/`` (the repository's sources are not touched; a patch
that no longer matches its file exactly once stops the script). The variants
run in the order given, twice over, each timed like ``chip_smoke.py`` times
a wrapper call (CUDA graph of 20 calls, replayed, CUDA events) at 131,072 x
32 on ``chip_smoke.py``'s seeded inputs (K1 backward without a cotangent for
the attention map, as the train step calls it), and checked against the
plain version where its arithmetic is still the kernel's. Each is timed
twice: on the same inputs every call, as ``chip_smoke.py`` does (inputs
under the 50 MB L2 cache partly stay in it from one call to the next), and
with a cold L2, the calls taking four copies of the inputs in turn. First
it prints what the card streams: a copy and an add of 128 MB f32 arrays
through PyTorch.

Patches:
  no_math      softplus, sigmoid replaced by x and 0.5: no transcendentals
  no_store     the staged outputs are not copied out to device memory
  no_load      every row is zero-filled in shared memory instead of loaded
  math_apiece  each softplus and sigmoid of the backward kernels with its own
               expf and an IEEE quotient, and the gates' sigmoids with IEEE
               quotients, as the first kernels computed them
  math_fast    __expf and __logf for expf and log1pf
  k2f_8w3s     K2 forward: 8 warps a block, 3 stages, one block an SM (8
               warps an SM)
  k2f_4w2s     K2 forward: 4 warps a block, 2 stages, five blocks an SM (20
               warps an SM)
  k2f_7w3s, k2f_6w3s   K2 forward: 7 or 6 warps a block, 3 stages, two
               blocks an SM
  k1_8w2s      K1 backward: 8 warps a block, 2 stages, two blocks an SM
  k2_stages3, k3_7x3, k2_12warps, k3_10warps   other ring shapes of K2 and
               K3 backward
Without arguments: as_is, the ring shapes of K2 forward and K1 backward,
the transcendentals removed, and the one-sided memory floors.
"""

from __future__ import annotations

import itertools
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from pathtracker_torch.ops import _native  # noqa: E402
from pathtracker_torch.ops import int_fused as F  # noqa: E402

FWD, BWD, RING = "int_cell.cu", "int_cell_bwd.cu", "ring.cuh"
SHARED = '''  const float e = expf(-fabsf(x));
  sp = fmaxf(x, 0.0f) + log1pf(e);
  sg = __fdividef(x >= 0.0f ? 1.0f : e, 1.0f + e);
'''
GATE = "  return __fdividef(1.0f, 1.0f + expf(-x));\n"
SOFTPLUS = "  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));\n"
K2F_SHAPE = "K2_WARPS = 8, K2_STAGES = 2, K2_BLOCKS_PER_SM = 2;"
K1_SHAPE = "K1_WARPS = 8, K1_STAGES = 3, K1_BLOCKS_PER_SM = 1;"
# patch name -> [(file, old, new)]
PATCHES = {
    "no_math": [(BWD, SHARED, "  sp = x;\n  sg = 0.5f;\n"),
                (RING, GATE, "  return 0.5f + 1e-3f * x;\n"),
                (FWD, SOFTPLUS, "  return x;\n")],
    "no_store": [(RING, "    if (row0 + r < rows)\n      *reinterpret_cast<uint4*>(base",
                  "    if (row0 + r < rows && rows < 0)\n      *reinterpret_cast<uint4*>(base")],
    "no_load": [(RING, "    const bool in = row0 + r < rows;\n    cp_async_16(",
                 "    const bool in = false;\n    cp_async_16(")],
    "math_apiece": [(BWD, SHARED, "  sp = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));\n"
                                  "  sg = 1.0f / (1.0f + expf(-x));\n"),
                    (RING, GATE, "  return 1.0f / (1.0f + expf(-x));\n")],
    "math_fast": [(BWD, SHARED, "  const float e = __expf(-fabsf(x));\n"
                                "  sp = fmaxf(x, 0.0f) + __logf(1.0f + e);\n"
                                "  sg = __fdividef(x >= 0.0f ? 1.0f : e, 1.0f + e);\n"),
                  (RING, GATE, "  return __fdividef(1.0f, 1.0f + __expf(-x));\n"),
                  (FWD, SOFTPLUS, "  return fmaxf(x, 0.0f) + __logf(1.0f + __expf(-fabsf(x)));\n")],
    "k2f_8w3s": [(FWD, K2F_SHAPE, "K2_WARPS = 8, K2_STAGES = 3, K2_BLOCKS_PER_SM = 1;")],
    "k2f_4w2s": [(FWD, K2F_SHAPE, "K2_WARPS = 4, K2_STAGES = 2, K2_BLOCKS_PER_SM = 5;")],
    "k2f_7w3s": [(FWD, K2F_SHAPE, "K2_WARPS = 7, K2_STAGES = 3, K2_BLOCKS_PER_SM = 2;")],
    "k2f_6w3s": [(FWD, K2F_SHAPE, "K2_WARPS = 6, K2_STAGES = 3, K2_BLOCKS_PER_SM = 2;")],
    "k1_8w2s": [(BWD, K1_SHAPE, "K1_WARPS = 8, K1_STAGES = 2, K1_BLOCKS_PER_SM = 2;")],
    "k2_stages3": [(BWD, "K2_WARPS = 8, K2_STAGES = 2;", "K2_WARPS = 8, K2_STAGES = 3;")],
    "k3_7x3": [(BWD, "K3_WARPS = 8, K3_STAGES = 2;", "K3_WARPS = 7, K3_STAGES = 3;")],
    "k2_12warps": [(BWD, "K2_WARPS = 8, K2_STAGES = 2;", "K2_WARPS = 12, K2_STAGES = 2;")],
    "k3_10warps": [(BWD, "K3_WARPS = 8, K3_STAGES = 2;", "K3_WARPS = 10, K3_STAGES = 2;")],
}
# Patches that change what the kernel computes: no comparison with the plain version.
UNCHECKED = {"no_math", "no_store", "no_load"}
DEFAULT = ["as_is", "k2f_8w3s", "k2f_4w2s", "k2f_7w3s", "k2f_6w3s", "k1_8w2s", "no_math",
           "no_math+no_store", "no_math+no_load", "no_store"]
RESOURCES = re.compile(r"(k2_kernel|k1_bwd_kernel|k2_bwd_kernel|k3_bwd_kernel):")


def patched_sources(variant: str, sources: dict) -> dict:
    sources = dict(sources)
    for name in ([] if variant == "as_is" else variant.split("+")):
        for file, old, new in PATCHES[name]:
            if sources[file].count(old) != 1:
                sys.exit(f"patch {name}: {sources[file].count(old)} matches of {old!r} in {file}")
            sources[file] = sources[file].replace(old, new)
    return sources


def streaming_yardstick(dev) -> None:
    n = 32 * 1024 * 1024
    a, b = torch.randn(n, device=dev), torch.randn(n, device=dev)
    c = torch.empty(n, device=dev)
    for label, fn, nbytes in (("copy c = a", lambda: c.copy_(a), 8 * n),
                              ("add c = a + b", lambda: torch.add(a, b, out=c), 12 * n)):
        ms = chip_smoke.device_ms(fn, calls=5, replays=4)
        print(f"card streams, {label} ({nbytes / 1e6:.0f} MB moved): {ms * 1e3:.1f} us, "
              f"{nbytes / ms / 1e9:.3f} TB/s", flush=True)


def check(name: str, got, want) -> str:
    try:
        if name == "k2_inhibition":
            chip_smoke.max_error((got,), (want,))
            return "gates hold"
        _, _, share = chip_smoke.backward_errors(name, chip_smoke.ROWS, got, want)
        return f"gates hold, {share:.3g} of elements past the tight tolerance"
    except SystemExit:
        return "GATES FAIL"


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
    dgated = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    torch.randn(shape, generator=gen, device=dev)  # chip_smoke draws datt before dnew
    dnew = torch.randn(shape, generator=gen, device=dev)
    k1 = ("exc", "att_x", "a_u", "a_u_b")
    k2 = ("conv_i", "mean0", "rstd0", "scale0", "bias0", "inp", "gi_x", "inh",
          "i_u", "i_u_b", "alpha", "mu")
    k3 = ("conv_e", "mean1", "rstd1", "scale1", "bias1", "new_inh", "inh", "gated",
          "exc", "e_w", "e_w_b", "e_u", "e_u_b", "kappa", "gamma")
    cases = [("k2_inhibition", F.k2_inhibition, F.k2_inhibition_plain, [d[k] for k in k2]),
             ("k1_attention_bwd", F.k1_attention_bwd, F.k1_attention_bwd_plain,
              [d[k] for k in k1] + [dgated]),
             ("k2_inhibition_bwd", F.k2_inhibition_bwd, F.k2_inhibition_bwd_plain,
              [d[k] for k in k2] + [dnew]),
             ("k3_excitation_bwd", F.k3_excitation_bwd, F.k3_excitation_bwd_plain,
              [d[k] for k in k3] + [dnew])]
    wants = {name: plain(*args) for name, _, plain, args in cases}
    copies = {name: [args] + [[t.clone() for t in args] for _ in range(3)]
              for name, _, _, args in cases}

    original = {f: (_native.CSRC / f).read_text() for f in (FWD, BWD, RING)}
    for turn in range(2):
        for variant in variants:
            folder = _native.BUILD / "probe" / variant
            folder.mkdir(parents=True, exist_ok=True)
            for file, text in patched_sources(variant, original).items():
                (folder / file).write_text(text)
            _native.CSRC = folder
            _native._libs.clear()
            _native.build(["int_cell", "int_cell_bwd"])
            checked = not (set(variant.split("+")) & UNCHECKED)
            parts = []
            for name, wrapper, _, args in cases:
                got = wrapper(*args)
                torch.cuda.synchronize()
                note = check(name, got, wants[name]) if checked else "not compared"
                ms = chip_smoke.device_ms(lambda: wrapper(*args))
                turns = itertools.cycle(copies[name])
                cold_ms = chip_smoke.device_ms(lambda: wrapper(*next(turns)))
                parts.append(f"{name} {ms * 1e3:.2f} us, cold L2 {cold_ms * 1e3:.2f} us "
                             f"({note})")
            if turn == 0:
                for lib in ("int_cell", "int_cell_bwd"):
                    parts += [line for line in chip_smoke.resource_lines(
                        _native.build_log(lib)) if RESOURCES.match(line)]
            print(f"{variant}, turn {turn}: " + " | ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
