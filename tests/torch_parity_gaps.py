#!/usr/bin/env python3
"""Logit gaps between pathtracker_torch and pathtracker_tpu serving the
chainE checkpoint on the CPU: every path (f32, mixed eager, mixed fused) of
both packages on the same clips, and the largest gap of each pair. The
mixed-path tolerances of tests/test_torch_serve.py and the choice of
rendered clips in chip_smoke.py rest on its output.

    python tests/torch_parity_gaps.py --length 8 --batch 2
    python tests/torch_parity_gaps.py --length 64 --batch 16 --clips noise

``--clips rendered`` (default) renders clips as chainE was trained (dist 14,
speed 1, 2-pixel dots) from seed 0; ``--clips noise`` draws uniform uint8
frames as bench.py does.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracker_torch.data.pathtracker import render_batch  # noqa: E402
from pathtracker_torch.eval import serve as tserve  # noqa: E402
from pathtracker_tpu.eval import serve as jserve  # noqa: E402
from pathtracker_tpu.models.int_circuit import InT as JInT  # noqa: E402
from pathtracker_tpu.train.checkpoint import load_params  # noqa: E402

CHECKPOINT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "results_conv", "64_1_14", "chainE", "saved_models",
                          "model_val_acc_0072_epoch_15_checkpoint.pth.tar")
PATHS = (("f32", "float32", False), ("bf16 eager", "bfloat16", False),
         ("bf16 fused", "bfloat16", True))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--length", type=int, default=8)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--clips", choices=("rendered", "noise"), default="rendered")
    args = p.parse_args()
    if args.clips == "rendered":
        x, y = render_batch(0, args.batch, args.length, n_distractors=14, dot_size=2)
    else:
        x = np.random.default_rng(0).integers(
            0, 255, (args.batch, args.length, 32, 32, 3), dtype=np.uint8)
        y = None

    logits = {}
    for name, dtype, fused in PATHS:
        jm = JInT(dimensions=32, timesteps=args.length, kernel_size=7, dtype=dtype,
                  fused=fused)
        template = jm.init(jax.random.key(0),
                           jnp.zeros((1, 3, args.length, 32, 32)))["params"]
        params = load_params(CHECKPOINT, template=template)
        logits[f"jax {name}"] = np.asarray(
            jserve.make_inference_fn(jm, "InT", params, probs=False)(x))
        tm = tserve.build(ckpt=CHECKPOINT, length=args.length,
                          bf16=dtype == "bfloat16", fused=fused, device="cpu")
        logits[f"torch {name}"] = tserve.make_inference_fn(
            tm, "InT", probs=False)(x).numpy()
    print(f"chainE, {args.clips} clips, batch {args.batch}, T={args.length}, CPU")
    for k, v in logits.items():
        acc = "" if y is None else f"  accuracy {np.mean((v > 0) == y):.4f}"
        print(f"  {k:18s} logits[:4] {np.round(v[:4], 5)}{acc}")
    print("  largest |logit gap|:")
    for a, b in itertools.combinations(logits, 2):
        print(f"    {a:18s} vs {b:18s} {np.abs(logits[a] - logits[b]).max():.3g}")


if __name__ == "__main__":
    main()
