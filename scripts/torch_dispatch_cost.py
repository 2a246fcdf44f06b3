#!/usr/bin/env python3
"""What the custom-op dispatch of the K1-K3 forward calls costs on one CUDA
card: chainE's mixed fused InT (T=64) train step at train_InT.sh's batch
(180) and its serving request at batch 128, each timed with every forward
call going through ``torch.ops.pathtracker.*`` (as a traced program's
calls do) and with the op's implementation called directly (as
pathtracker_torch's eager calls do), in alternating order.

    python3 scripts/torch_dispatch_cost.py [--rounds 8]

Prints, per workload and mode, the median and the range of the wall times
(each call ends on a device sync), and the medians' difference beside the
spread of the two modes; first, the host time of one K1 forward call at one
clip's 1,024 rows, back to back, in both modes.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from torch_serve_profile import CHECKPOINT  # noqa: E402

from pathtracker_torch.data.pathtracker import render_batch  # noqa: E402
from pathtracker_torch.eval import serve  # noqa: E402
from pathtracker_torch.ops import _native  # noqa: E402
from pathtracker_torch.ops import int_fused as F  # noqa: E402
from pathtracker_torch.train.steps import make_optimizer, make_train_step  # noqa: E402


@contextlib.contextmanager
def through_op():
    """Every K1-K3 forward call goes through its custom op, as it does
    while a program is traced."""
    saved = F._forward
    F._forward = lambda op, impl, args: op(*args)
    try:
        yield
    finally:
        F._forward = saved


def timed(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def compare(name: str, fn, rounds: int) -> None:
    times = {"op": [], "direct": []}
    for mode in times:  # warm-up, both modes
        with through_op() if mode == "op" else contextlib.nullcontext():
            fn()
            fn()
    for i in range(rounds):
        for mode in (("op", "direct") if i % 2 == 0 else ("direct", "op")):
            with through_op() if mode == "op" else contextlib.nullcontext():
                times[mode].append(timed(fn))
    med = {m: statistics.median(v) for m, v in times.items()}
    spread = max(max(v) - min(v) for v in times.values())
    for mode, values in times.items():
        print(f"{name}, {mode}: median {med[mode]:.3f} ms, range "
              f"{min(values):.3f}-{max(values):.3f} ms over {len(values)} calls", flush=True)
    print(f"{name}: op - direct {med['op'] - med['direct']:+.3f} ms "
          f"({(med['op'] / med['direct'] - 1) * 100:+.2f}%), largest range of a mode "
          f"{spread:.3f} ms", flush=True)


def host_call_us(dev, calls: int = 2000) -> None:
    """Microseconds of host time per K1 forward call, back to back, at
    1,024 rows (the kernel is far shorter than the call)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = 1024
    args = (torch.randn((rows, F.C), generator=gen, device=dev),
            torch.randn((rows, F.C), generator=gen, device=dev).to(torch.bfloat16),
            torch.randn((F.C, F.C), generator=gen, device=dev).to(torch.bfloat16),
            torch.randn((F.C,), generator=gen, device=dev))
    per = {}
    for _ in range(2):  # the second pass is the one kept
        for mode in ("op", "direct"):
            with through_op() if mode == "op" else contextlib.nullcontext():
                F.k1_attention(*args)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(calls):
                    F.k1_attention(*args)
                per[mode] = (time.perf_counter() - t) / calls * 1e6
                torch.cuda.synchronize()
    print(f"K1 forward call at {rows} rows, host time back to back over {calls} calls: "
          f"op {per['op']:.2f} us, direct {per['direct']:.2f} us", flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=8)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(out.strip().splitlines()[0], flush=True)
    _native.build()
    dev = torch.device("cuda")
    host_call_us(dev)

    clips, labels = render_batch(0, 180, 64, n_distractors=14, dot_size=2)
    clips, labels = torch.from_numpy(clips).to(dev), torch.from_numpy(labels).to(dev)
    model = serve.build(ckpt=CHECKPOINT, length=64, bf16=True).train()
    step = make_train_step(model, "InT", make_optimizer(3e-4))
    before = [k.launches for k in F.KERNELS]
    step(clips, labels)
    rose = [k.launches - b for k, b in zip(F.KERNELS, before)]
    if rose != [128] * 3 + [64] * 3:
        print(f"the train step launched {rose}, not 2T forward and T backward", file=sys.stderr)
        return 1
    compare("train step, batch 180, T=64 (chainE, --bf16, fused)", lambda: step(clips, labels),
            args.rounds)
    del step, model
    torch.cuda.empty_cache()

    model = serve.build(ckpt=CHECKPOINT, length=64, bf16=True)
    infer = serve.make_inference_fn(model, "InT")
    x = clips[:128]
    compare("request, batch 128, T=64 (chainE, --bf16, fused)", lambda: infer(x),
            2 * args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
