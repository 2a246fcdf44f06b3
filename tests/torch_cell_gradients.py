#!/usr/bin/env python3
"""How far each mixed-precision InT cell's gradient lies from the exact one,
on the CPU: for each checkpoint, the gradient of the BCE of one batch of
rendered clips under the JAX package's mixed (bf16 eager) cell, the port's
fused cell (the plain versions of K1-K3 and their backward) and the port's
eager mixed cell, each against the port's float64 gradient of the same
loss. Only the recurrent circuit's parameters are compared: the readout's
gradients agree to 1e-2 on every cell.

    python tests/torch_cell_gradients.py LABEL:CKPT:T:DIST [...] [--batch 16]
        [--jax-fused] [--per-parameter w_exc,w_inh]

prints one line a checkpoint: the f64 loss and gradient norm, then each
cell's gradient norm over the f64 norm ("ratio") and its cosine with the
f64 gradient. ``--jax-fused`` adds the JAX package's fused cell (its
Pallas kernels, in interpret mode on the CPU); ``--per-parameter`` adds a
line for each named parameter alone. At T=64 one checkpoint takes ~5.5 min
on 6 threads at batch 16 (the JAX program compiles once a length).

The chance plateau of stage A (the JAX chainA's last checkpoint before its
escape), kept in results_torch/cpu_cell_gradients/logs/plateau_A38.log:

    python tests/torch_cell_gradients.py --jax-fused --per-parameter w_exc,w_inh \
        A38:results_conv/8_1_1/chainA/saved_models/model_val_acc_0056_epoch_38_checkpoint.pth.tar:8:1
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pathtracker_torch.data.pathtracker import render_batch  # noqa: E402
from pathtracker_torch.data.prepare import prepare_batch  # noqa: E402
from pathtracker_torch.engine import model_step  # noqa: E402
from pathtracker_torch.eval import serve  # noqa: E402
from pathtracker_torch.train.torch_import import to_jax_params  # noqa: E402
from pathtracker_torch.utils.metrics import bce_with_logits  # noqa: E402
from pathtracker_tpu import engine as jengine  # noqa: E402
from pathtracker_tpu.data.prepare import prepare_batch as jax_prepare_batch  # noqa: E402
from pathtracker_tpu.utils.metrics import bce_with_logits as jax_bce  # noqa: E402

READOUT = ("readout", "target")
SEED = 7  # the clips' render seed


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float64)
    return out


_JAX = {}  # (T, batch, fused): the model's template params and jitted value_and_grad


def jax_mixed(ckpt: str, clips, labels, fused: bool = False) -> tuple[float, dict]:
    """The JAX package's mixed cell (its eager default, or ``fused``):
    loss and gradient by JAX param name."""
    batch, length = clips.shape[0], clips.shape[1]
    if (length, batch, fused) not in _JAX:
        args = types.SimpleNamespace(model="InT", dimensions=32, fb_kernel_size=7, bf16=True,
                                     pretrained=False, algo="bptt", penalty=False,
                                     parallel=False)
        model = jengine.model_selector(args, length)
        if fused:
            model = model.clone(fused=True)
        init = model.init(jax.random.key(0),
                          jnp.zeros((batch, 3, length, 32, 32)))["params"]

        def loss_fn(params, raw_clips, raw_labels):
            imgs, target = jax_prepare_batch(raw_clips, raw_labels)
            out, _ = jengine.model_step(model, {"params": params}, imgs, "InT")
            return jax_bce(out, target)

        _JAX[(length, batch, fused)] = (init, jax.jit(jax.value_and_grad(loss_fn)))
    init, grad_fn = _JAX[(length, batch, fused)]
    loss, grads = grad_fn(jengine.load_ckpt(init, ckpt), jnp.asarray(clips),
                          jnp.asarray(labels))
    return float(loss), _flat(grads)


def port(ckpt: str, clips, labels, dtype=None, **model_kwargs) -> tuple[float, dict]:
    """The port's cell (``model_kwargs`` as serve.build takes them), in
    ``dtype`` where given: loss and gradient by JAX param name."""
    length = clips.shape[1]
    model = serve.build(ckpt=ckpt, length=length, device="cpu", **model_kwargs).train()
    imgs, target = prepare_batch(torch.from_numpy(clips), torch.from_numpy(labels))
    if dtype is not None:
        model, imgs, target = model.to(dtype), imgs.to(dtype), target.to(dtype)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    out, _ = model_step(model, imgs, "InT")
    loss = bce_with_logits(out, target)
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    state = {n: (torch.zeros_like(p) if g is None else g).float()
             for (n, p), g in zip(named, grads)}
    return loss.item(), _flat(to_jax_params(state))


def _against(got: dict, exact: dict, keys: list) -> dict:
    a = np.concatenate([got[k].ravel() for k in keys])
    b = np.concatenate([exact[k].ravel() for k in keys])
    return {"ratio": float(np.linalg.norm(a) / np.linalg.norm(b)),
            "cosine": float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))}


def compare(ckpt: str, length: int, dist: int, batch: int, jax_fused: bool = False,
            per_parameter=()) -> dict:
    """Each cell's gradient against the f64 one over the recurrent
    parameters, and (``per_parameter``) over each named one alone."""
    clips, labels = render_batch(SEED, batch, timesteps=length, n_distractors=dist,
                                 dot_size=2)
    labels = labels.astype(np.uint8)
    loss, exact = port(ckpt, clips, labels, dtype=torch.float64)
    keys = [k for k in exact if not k.startswith(READOUT) and np.linalg.norm(exact[k]) > 0]
    ref = np.concatenate([exact[k].ravel() for k in keys])
    out = {"loss": loss, "norm": float(np.linalg.norm(ref)), "cells": []}
    cells = [("jax_mixed", lambda: jax_mixed(ckpt, clips, labels)),
             ("port_fused", lambda: port(ckpt, clips, labels, bf16=True)),
             ("port_eager", lambda: port(ckpt, clips, labels, bf16=True, fused=False))]
    if jax_fused:
        cells.insert(1, ("jax_fused", lambda: jax_mixed(ckpt, clips, labels, fused=True)))
    for name, run in cells:
        _, grads = run()
        out["cells"].append(name)
        out[name] = _against(grads, exact, keys)
        for param in per_parameter:
            out[name][param] = _against(grads, exact, [param])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("specs", nargs="+", help="LABEL:CKPT:T:DIST")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--threads", type=int, default=6)
    p.add_argument("--jax-fused", action="store_true",
                   help="also the JAX package's fused cell (Pallas, interpret mode)")
    p.add_argument("--per-parameter", default="",
                   help="comma-separated parameter names to compare one by one too")
    a = p.parse_args(argv)
    torch.set_num_threads(a.threads)
    per_parameter = [n for n in a.per_parameter.split(",") if n]
    for spec in a.specs:
        label, ckpt, length, dist = spec.rsplit(":", 3)
        t0 = time.perf_counter()
        got = compare(ckpt, int(length), int(dist), a.batch, a.jax_fused, per_parameter)
        cells = "; ".join(f"{name.replace('_', ' ')} ratio {got[name]['ratio']:.3f} cosine "
                          f"{got[name]['cosine']:.3f}" for name in got["cells"])
        print(f"{label} T={length}, batch {a.batch}: f64 loss {got['loss']:.4f}, |gradient| "
              f"{got['norm']:.4g}; {cells} ({time.perf_counter() - t0:.0f} s)", flush=True)
        for param in per_parameter:
            print(f"{label} {param}: " + "; ".join(
                f"{name.replace('_', ' ')} ratio {got[name][param]['ratio']:.3f} cosine "
                f"{got[name][param]['cosine']:.3f}" for name in got["cells"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
