#!/usr/bin/env python3
"""The ConvGRU (``gru``), or another model of the zoo (``--model``), of
pathtracker_torch and of pathtracker_tpu from the same weights, trained for
a few Adam steps on one repeated batch at each given rate on the CPU: both
packages' losses side by side. Whether the loss falls at train_InT.sh's
rate is a property of the model only if the JAX package's loss does what
the port's does; chip_smoke.py's zoo phases train gru and ffnet at the
rates of ZOO_RATES on the strength of this output.

    python tests/torch_gru_rate_witness.py
    python tests/torch_gru_rate_witness.py --init port --clip-seed 31
    python tests/torch_gru_rate_witness.py --model ffnet --init port --length 8 --batch 4

The weights are, at the registry's width (``-d`` 32 builds gru at 64 channels),
the JAX module's init from ``--seed`` carried to the port with
``state_dict_from_jax`` (``--init jax``), or the port's seeded init, as
chip_smoke.py's zoo phase builds it, carried to JAX with ``to_jax_params``
(``--init port``). The clips are rendered as chainE was trained (dist 14,
speed 1, 2-pixel dots) from ``--clip-seed`` (chip_smoke.py's zoo batch is
seed 31).
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pathtracker_torch.data.pathtracker import render_batch  # noqa: E402
from pathtracker_torch.models import registry as TR  # noqa: E402
from pathtracker_torch.train import steps as TS  # noqa: E402
from pathtracker_torch.train.torch_import import state_dict_from_jax, to_jax_params  # noqa: E402
from pathtracker_tpu.models import registry as JR  # noqa: E402
from pathtracker_tpu.train import steps as JS  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="gru")
    p.add_argument("--length", type=int, default=16)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("-d", "--dimensions", type=int, default=32)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--rates", type=float, nargs="+", default=[3e-4, 3e-6])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clip-seed", type=int, default=0)
    p.add_argument("--init", choices=("jax", "port"), default="jax")
    args = p.parse_args(argv)

    clips, labels = render_batch(args.clip_seed, args.batch, args.length, n_distractors=14,
                                 dot_size=2)
    kw = dict(timesteps=args.length, dimensions=args.dimensions, fb_kernel_size=7)
    jm = JR.model_selector(args.model, **kw)
    if args.init == "jax":
        shape = (args.batch, 3, args.length, 32, 32)
        params = jm.init(jax.random.key(args.seed), jnp.zeros(shape, jnp.float32))["params"]
        params = jax.tree.map(np.asarray, params)
    else:
        params = to_jax_params(TR.model_selector(args.model, device="cpu", **kw).state_dict())
    print(f"{args.model} at -d {args.dimensions}, T={args.length}, {args.init}'s init, batch "
          f"{args.batch} of rendered clips (seed {args.clip_seed}, labels "
          f"{labels.tolist()}), {args.steps} Adam steps on the same batch", flush=True)
    for rate in args.rates:
        jstep = JS.make_train_step(jm, args.model, JS.make_optimizer(rate))
        jparams = jax.tree.map(jnp.asarray, params)
        jopt = JS.make_optimizer(rate).init(jparams)
        tm = TR.model_selector(args.model, device="cpu", **kw).train()
        tm.load_state_dict(state_dict_from_jax(args.model, params), strict=True)
        tstep = TS.make_train_step(tm, args.model, TS.make_optimizer(rate))
        losses = {"pathtracker_tpu": [], "pathtracker_torch": []}
        for _ in range(args.steps):
            jparams, jopt, jstats = jstep(jparams, jopt, jnp.asarray(clips),
                                          jnp.asarray(labels))
            losses["pathtracker_tpu"].append(float(jstats["loss"]))
            losses["pathtracker_torch"].append(float(tstep(clips, labels)["loss"]))
        for package, values in losses.items():
            trend = "falls" if values[-1] < values[0] else "does not fall"
            print(f"Adam({rate:g}) {package}: losses {' '.join(f'{v:.6f}' for v in values)} "
                  f"({trend})", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    main()
