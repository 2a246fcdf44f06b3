"""Command-line flags (pathtracker_tpu/utils/opts.py), argparse-compatible
with reference utils/opts.py:2-46.

The same 40 flags as the JAX package, with the same names, destinations and
defaults, so one command line parses to the same namespace in both. Every
reference flag is accepted; flags the reference's scripts used but never
defined (--which_tests, --set_name, --b) are provided for real. Flags of
paths the port has not reached yet parse all the same.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="PathTracker on PyTorch and CUDA")
    parser.add_argument("--name", type=str, default="hgru")
    parser.add_argument("--model", type=str, default="hgru")
    parser.add_argument("--algo", type=str, default="bptt",
                        help="gradient method: bptt | rbp")
    parser.add_argument("--penalty", default=False, action="store_true",
                        help="add the Jacobian stability penalty to the loss")
    parser.add_argument("--pretrained", default=False, action="store_true")
    parser.add_argument("--optical_flow", default=False, action="store_true")
    parser.add_argument("--slowfast_cfg", type=str, default=None,
                        help="fvcore-style yaml overriding the in-repo "
                             "SlowFast architecture cfg (reference "
                             "models/cfgs/*.yaml schema)")

    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--dist", type=int)
    parser.add_argument("--speed", type=int)
    parser.add_argument("--length", type=int)

    # learning configs
    parser.add_argument("--epochs", default=30, type=int, metavar="N")
    # "--b" is the spelling the reference's viz_InT.sh used (a flag absent
    # from its opts.py); an explicit alias also keeps it unambiguous vs
    # --bf16 under argparse prefix matching.
    parser.add_argument("-b", "--batch-size", "--b", default=256, type=int,
                        metavar="N")
    parser.add_argument("--lr", "--learning-rate", default=3e-4, type=float,
                        metavar="LR", dest="lr")
    parser.add_argument("--lr_steps", default=[20, 40], type=float, nargs="+",
                        metavar="LRSteps")
    # The reference defined a StepLR and never stepped it (mainclean.py:160);
    # 'none' (constant lr) is therefore the parity default. The other kinds
    # make --lr_steps/--warmup-epochs real (epoch units; train/steps.py
    # build_lr_schedule).
    parser.add_argument("--lr-schedule", default="none",
                        choices=["none", "step", "cosine", "warmup_cosine"],
                        help="learning-rate decay over the run (epoch units)")
    parser.add_argument("--warmup-epochs", default=1.0, type=float,
                        help="linear warmup span for warmup_cosine")

    parser.add_argument("-d", "--dimensions", default=32, type=int)
    parser.add_argument("-k", "--fb_kernel_size", default=7, type=int)

    # monitoring
    parser.add_argument("--print-freq", "-p", default=100, type=int, metavar="N")
    parser.add_argument("--eval-freq", "-ef", default=1, type=int, metavar="N")
    parser.add_argument("-parallel", "--parallel", default=False, action="store_true",
                        help="shard the batch over all devices on the mesh")
    parser.add_argument("--start-epoch", default=0, type=int, metavar="N")
    parser.add_argument("--log", default=False, action="store_true")
    parser.add_argument("--val-freq", "-vf", default=2000, type=int, metavar="N")

    # flags the reference launchers used but never defined (SURVEY.md header)
    parser.add_argument("--which_tests", type=str, default=None,
                        help="restrict eval to configs with this clip length")
    parser.add_argument("--set_name", type=str, default=None,
                        help="human-experiment clip set for viz")
    parser.add_argument("--results-dir", type=str, default="results",
                        help="root folder for logs/checkpoints")

    # Extensions of the JAX package (additive; reference semantics unchanged)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", default=False, action="store_true",
                        help="bfloat16 compute for the hot path")
    parser.add_argument("--synth-train", type=int, default=None,
                        help="synthetic dataset size if TFRecords are missing")
    parser.add_argument("--synth-test", type=int, default=None)
    parser.add_argument("--device-data", default=False, action="store_true",
                        help="keep the whole dataset resident in device "
                             "memory and gather batches on the device")
    parser.add_argument("--fused-steps", type=int, default=1, metavar="K",
                        dest="fused_steps",
                        help="with --device-data: K optimizer steps per "
                             "dispatch and one stats fetch per window")
    parser.add_argument("--accum-steps", type=int, default=1, metavar="K",
                        dest="accum_steps",
                        help="accumulate gradients over K micro-batches "
                             "before each Adam update (optax.MultiSteps) — "
                             "K x the effective batch without the memory; "
                             "epoch step budgets count micro-batches")
    parser.add_argument("--auto-resume", default=False, action="store_true",
                        dest="auto_resume",
                        help="if the run dir has a rolling last-epoch "
                             "checkpoint, continue from it (params + epoch) "
                             "— self-healing restarts for timeout-bounded "
                             "runs; an explicit --ckpt still warm-starts "
                             "first")
    parser.add_argument("--ema", type=float, default=None, metavar="DECAY",
                        help="maintain an EMA of the weights (e.g. 0.999); "
                             "validation + best-val checkpoints use the EMA "
                             "weights; the rolling last-epoch checkpoint "
                             "keeps the raw weights for exact resume")
    parser.add_argument("--clip-grad", type=float, default=None, metavar="NORM",
                        dest="clip_grad",
                        help="global-norm gradient clip before Adam (the "
                             "reference's clip_grad_norm_ is print-only; "
                             "default None keeps that parity)")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a profiler trace of warm train steps "
                             "to DIR")
    parser.add_argument("--remat-blocks", default=False, action="store_true",
                        dest="remat_blocks",
                        help="rematerialize residual blocks (store block "
                             "inputs only, recompute activations in the "
                             "backward) — makes rntsm fit the device at T=64")
    return parser


parser = build_parser()
