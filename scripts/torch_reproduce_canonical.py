#!/usr/bin/env python3
"""The canonical warm-start chain of the InT tracker, trained with
pathtracker_torch from nothing (scripts/reproduce_canonical.sh's stages,
knobs and chain logic), and its report against the JAX package's records.

    python3 scripts/torch_reproduce_canonical.py            # the chain, then the report
    python3 scripts/torch_reproduce_canonical.py --report   # the report alone
    python3 scripts/torch_reproduce_canonical.py --report --every-checkpoint
    python3 scripts/torch_reproduce_canonical.py --report --jax-curve C  # JAX's C, each epoch
    python3 scripts/torch_reproduce_canonical.py --transfer  # B's checkpoints on C's shard
    python3 scripts/torch_reproduce_canonical.py --transfer A  # A's on B's and C's shards
    python3 scripts/torch_reproduce_canonical.py --until A   # stage A alone
    python3 scripts/torch_reproduce_canonical.py --until C   # the chain, no report
    CELL=eager python3 scripts/torch_reproduce_canonical.py  # on the eager mixed cell
    PATHTRACKER_TORCH_DEVICE=cpu EXTRA_FLAGS="-d 8 -k 3" ... # on the CPU, tiny

Stages, each a ``python -m pathtracker_torch.train`` process on the card
(the CPU where ``PATHTRACKER_TORCH_DEVICE=cpu``), all with ``--bf16
--device-data --fused-steps $FUSED_STEPS --synth-train $SYNTH_TRAIN
--synth-test $SYNTH_TEST --auto-resume $EXTRA_FLAGS``:

  A  T=8,  dist 1,  cold start,        lr 2e-3, $EPOCHS_A (60) epochs
  B  T=32, dist 5,  from A's best,     lr 3e-4, $EPOCHS_B (40) epochs
  C  T=64, dist 14, from B's best,     lr 1e-4, $EPOCHS_C (400) epochs, --ema $EMA_C (0.998)

The cell (``CELL``): ``fused`` (the default) trains on the K1-K3 kernels,
each stage a ``python -m pathtracker_torch.train`` process as above;
``eager`` trains InT on the eager mixed cell, the cell the JAX package
trained its chain on (its ``fused`` is False and no JAX CLI flag sets it),
each stage a process of this script (``--stage-run eager <flags>``) that
calls ``train.loop.main(args, model_kwargs={"fused": False})``: the train
CLI has no flag for the cell. ``cell`` maps a cell to its flags and model
keywords for this script and scripts/torch_chain_probe.py alike. An eager
chain's run folders, logs and eval folders carry ``eager_`` before their
names, so chains of both cells stand side by side in one results root.

``--until A|B|C`` stops the chain after that stage, without the report.

A stage is done once its run folder has a best-val checkpoint; A and B are
skipped then (unless ``FORCE_A=1`` / ``FORCE_B=1``). C always runs and
continues its rolling checkpoint (``--auto-resume``); it is warm-started
from B's best only while it has no best-val checkpoint of its own. The
best checkpoint is ``train.checkpoint.find_best_checkpoint``'s. A stage that
fails, or whose log shows that it was asked to stop ("SIGTERM: finishing
step"), stops the chain; a SIGTERM to this script is passed on to the
running stage, which checkpoints and exits, so a rerun continues it.

Knobs (environment, with reproduce_canonical.sh's defaults): MODEL (InT;
another name prefixes the run folders, e.g. hgru_chainA), BATCH (128),
SYNTH_TRAIN (20000), SYNTH_TEST (2500), FUSED_STEPS (12), EXTRA_FLAGS,
EPOCHS_A/B/C (60/40/400), EMA_C (0.998), FORCE_A, FORCE_B,
PATHTRACKER_DOT_SIZE (2), CELL (fused). The roots: ``--data-root`` (default
$PATHTRACKER_DATA_ROOT, else build/chain/data; the registry renders each
missing config there) and ``--results-root`` (default build/chain): run
folders are ``<results-root>/results_conv/{L}_{S}_{D}/{PFX}chain{A,B,C}``,
stage logs ``<results-root>/logs/{PFX}{A,B,C}.log``, the report's eval
folders ``<results-root>/results/``. Nothing is written elsewhere.

The report (``--report``, also run after the chain) evaluates B's and C's
best-val checkpoints and the JAX package's own stage-B and stage-C
checkpoints (results_conv/32_1_5/chainB, epoch 23, and
results_conv/64_1_14/chainC, epoch 34) on the full held-out passes of the
chain's roots through ``eval.test_model.evaluate_model`` at the stages'
batch with --bf16, once unseeded (as the JAX records were taken: one draw
of the loader's order, a fresh one each run) and once per loader seed
0-9 (the loader's spread: BatchNorm takes
each batch's statistics, and the 68 clips past the last full batch drop);
its accuracy and BCE are the seeded passes' mean, the same on every run;
prints each beside the JAX records and the greedy bars, and the JAX
checkpoints' beside their records and the bar (the lower record less 2
points); ``--jax-curve C`` also scores every best-val checkpoint of the
JAX package's chainC so, in epoch order, each beside its record at the
same epoch (results/chainC_eval_*); compares each stage's val curve with
the JAX package's val.npz (the first epoch above 75% balanced accuracy,
the best value and its epoch); names the stage-A checkpoint B started
from (hp_dict.npz's ``loaded_ckpt``) with its epoch after A's escape (A's
first epoch above 75%); and ends with one JSON line. The passes are
decoded once a process and kept, so scoring many checkpoints decodes each
shard once a loader seed.

``--transfer`` scores every stage-B checkpoint, the chain's and the JAX
package's, on C's held-out shard; ``--transfer A`` scores every stage-A
checkpoint of the chain and the JAX package's chainA checkpoints from
epoch 38 on (its last before the escape at 44, and each after) on B's
shard (T=32, dist 5) and on C's (T=64, dist 14), each with its epoch after
the escape, under loader seeds 0-2, and names the A checkpoint each B
started from. Both print one line a checkpoint and end with one JSON line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shlex
import signal
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = {  # tag: (length, dist, lr, epochs knob and default)
    "A": (8, 1, "2e-3", ("EPOCHS_A", "60")),
    "B": (32, 5, "3e-4", ("EPOCHS_B", "40")),
    "C": (64, 14, "1e-4", ("EPOCHS_C", "400")),
}
SPEED = 1
KNOBS = {"MODEL": "InT", "CELL": "fused", "BATCH": "128", "SYNTH_TRAIN": "20000",
         "SYNTH_TEST": "2500", "FUSED_STEPS": "12", "EXTRA_FLAGS": "", "EMA_C": "0.998"}
YIELDED = "SIGTERM: finishing step"
SEEDS = tuple(range(10))
ABOVE = 75.0  # the val meter's mark of having left the chance plateau (percent)
# The JAX package's records (BASELINE.md, "Reproduction chain from a clean
# clone"): held-out accuracy on the full pass of each stage's root, and the
# greedy nearest-neighbour bar on the same shard.
JAX_CHAIN_B = os.path.join(ROOT, "results_conv", "32_1_5", "chainB", "saved_models",
                           "model_val_acc_0090_epoch_23_checkpoint.pth.tar")
# The JAX package's chainC: its best-val checkpoints (epochs 0-34, each
# held out once unseeded in results/chainC_eval_<val>_epoch_<NN>), the last
# of them the one its record is.
JAX_CHAIN_C = os.path.join(ROOT, "results_conv", "64_1_14", "chainC", "saved_models",
                           "model_val_acc_0070_epoch_34_checkpoint.pth.tar")
JAX_CHAIN_A = os.path.join(ROOT, "results_conv", "8_1_1", "chainA")
# The JAX package's chainA checkpoints that --transfer A scores: its last
# before the escape (epoch 44) and every one after.
JAX_A_EPOCHS = (38, 44, 45, 46, 47, 49, 56, 59)
# The cells a stage trains on: the flag each drops and the model keywords
# it sets. The chain takes fused or eager; the probe also f32.
CELLS = {"fused": (None, {}),                # --bf16 on the K1-K3 kernels (the default)
         "eager": (None, {"fused": False}),  # --bf16 on the eager mixed cell (JAX's chain)
         "f32": ("--bf16", {})}              # the eager cell in f32
CHAIN_CELLS = ("fused", "eager")
RECORDS = {
    "B": {"npz": os.path.join(ROOT, "results", "chainB",
                              "test_perf_dist_5_speed_1_length_32.npz"),
          "other_runs": [0.8939], "greedy": 0.804},
    "C": {"npz": os.path.join(ROOT, "results", "chainC_eval_0070_epoch_34",
                              "test_perf_dist_14_speed_1_length_64.npz"),
          "other_runs": [0.6859], "greedy": 0.572},
}
MARGIN = 0.02  # a stage lands when its held-out accuracy is within 2 points of the JAX records'
JAX_CURVES = {tag: os.path.join(ROOT, "results_conv", f"{length}_{SPEED}_{dist}",
                                f"chain{tag}", "val.npz")
              for tag, (length, dist, _, _) in STAGES.items()}


def knobs(env=None) -> dict:
    env = os.environ if env is None else env
    out = {k: env.get(k, v) for k, v in KNOBS.items()}
    for name, default in (knob for *_, knob in STAGES.values()):
        out[name] = env.get(name, default)
    if out["CELL"] not in CHAIN_CELLS:
        raise ValueError(f"CELL={out['CELL']!r}: the chain trains on "
                         f"{' or '.join(CHAIN_CELLS)}")
    if out["CELL"] != "fused" and not out["MODEL"].startswith("InT"):
        raise ValueError(f"CELL={out['CELL']} is InT's cell, not {out['MODEL']}'s")
    out["PFX"] = (("" if out["MODEL"] == "InT" else f"{out['MODEL']}_")
                  + ("" if out["CELL"] == "fused" else f"{out['CELL']}_"))
    return out


def cell(name: str, flags: list[str]) -> tuple[list[str], dict]:
    """A stage's ``flags`` on the cell ``name`` (a key of CELLS) and the
    model keywords the cell sets."""
    if name not in CELLS:
        raise ValueError(f"unknown cell {name!r}; the cells are {sorted(CELLS)}")
    drop, kwargs = CELLS[name]
    return [f for f in flags if f != drop], dict(kwargs)


def run_folder(results_root: str, tag: str, k: dict) -> str:
    length, dist, _, _ = STAGES[tag]
    return os.path.join(results_root, "results_conv", f"{length}_{SPEED}_{dist}",
                        f"{k['PFX']}chain{tag}")


def stage_done(folder: str) -> bool:
    """A stage counts as done once it has any best-val checkpoint."""
    saved = os.path.join(folder, "saved_models")
    return os.path.isdir(saved) and any(
        n.startswith("model_val_acc_") and n.endswith(".tar") for n in os.listdir(saved))


def best_checkpoint(folder: str) -> str:
    from pathtracker_torch.train.checkpoint import find_best_checkpoint

    return find_best_checkpoint(folder)


def stage_flags(tag: str, k: dict, results_root: str, ckpt: str | None = None) -> list[str]:
    """The flags of a stage's train command, in reproduce_canonical.sh's order."""
    length, dist, lr, (epochs, _) = STAGES[tag]
    flags = ["--model", k["MODEL"], "--name", f"{k['PFX']}chain{tag}",
             "--length", str(length), "--speed", str(SPEED), "--dist", str(dist),
             "-b", k["BATCH"], "--lr", lr, "--epochs", k[epochs], "--bf16",
             "--device-data", "--fused-steps", k["FUSED_STEPS"]]
    if tag == "C":
        flags += ["--ema", k["EMA_C"]]
    flags += ["--synth-train", k["SYNTH_TRAIN"], "--synth-test", k["SYNTH_TEST"],
              "--results-dir", os.path.join(results_root, "results_conv"), "--auto-resume",
              *shlex.split(k["EXTRA_FLAGS"])]
    return flags + (["--ckpt", ckpt] if ckpt else [])


class _Forward:
    """While a stage runs, a SIGTERM to this process is passed on to it."""

    def __init__(self):
        self.proc, self.asked = None, False
        self.previous = signal.signal(signal.SIGTERM, self)

    def __call__(self, signum, frame):
        self.asked = True
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)

    def close(self):
        signal.signal(signal.SIGTERM, self.previous)


def run_stage(name: str, flags: list[str], log: str, env: dict, forward: _Forward,
              cell_name: str = "fused") -> bool:
    """One stage as a process with its output in ``log``: the train CLI on
    the fused cell, else this script's ``--stage-run``; whether the chain
    goes on."""
    if cell_name == "fused":
        argv = [sys.executable, "-u", "-m", "pathtracker_torch.train", *flags]
    else:
        argv = [sys.executable, "-u", os.path.abspath(__file__), "--stage-run", cell_name,
                *flags]
    print(f"chain: [{name}] {shlex.join(argv)}", flush=True)
    t0 = time.perf_counter()
    with open(log, "w") as out:
        forward.proc = subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT,
                                        cwd=ROOT, env=env)
        rc = forward.proc.wait()
        forward.proc = None
    with open(log) as f:
        text = f.read()
    for line in text.splitlines()[-3:]:
        print(f"  {line}", flush=True)
    print(f"chain: [{name}] exit {rc} after {time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 0:
        print(f"chain: {name} failed rc={rc} (log: {log})", flush=True)
        return False
    if YIELDED in text:
        print(f"chain: {name} was asked to stop: stopping the chain", flush=True)
        return False
    return True


def stage_run(cell_name: str, flags: list[str]) -> int:
    """One stage trained in this process on the cell ``cell_name``: the
    train CLI's ``loop.main`` with the cell's model keywords; at exit the
    kernel launch counts are appended to $PATHTRACKER_LAUNCHES, as the CLI
    appends them."""
    from pathtracker_torch.train import loop
    from pathtracker_torch.train.__main__ import write_launches

    flags, kwargs = cell(cell_name, flags)
    args = loop.parser.parse_args(flags)
    args.device = os.environ.get("PATHTRACKER_TORCH_DEVICE") or None
    try:
        loop.main(args, model_kwargs=kwargs)
    finally:
        if os.environ.get("PATHTRACKER_LAUNCHES"):
            write_launches(os.environ["PATHTRACKER_LAUNCHES"])
    return 0


def chain(results_root: str, env: dict, until: str = "C") -> bool:
    """The stages to ``until`` as reproduce_canonical.sh runs them; whether
    all ran."""
    k = knobs(env)
    logs = os.path.join(results_root, "logs")
    os.makedirs(logs, exist_ok=True)
    forward = _Forward()
    try:
        previous = None
        for tag in list(STAGES)[:list(STAGES).index(until) + 1]:
            folder = run_folder(results_root, tag, k)
            force = env.get(f"FORCE_{tag}", "0") == "1"
            if tag != "C" and stage_done(folder) and not force:
                print(f"chain: [{k['PFX']}{tag}] done ({folder} has a best-val "
                      "checkpoint): skipped", flush=True)
            else:
                # C is warm-started only while it has no best-val checkpoint.
                warm = previous if tag != "C" or not stage_done(folder) else None
                ckpt = best_checkpoint(warm) if warm else None
                log = os.path.join(logs, f"{k['PFX']}{tag}.log")
                if forward.asked or not run_stage(
                        f"{k['PFX']}{tag}", stage_flags(tag, k, results_root, ckpt), log,
                        env, forward, k["CELL"]):
                    return False
            previous = folder
    finally:
        forward.close()
    print("chain: done" if until == "C" else f"chain: stopped after stage {until}",
          flush=True)
    return True


# ---------------------------------- report ----------------------------------

def curve(path: str) -> dict | None:
    """The val meter's balanced accuracy (percent, one entry an epoch): the
    first epoch above ABOVE, the best value and its epoch."""
    if not os.path.exists(path):
        return None
    balacc = np.asarray(np.load(path)["balacc"], dtype=np.float64)
    if balacc.size == 0:
        return None
    above = np.nonzero(balacc > ABOVE)[0]
    return {"epochs": int(balacc.size),
            "first_above_75": int(above[0]) if above.size else None,
            "best": float(balacc.max()), "best_epoch": int(np.argmax(balacc))}


def _eval_args(k: dict, results_root: str, tag: str, device, ckpt: str, jax: bool = False):
    """The stage's own flags as the eval reads them (model, width, batch,
    --bf16), with ``ckpt``; ``jax``: at the JAX package's chain's width
    (InT, dims 32, kernel 7) whatever the knobs say."""
    from pathtracker_torch.utils.opts import parser

    args = parser.parse_args(stage_flags(tag, k, results_root))
    args.ckpt, args.device = ckpt, device
    if jax:
        args.model, args.dimensions, args.fb_kernel_size = "InT", 32, 7
    return args


def held_out(args, dist: int, length: int, folder: str) -> dict:
    """Accuracy and BCE of ``args.ckpt`` on the full held-out pass of the
    (dist, 1, length) root: evaluate_model once, its loader unseeded (a new
    order each run), then the same loader seeded with each of SEEDS; the
    seeded passes' mean is the result."""
    from pathtracker_torch.eval import test_model

    t0 = time.perf_counter()
    acc, loss = test_model.evaluate_model(folder, args, prep_gifs=0, dist=dist,
                                          speed=SPEED, length=length)
    passes = seeded_passes(args, dist, length, SEEDS)
    seeded = passes["seeded"]
    return {"ckpt": os.path.relpath(args.ckpt, ROOT) if args.ckpt.startswith(ROOT)
            else args.ckpt, "acc": passes["acc"], "loss": passes["loss"],
            "unseeded": {"acc": float(acc), "loss": float(loss)}, "seeded": seeded,
            "acc_range": [min(s["acc"] for s in seeded), max(s["acc"] for s in seeded)],
            "loss_range": [min(s["loss"] for s in seeded), max(s["loss"] for s in seeded)],
            "clips": seeded[0]["batches"] * args.batch_size,
            "seconds": time.perf_counter() - t0}


_PASSES: dict = {}  # (root, T, batch, seed): a seeded pass's batches, decoded once


def _seeded_batches(root: str, timesteps: int, batch: int, seed: int) -> list:
    """The batches of the held-out pass of ``root`` under loader seed
    ``seed``, decoded once a process."""
    from pathtracker_torch.data.pipeline import tfr_data_loader

    key = (root, timesteps, batch, seed)
    if key not in _PASSES:
        loader = tfr_data_loader(os.path.join(root, "test-*"), batch_size=batch,
                                 drop_remainder=True, timesteps=timesteps, seed=seed)
        _PASSES[key] = [(np.array(clips), np.array(labels)) for clips, labels in loader]
    return _PASSES[key]


def seeded_passes(args, dist: int, length: int, seeds) -> dict:
    """``args.ckpt`` on the full held-out pass of the (dist, 1, length)
    root under each loader seed of ``seeds``: the mean accuracy and BCE and
    each pass's."""
    from pathtracker_torch import engine
    from pathtracker_torch.eval import test_model

    root, timesteps, _, _ = engine.dataset_selector(dist, SPEED, length)
    model = engine.load_ckpt(engine.model_selector(args, timesteps, device=args.device),
                             args.ckpt).eval()
    seeded = []
    for seed in seeds:
        batches = _seeded_batches(root, timesteps, args.batch_size, seed)
        accs, losses, _ = test_model.evaluate_batches(model, args.model, batches)
        seeded.append({"seed": seed, "acc": float(np.mean(accs)),
                       "loss": float(np.mean(losses)), "batches": len(accs)})
    return {"acc": float(np.mean([s["acc"] for s in seeded])),
            "loss": float(np.mean([s["loss"] for s in seeded])), "seeded": seeded}


def transfer(results_root: str, env: dict, seeds=SEEDS[:3]) -> dict:
    """Every stage-B checkpoint, the port's chain's and the JAX package's,
    scored on stage C's held-out shard (T=64, dist 14) before any stage-C
    step: how well each start that C could be warmed from does there."""
    k = knobs(env)
    device = env.get("PATHTRACKER_TORCH_DEVICE") or None
    length, dist, _, _ = STAGES["C"]
    out = {}
    for who, folder in (("port", run_folder(results_root, "B", k)),
                        ("jax", os.path.dirname(JAX_CHAIN_B))):
        saved = os.path.join(folder, "saved_models") if who == "port" else folder
        for name in sorted(os.listdir(saved)) if os.path.isdir(saved) else ():
            if not name.endswith(".tar"):
                continue
            args = _eval_args(k, results_root, "C", device, os.path.join(saved, name),
                              jax=who == "jax")
            got = seeded_passes(args, dist, length, seeds)
            out.setdefault(who, {})[name] = got
            print(f"report: transfer [{who} B] {name} on C's shard: {_pct(got['acc'])} / "
                  f"{got['loss']:.4f} BCE (mean of {len(seeds)} seeded passes)", flush=True)
    return out


def _epoch(name: str) -> int | None:
    """The epoch in a best-val checkpoint's name (None for the rolling one)."""
    m = re.search(r"_epoch_(\d+)_", os.path.basename(name))
    return int(m.group(1)) if m else None


def jax_records(tag: str) -> dict:
    """The JAX package's held-out records of its chain{tag}'s checkpoints
    (one unseeded pass each: accuracy and BCE) by epoch: those of
    results/chain{tag}_eval_<val>_epoch_<NN>, and RECORDS' at the epoch of
    the checkpoint it scored."""
    length, dist, _, _ = STAGES[tag]
    name = f"test_perf_dist_{dist}_speed_{SPEED}_length_{length}.npz"
    paths = {int(re.search(r"_epoch_(\d+)$", os.path.dirname(p)).group(1)): p for p in
             glob.glob(os.path.join(ROOT, "results", f"chain{tag}_eval_*_epoch_*", name))}
    if tag in RECORDS:
        paths[_epoch({"B": JAX_CHAIN_B, "C": JAX_CHAIN_C}[tag])] = RECORDS[tag]["npz"]
    out = {}
    for epoch, path in sorted(paths.items()):
        saved = np.load(path)
        out[epoch] = {"acc": float(saved["arr_0"]), "loss": float(saved["arr_1"])}
    return out


def jax_curve(results_root: str, env: dict, tag: str = "C") -> dict:
    """Every best-val checkpoint of the JAX package's chain{tag}, in epoch
    order, through ``held_out`` (the report's seeded passes and the
    unseeded one), each beside the JAX package's own record at its epoch:
    the JAX run's held-out curve under the port's yardstick."""
    k = knobs(env)
    device = env.get("PATHTRACKER_TORCH_DEVICE") or None
    length, dist, _, _ = STAGES[tag]
    folder = os.path.dirname(JAX_CURVES[tag])
    records = jax_records(tag)
    out = {}
    for name in sorted(checkpoints(folder), key=_epoch):
        args = _eval_args(k, results_root, tag, device,
                          os.path.join(folder, "saved_models", name), jax=True)
        got = held_out(args, dist, length,
                       os.path.join(results_root, "results", f"jax_chain{tag}_curve"))
        epoch = _epoch(name)
        got.update(epoch=epoch, record=records.get(epoch))
        out[name] = got
        print(f"report: JAX chain{tag} epoch {epoch}: {_pct(got['acc'])} / "
              f"{got['loss']:.4f} BCE held-out (seeded mean, "
              f"{' to '.join(_pct(a) for a in got['acc_range'])}; unseeded "
              f"{_pct(got['unseeded']['acc'])}); its record "
              + ("none" if got["record"] is None else
                 f"{_pct(got['record']['acc'])} / {got['record']['loss']:.4f} BCE"),
              flush=True)
    return out


def checkpoints(folder: str, epochs=None) -> list[str]:
    """The checkpoint files of a run folder (those of ``epochs`` only,
    where given), by name."""
    saved = os.path.join(folder, "saved_models")
    names = sorted(n for n in (os.listdir(saved) if os.path.isdir(saved) else ())
                   if n.endswith(".tar"))
    return names if epochs is None else [n for n in names if _epoch(n) in epochs]


def started_from(b_folder: str, a_folder: str) -> dict | None:
    """The stage-A checkpoint a stage B started from (its hp_dict.npz's
    ``loaded_ckpt``; where B has not run, the one it would start from), its
    epoch, and that epoch after A's escape (A's first val epoch above
    ABOVE)."""
    hp = os.path.join(b_folder, "hp_dict.npz")
    if os.path.exists(hp):
        ckpt, ran = str(np.load(hp)["loaded_ckpt"]), True
    elif stage_done(a_folder):
        ckpt, ran = best_checkpoint(a_folder), False
    else:
        return None
    escape = (curve(os.path.join(a_folder, "val.npz")) or {}).get("first_above_75")
    epoch = _epoch(ckpt)
    return {"ckpt": os.path.basename(ckpt), "b_ran": ran, "epoch": epoch,
            "escape": escape, "after_escape": None if None in (epoch, escape)
            else epoch - escape}


def _describe_start(s: dict | None) -> str:
    if s is None:
        return "none (A has no checkpoint)"
    after = ("A never left the plateau" if s["escape"] is None
             else f"{s['after_escape']} epochs after A's escape at epoch {s['escape']}")
    return (f"{'started' if s['b_ran'] else 'would start'} from {s['ckpt']} "
            f"(epoch {s['epoch']}, {after})")


def transfer_a(results_root: str, env: dict, seeds=SEEDS[:3]) -> dict:
    """Every stage-A checkpoint of the chain and the JAX package's chainA
    checkpoints at JAX_A_EPOCHS, scored on B's held-out shard (T=32, dist 5)
    and on C's (T=64, dist 14) before any step there, each with its epoch
    after the escape; and the A checkpoint each B started from."""
    k = knobs(env)
    device = env.get("PATHTRACKER_TORCH_DEVICE") or None
    out = {}
    for who, a_folder, b_folder in (
            ("port", run_folder(results_root, "A", k), run_folder(results_root, "B", k)),
            ("jax", JAX_CHAIN_A, os.path.dirname(JAX_CURVES["B"]))):
        c = curve(os.path.join(a_folder, "val.npz"))
        escape = c and c["first_above_75"]
        saved = os.path.join(a_folder, "saved_models")
        rows = {}
        for name in checkpoints(a_folder, JAX_A_EPOCHS if who == "jax" else None):
            epoch = _epoch(name)
            if epoch is None and c is not None:  # the rolling checkpoint: the last epoch
                epoch = c["epochs"] - 1
            row = {"epoch": epoch, "after_escape": None if None in (epoch, escape)
                   else epoch - escape}
            for tag in ("B", "C"):
                length, dist, _, _ = STAGES[tag]
                args = _eval_args(k, results_root, tag, device, os.path.join(saved, name),
                                  jax=who == "jax")
                row[tag] = seeded_passes(args, dist, length, seeds)
            rows[name] = row
            print(f"report: transfer A [{who}] {name} (epoch {epoch}, "
                  f"{row['after_escape']} after the escape): B's shard "
                  f"{_pct(row['B']['acc'])} / {row['B']['loss']:.4f} BCE, C's shard "
                  f"{_pct(row['C']['acc'])} / {row['C']['loss']:.4f} BCE (means of "
                  f"{len(seeds)} seeded passes)", flush=True)
        start = started_from(b_folder, a_folder)
        print(f"report: transfer A [{who}] B {_describe_start(start)}", flush=True)
        out[who] = {"escape": escape, "checkpoints": rows, "b_started_from": start}
    return out


def _card() -> str | None:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _pct(x) -> str:
    return "-" if x is None else f"{100 * x:.2f}%"


def report(results_root: str, env: dict, every: bool = False,
           jax_curve_of: str | None = None) -> dict:
    """The chain's numbers beside the JAX package's; the summary dict.
    ``every``: also score each of B's and C's other checkpoints (every
    best-val one and the rolling one, which holds the raw weights, not
    C's EMA) on the same passes. ``jax_curve_of`` ("C"): also every
    checkpoint of the JAX package's chain of that stage (``jax_curve``)."""
    k = knobs(env)
    device = env.get("PATHTRACKER_TORCH_DEVICE") or None
    out = {"card": _card(), "device": device or "cuda", "stages": {}, "knobs": {
        n: k[n] for n in ("MODEL", "CELL", "BATCH", "SYNTH_TRAIN", "SYNTH_TEST",
                          "FUSED_STEPS", "EXTRA_FLAGS", "EPOCHS_A", "EPOCHS_B", "EPOCHS_C",
                          "EMA_C")}}
    print(f"report: card {out['card'] or 'none'}, device {out['device']}", flush=True)
    evals = os.path.join(results_root, "results")
    for tag, (length, dist, _, _) in STAGES.items():
        folder = run_folder(results_root, tag, k)
        row = {"curve": curve(os.path.join(folder, "val.npz")),
               "jax_curve": curve(JAX_CURVES[tag])}
        for name in ("curve", "jax_curve"):
            c = row[name]
            print(f"report: [{tag}] {'port' if name == 'curve' else 'JAX '} val meter: "
                  + ("none" if c is None else
                     f"{c['epochs']} epochs, first above {ABOVE:g}% at epoch "
                     f"{c['first_above_75']}, best {c['best']:.2f}% at epoch "
                     f"{c['best_epoch']}"), flush=True)
        if tag in RECORDS and stage_done(folder):
            args = _eval_args(k, results_root, tag, device, best_checkpoint(folder))
            row["held_out"] = held_out(args, dist, length,
                                       os.path.join(evals, f"{k['PFX']}chain{tag}_eval"))
            saved, best = os.path.join(folder, "saved_models"), os.path.abspath(args.ckpt)
            for name in sorted(os.listdir(saved)) if every else ():
                if name.endswith(".tar") and os.path.join(os.path.abspath(saved), name) != best:
                    args.ckpt = os.path.join(saved, name)
                    got = held_out(args, dist, length,
                                   os.path.join(evals, f"{k['PFX']}chain{tag}_every"))
                    row.setdefault("every_checkpoint", {})[name] = got
                    print(f"report: [{tag}] {name}: {_pct(got['acc'])} / {got['loss']:.4f} "
                          f"BCE held-out (seeded mean; unseeded "
                          f"{_pct(got['unseeded']['acc'])})", flush=True)
        if tag == "B":
            row["started_from"] = started_from(folder, run_folder(results_root, "A", k))
            print(f"report: [B] {_describe_start(row['started_from'])}", flush=True)
        out["stages"][tag] = row
    if jax_curve_of:
        out["jax_curve"] = {"stage": jax_curve_of,
                            "checkpoints": jax_curve(results_root, env, jax_curve_of)}
    for tag, ckpt in (("B", JAX_CHAIN_B), ("C", JAX_CHAIN_C)):
        scored = (out.get("jax_curve") or {}).get("checkpoints", {})
        if jax_curve_of == tag and os.path.basename(ckpt) in scored:
            out[f"jax_chain{tag}"] = scored[os.path.basename(ckpt)]
        else:
            length, dist, _, _ = STAGES[tag]
            out[f"jax_chain{tag}"] = held_out(
                _eval_args(k, results_root, tag, device, ckpt, jax=True), dist, length,
                os.path.join(evals, f"jax_chain{tag}_eval"))
    verdicts = {}
    for tag, record in RECORDS.items():
        saved = np.load(record["npz"])
        want = {"acc": float(saved["arr_0"]), "loss": float(saved["arr_1"])}
        got = out["stages"][tag].get("held_out")
        runs = [want["acc"], *record["other_runs"]]
        line = (f"report: [{tag}] held-out: port {_pct(got and got['acc'])} / "
                f"{'-' if got is None else format(got['loss'], '.4f')} BCE, the mean of "
                f"{len(SEEDS)} seeded passes ("
                f"{'-' if got is None else ' to '.join(_pct(a) for a in got['acc_range'])}; "
                f"unseeded {_pct(got and got['unseeded']['acc'])}); "
                f"JAX record {_pct(want['acc'])} / {want['loss']:.4f} BCE, other runs "
                f"{', '.join(_pct(a) for a in record['other_runs'])}; greedy "
                f"{_pct(record['greedy'])}")
        print(line, flush=True)
        out["stages"][tag]["jax_record"] = dict(want, other_runs=record["other_runs"],
                                                greedy=record["greedy"])
        verdicts[tag] = None if got is None else bool(got["acc"] >= min(runs) - MARGIN)
    for tag, ckpt in (("B", JAX_CHAIN_B), ("C", JAX_CHAIN_C)):
        jx = out[f"jax_chain{tag}"]
        record_acc = float(np.load(RECORDS[tag]["npz"])["arr_0"])
        bar = min(record_acc, *RECORDS[tag]["other_runs"]) - MARGIN
        inside = verdicts[f"jax_chain{tag}_in_spread"] = bool(
            jx["acc_range"][0] <= record_acc <= jx["acc_range"][1])
        verdicts[f"jax_chain{tag}_above_bar"] = bool(jx["acc"] >= bar)
        print(f"report: JAX chain{tag} (epoch {_epoch(ckpt)}) scored by the port on "
              f"{tag}'s shard: {_pct(jx['acc'])} / {jx['loss']:.4f} BCE seeded mean, seeded "
              f"passes {' to '.join(_pct(a) for a in jx['acc_range'])}, unseeded "
              f"{_pct(jx['unseeded']['acc'])}; its record {_pct(record_acc)} "
              f"{'inside' if inside else 'outside'} the spread; the bar {_pct(bar)}",
              flush=True)
    curve_a = out["stages"]["A"]["curve"]
    verdicts["A_left_plateau"] = (None if curve_a is None
                                  else curve_a["first_above_75"] is not None)
    out["verdicts"] = verdicts
    print(f"report: verdicts {verdicts} (a stage lands within {100 * MARGIN:g} points "
          "of the lower JAX record)", flush=True)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--stage-run"]:  # one stage of an eager chain (run_stage)
        return stage_run(argv[1], argv[2:])
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--report", action="store_true",
                   help="run the report alone (the chain runs it at its end)")
    p.add_argument("--every-checkpoint", action="store_true",
                   help="the report also scores B's and C's other checkpoints")
    p.add_argument("--jax-curve", default=None, choices=("C",),
                   help="the report also scores every checkpoint of the JAX package's "
                        "chain of this stage under its seeded passes")
    p.add_argument("--transfer", nargs="?", const="B", choices=("A", "B"),
                   help="instead of the report, score every checkpoint of the stage "
                        "(default B), the chain's and the JAX package's, on the shards of "
                        "the stages after it")
    p.add_argument("--until", default=None, choices=tuple(STAGES),
                   help="stop the chain after this stage, without the report")
    p.add_argument("--data-root", default=None,
                   help="where the configs are rendered (default $PATHTRACKER_DATA_ROOT, "
                        "else build/chain/data)")
    p.add_argument("--results-root", default=os.path.join(ROOT, "build", "chain"),
                   help="where the run folders, stage logs and eval folders go")
    a = p.parse_args(argv)
    results_root = os.path.abspath(a.results_root)
    data_root = os.path.abspath(a.data_root or os.environ.get("PATHTRACKER_DATA_ROOT")
                                or os.path.join(ROOT, "build", "chain", "data"))
    os.environ["PATHTRACKER_DATA_ROOT"] = data_root
    os.environ.setdefault("PATHTRACKER_DOT_SIZE", "2")
    # A root the report finds missing is rendered as the stages render theirs.
    k = knobs()
    os.environ["PATHTRACKER_SYNTH_TRAIN"] = k["SYNTH_TRAIN"]
    os.environ["PATHTRACKER_SYNTH_TEST"] = k["SYNTH_TEST"]
    env = dict(os.environ)
    if not (a.report or a.transfer) and not chain(results_root, env, a.until or "C"):
        return 1
    if a.transfer == "A":
        print(json.dumps({"transfer_a": transfer_a(results_root, env)}), flush=True)
        return 0
    if a.transfer:
        print(json.dumps({"transfer": transfer(results_root, env)}), flush=True)
        return 0
    if a.until and not a.report:
        return 0
    print(json.dumps(report(results_root, env, a.every_checkpoint, a.jax_curve)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
