"""Attribution visualization (pathtracker_tpu/eval/viz.py): the reference's
viz_model_att.py flow, with ``torch.autograd.grad`` with respect to the
prepared clips.

Loads a run's best checkpoint (or ``--ckpt``), loads the per-clip human
responses (``load_human_responses``: the MTurk asset, else greedy-tracker
proxies over the same clips, else seeded placeholders), runs the model in
test mode, takes MSE(model logits, logit(human)) and its input gradient,
splits it into positive and negative saliency, and saves
mturk_visualizations_{set_name}.npz with attention/states/grads/imgs of the
correct, positive clips, plus the model-vs-human accuracy printout
(reference viz_model_att.py:148-215).

    python -m pathtracker_torch.eval.viz --model InT --length 64 --speed 1 \\
        --dist 25 --set_name gen_1_25_64 -b 40 --bf16 --ckpt <checkpoint>

The parameters keep ``requires_grad=False``: only the clips are
differentiated. Under ``--bf16`` at 32 channels the fused cell serves the
test-mode forward, so every K1-K3 forward and backward kernel runs once a
frame (K1's backward without the attention map's cotangent: the maps are
only read out).
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from pathtracker_torch import engine
from pathtracker_torch.data.pipeline import tfr_data_loader
from pathtracker_torch.data.prepare import prepare_batch
from pathtracker_torch.train import checkpoint as ckpt_lib
from pathtracker_torch.train.loop import init_model, results_folder_for
from pathtracker_torch.utils.opts import parser


def load_human_responses(set_name: str, n_clips: int,
                         responses_dir: str = "mturk_responses",
                         shard_pattern: str | None = None,
                         timesteps: int | None = None) -> np.ndarray:
    """Per-clip averaged human responses for ``set_name`` (viz.py:30-53).

    The reference's MTurk asset when present (reference
    viz_model_att.py:148-152; it ships nowhere public). Absent that, a
    PROXY: the greedy nearest-neighbor tracker over the clips the viz loop
    reads (eval/greedy.py); with no shards, seeded placeholders."""
    path = os.path.join(responses_dir, f"{set_name}_average_responses.npy")
    if os.path.exists(path):
        return np.load(path)
    if shard_pattern is not None:
        from pathtracker_torch.eval.greedy import greedy_responses_for_shards

        print(f"WARNING: {path} not found; using greedy-tracker proxy "
              "responses computed on the evaluation clips.")
        return greedy_responses_for_shards(shard_pattern, timesteps, n_clips)
    print(f"WARNING: {path} not found; synthesizing placeholder human responses.")
    rng = np.random.default_rng(0)
    return rng.uniform(0.05, 0.95, size=(n_clips,)).astype(np.float32)


def attribution_step(model, model_name: str, raw_imgs, raw_labels, human_probs,
                     prepare_kwargs: dict | None = None):
    """One batch (viz.py:78-93): uint8 clips, byte labels and the clips'
    human probabilities in; (output, states, gates, pos_grads, neg_grads,
    imgs, target) out, on the model's device, the gradient of
    mean((logit - logit(human))^2) with respect to the prepared clips."""
    device = next(model.parameters()).device
    raw_imgs = torch.as_tensor(raw_imgs).to(device)
    raw_labels = torch.as_tensor(raw_labels).to(device)
    hp = torch.as_tensor(human_probs, dtype=torch.float32).to(device)
    imgs, target = prepare_batch(raw_imgs, raw_labels, **(prepare_kwargs or {}))
    imgs.requires_grad_()
    with torch.enable_grad():
        output, states, gates = engine.model_step(model, imgs, model_name, test=True)
        human_logit = torch.log(hp) - torch.log1p(-hp)
        score = torch.mean((output.reshape(-1) - human_logit) ** 2)
        (grads,) = torch.autograd.grad(score, [imgs])
    return (output.detach(), states.detach(), gates.detach(), torch.relu(grads),
            torch.relu(-grads), imgs.detach(), target)


def evaluate_model(args, results_folder: str, batch_size: int | None = None):
    """The viz loop over ``args.set_name``'s test split (viz.py:56-133);
    returns (model accuracy, human accuracy)."""
    if batch_size is None:
        batch_size = getattr(args, "batch_size", 40)
    set_name = args.set_name or "gen_1_25_64"
    pf_root, timesteps, _, len_val = engine.human_dataset_selector(set_name)
    loader = tfr_data_loader(
        data_dir=os.path.join(pf_root, "test-*"), batch_size=batch_size,
        drop_remainder=True, shuffle_buffer=0, timesteps=timesteps)

    model_name = engine.fix_model_name(args.model)
    margs = SimpleNamespace(**vars(args))
    margs.model = model_name
    model = init_model(margs, timesteps)
    engine.load_ckpt(model, args.ckpt, strict=False)
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)

    human = load_human_responses(
        set_name, len_val,
        shard_pattern=os.path.join(pf_root, "test-*"), timesteps=timesteps)
    prep = {"pretrained_norm": getattr(args, "pretrained", False)}

    all_out = {"attention": [], "states": [], "pos_grads": [], "neg_grads": [],
               "imgs": [], "targets": [], "outputs": [], "human": []}
    model_correct, human_correct, count = 0, 0, 0
    offset = 0
    for raw_imgs, raw_labels in loader:
        b = raw_imgs.shape[0]
        hp = (np.clip(human[offset:offset + b], 1e-4, 1 - 1e-4)
              if offset + b <= len(human) else np.full((b,), 0.5, np.float32))
        output, states, gates, pos_g, neg_g, imgs, target = attribution_step(
            model, model_name, raw_imgs, raw_labels, hp, prep)
        output = output.cpu().numpy().reshape(-1)
        target = target.cpu().numpy().reshape(-1)
        hp = np.asarray(hp)
        model_pred = (output > 0).astype(np.float32)
        human_pred = (hp > 0.5).astype(np.float32)
        model_correct += float((model_pred == target).sum())
        human_correct += float((human_pred == target).sum())
        count += b
        # Keep correct-and-positive clips, like the reference (:200-213).
        keep = np.where((model_pred == target) & (target == 1))[0]
        if len(keep):
            idx = torch.as_tensor(keep, device=gates.device)
            all_out["attention"].append(gates[idx].cpu().numpy())
            all_out["states"].append(states[idx].cpu().numpy())
            all_out["pos_grads"].append(pos_g[idx].cpu().numpy())
            all_out["neg_grads"].append(neg_g[idx].cpu().numpy())
            all_out["imgs"].append(imgs[idx].cpu().numpy())
            all_out["targets"].append(target[keep])
            all_out["outputs"].append(output[keep])
            all_out["human"].append(hp[keep])
        offset += b

    os.makedirs(results_folder, exist_ok=True)
    np.savez(
        os.path.join(results_folder, f"mturk_visualizations_{set_name}"),
        **{k: np.concatenate(v) if v else np.zeros((0,)) for k, v in all_out.items()})
    print(f"Model accuracy: {model_correct / max(count, 1)}, "
          f"human accuracy: {human_correct / max(count, 1)}")
    return model_correct / max(count, 1), human_correct / max(count, 1)


def main(args=None):
    if args is None:
        args = parser.parse_args()
    results_folder = os.path.join("results", str(args.name))
    if args.ckpt is None:
        candidates = [results_folder]
        if args.length is not None:
            candidates.insert(0, results_folder_for(args))
        directory = next((c for c in candidates
                          if os.path.exists(os.path.join(c, "val.npz"))), None)
        if directory is None:
            raise FileNotFoundError(f"no val.npz under {candidates}; pass --ckpt")
        args.ckpt = ckpt_lib.find_best_checkpoint(directory)
    return evaluate_model(args, results_folder)


if __name__ == "__main__":
    main()
