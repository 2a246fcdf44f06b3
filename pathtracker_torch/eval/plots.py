"""Result plotting and GIF writing (pathtracker_tpu/eval/plots.py; reference
utils/engine.py:272-340).

Per-clip panels of Img / Attn (mean squared attention gate) / Activity
(squared state map) at 8-frame strides, plus per-timestep GIFs for the
first ``prep_gifs`` clips. Inputs may be numpy arrays or tensors on any
device. matplotlib (Agg backend) and imageio are imported when a plot is
drawn, never at import: a machine without them evaluates with
``prep_gifs=0``.
"""

from __future__ import annotations

import os

import numpy as np


def _to_numpy(x):
    if hasattr(x, "detach"):  # a tensor, on any device
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def plot_results(states, imgs, target, output, timesteps, gates=None,
                 prep_gifs=False, results_folder=None, show_fig=False):
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    states = _to_numpy(states)  # [B,T,1,H,W]
    gates = _to_numpy(gates) if gates is not None else np.zeros_like(states)
    img = _to_numpy(imgs)  # [B,C,T,H,W]
    target = _to_numpy(target).reshape(-1)
    output = _to_numpy(output).reshape(-1)

    correct = target == (output > 0).astype(target.dtype)
    sel_idx = np.where(correct)[0]
    sel = int(sel_idx[0]) if len(sel_idx) else 0

    cols = int(timesteps / 8) + 1
    rng = np.concatenate((np.arange(0, timesteps, 8), [timesteps - 1]))
    fig = plt.figure()
    for idx, i in enumerate(rng):
        plt.subplot(3, cols, idx + 1)
        plt.axis("off")
        plt.imshow(np.clip(img[sel, :, i].transpose(1, 2, 0), 0, 1))
        plt.title("Img")
        plt.subplot(3, cols, idx + 1 + cols)
        plt.axis("off")
        plt.imshow((gates[sel, i].squeeze() ** 2).mean(0)
                   if gates[sel, i].squeeze().ndim == 3 else gates[sel, i].squeeze() ** 2)
        plt.title("Attn")
        plt.subplot(3, cols, idx + 1 + cols + (cols - 1))
        plt.title("Activity")
        plt.axis("off")
        plt.imshow(np.abs(states[sel, i].squeeze()))
    acc = float(np.mean(target == (output > 0)))
    plt.suptitle(f"Batch acc: {acc}, Prediction: {output[sel]}, Label: {target[sel]}")
    if results_folder is not None:
        plt.savefig(os.path.join(results_folder, "random_selection.pdf"))
    if show_fig:
        plt.show()
    plt.close(fig)

    if prep_gifs:
        import imageio.v2 as imageio

        assert isinstance(prep_gifs, int), \
            "prep_gifs is an integer that says how many gifs to prepare"
        assert results_folder is not None, "if prepping gifs, also pass a results folder."
        n_gifs = min(prep_gifs, img.shape[0])
        for g in range(n_gifs):
            gif_dir = os.path.join(results_folder, f"gif_{g}")
            os.makedirs(gif_dir, exist_ok=True)
            filenames = []
            for idx in range(img.shape[2]):
                fig = plt.figure(dpi=100)
                plt.subplot(1, 3, 1)
                plt.axis("off")
                plt.imshow(np.clip(img[g, :, idx].transpose(1, 2, 0), 0, 1))
                plt.title("Img")
                plt.subplot(1, 3, 2)
                plt.axis("off")
                gate_map = gates[g, idx].squeeze()
                plt.imshow((gate_map ** 2).mean(0) if gate_map.ndim == 3 else gate_map ** 2)
                plt.title("Attn")
                plt.subplot(1, 3, 3)
                plt.title("Activity")
                plt.axis("off")
                plt.imshow(states[g, idx].squeeze() ** 2)
                plt.suptitle(f"Prediction: {output[g] > 0}, Label: {target[g] == 1}")
                out_path = os.path.join(gif_dir, f"{idx}.png")
                plt.savefig(out_path)
                plt.close(fig)
                filenames.append(out_path)
            gif_path = os.path.join(gif_dir, f"{g}.gif")
            with imageio.get_writer(gif_path, mode="I") as writer:
                for filename in filenames:
                    writer.append_data(imageio.imread(filename))
                    os.remove(filename)
