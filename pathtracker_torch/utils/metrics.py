"""Training metrics with the reference's exact (quirky) semantics
(pathtracker_tpu/utils/metrics.py).

reference utils/misc_functions.py:12-45 defines:
  * train-time ``acc_scores(target, logits)``: prediction = logit > 0.5 —
    thresholding *logits* at 0.5 (not 0), which biases the train meter low;
    deliberately reproduced because the logged curves feed checkpoint
    selection downstream;
  * bal-acc = mean(pred == target) * 100 (not actually class-balanced);
  * recall = tp / batch_size (sic, denominator is the whole batch);
  * precision = tp / max(#predicted-positive, 1e-6);
  * f1 = 2*tp / (batch_size + #predicted-positive).

Eval scripts instead use logit > 0 (reference test_model.py:127); that is
``eval_accuracy`` here. Tensors in, 0-d f32 tensors out on the inputs'
device: nothing here fetches a value to the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pathtracker_torch.parallel.mesh import active_mesh, psum


def _scores(target, pred):
    """The four scores from the batch's counts: correct predictions, true
    positives, predicted positives and clips. Under a data group
    (parallel/mesh.py) the counts are summed over the ranks first, so the
    scores are the global batch's, as the JAX package computes them on its
    sharded batch; averaging the ranks' scores would not be (precision and
    f1 are not linear in the counts)."""
    correct = (pred == target).float()
    tp = (correct * (target == 1)).sum()
    n_correct, n_pred, batch = correct.sum(), pred.sum(), target.shape[0]
    if active_mesh() is not None:
        n_correct, tp, n_pred, batch = psum(torch.stack(
            [n_correct, tp, n_pred, torch.full_like(tp, batch)])).unbind()
    tpfp = n_pred.clamp_min(1e-6)
    return (n_correct / batch * 100.0, tp / tpfp, tp / batch,
            (2.0 * tp) / (batch + tpfp))


def acc_scores(target, logits):
    """Train-meter metrics. target [B] in {0,1}; logits [B,1] or [B].

    Returns (balacc*100, precision, recall, f1) as 0-d tensors."""
    return _scores(target.reshape(-1).float(),
                   (logits.reshape(-1) > 0.5).float())


def eval_accuracy(target, logits):
    """Eval accuracy: mean(target == (logit > 0)) (reference test_model.py:127)."""
    pred = (logits.reshape(-1) > 0.0).float()
    return (target.reshape(-1).float() == pred).float().mean()


def bce_with_logits(logits, target):
    """Mean BCEWithLogitsLoss (reference mainclean.py:156,190)."""
    z = logits.reshape(-1)
    y = target.reshape(-1).to(z.dtype)
    return (z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()


def metric_scores(target, preds):
    """Metrics from already-thresholded byte predictions (reference
    utils/misc_functions.py:12-29): the denominators of ``acc_scores`` with
    preds given, not derived from logits."""
    return _scores(target.reshape(-1).float(), preds.reshape(-1).float())


def accuracy_topk(output, target, topk=(1,)):
    """Top-k accuracy over class logits [B, K] (reference
    utils/misc_functions.py:138-151). Returns one value per k, in percent."""
    target = target.reshape(-1)
    # A stable ascending sort reversed, as the JAX package sorts: a tie goes
    # to the higher class index.
    idx = output.argsort(dim=-1, stable=True).flip(-1)[:, :max(topk)]
    correct = (idx == target[:, None]).float()
    return [correct[:, :k].sum() * (100.0 / target.shape[0]) for k in topk]


def focal_loss(logits, target, gamma: float = 0.0, alpha: float | None = None):
    """Binary focal loss on logits (reference utils/misc_functions.py:83-114
    defined this for softmax inputs but never used it; provided in the binary
    form that matches this task's single-logit contract)."""
    z = logits.reshape(-1)
    y = target.reshape(-1).to(z.dtype)
    logpt = y * F.logsigmoid(z) + (1 - y) * F.logsigmoid(-z)
    loss = -((1 - logpt.exp()) ** gamma) * logpt
    if alpha is not None:
        loss = loss * (y * alpha + (1 - y) * (1 - alpha))
    return loss.mean()
