"""Train / eval steps (pathtracker_tpu/train/steps.py).

One step: batch prep from the raw uint8 batch, forward (family-dispatched),
BCE loss (+ optional Jacobian penalty * 10, reference mainclean.py:195-196),
backward, the optimizer update, and the train metrics — no host sync except
one packed fetch of the step's scalars for logging.

The JAX package builds its optimizer from optax; this module writes the same
transformations out over torch tensors and is held to optax by the tests:
Adam(0.9, 0.999, 1e-8) with the learning rate read from a schedule indexed
by optimizer step, optax's global-norm clip, ``MultiSteps`` accumulation and
a parameter EMA that moves on every micro-step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pathtracker_torch.data.prepare import prepare_batch
from pathtracker_torch.engine import model_step
from pathtracker_torch.train.torch_import import state_dict_from_jax, to_jax_params
from pathtracker_torch.utils.metrics import (acc_scores, bce_with_logits,
                                             eval_accuracy)

TRAIN_KEYS = ("loss", "scaled_loss", "jvpen", "balacc", "precision", "recall",
              "f1score")
EVAL_KEYS = ("loss", "balacc", "precision", "recall", "f1score", "acc")


# ------------------------------- schedules ----------------------------------

def piecewise_constant_schedule(init_value: float, boundaries_and_scales: dict):
    """optax's: ``init_value`` times every scale whose boundary b has
    step >= b."""
    items = sorted((int(b), float(s)) for b, s in boundaries_and_scales.items())

    def schedule(step: int) -> float:
        value = init_value
        for boundary, scale in items:
            if step >= boundary:
                value *= scale
        return value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax's: cosine from ``init_value`` to ``alpha * init_value`` over
    ``decay_steps`` steps, constant after."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(step: int) -> float:
        frac = min(step, decay_steps) / decay_steps
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax's: linear ``init_value`` -> ``peak_value`` over ``warmup_steps``,
    then cosine to ``end_value``; ``decay_steps`` is the TOTAL length, the
    warmup included."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return init_value + (peak_value - init_value) * step / warmup_steps
        return cosine(step - warmup_steps)

    return schedule


def build_lr_schedule(kind: str, lr: float, steps_per_epoch: int,
                      epochs: int, lr_steps=None,
                      warmup_epochs: float = 0.0, gamma: float = 0.1,
                      start_step: int = 0):
    """Learning-rate schedule (optimizer step -> float) from epoch-level
    knobs, or None.

    The reference *defined* a StepLR(step_size from --lr_steps) and never
    stepped it (reference mainclean.py:160), so ``kind='none'`` — constant lr
    — is the parity default. The other kinds make the flag real:

      step          — x``gamma`` at each epoch boundary in ``lr_steps``
      cosine        — cosine decay from lr to 0 over the full run
      warmup_cosine — linear 0->lr over ``warmup_epochs``, then cosine

    Schedules are indexed by OPTIMIZER step, so ``steps_per_epoch`` must
    already account for gradient accumulation. ``start_step`` offsets the
    schedule for resumed runs (fresh Adam state restarts its count at 0,
    but the decay should continue where the previous run stopped)."""
    if not kind or kind == "none":
        return None
    spe = max(1, int(steps_per_epoch))
    total = max(1, int(epochs) * spe)
    if kind == "step":
        base = piecewise_constant_schedule(
            lr, {int(float(e) * spe): gamma for e in (lr_steps or [])})
    elif kind == "cosine":
        base = cosine_decay_schedule(lr, total)
    elif kind == "warmup_cosine":
        warm = max(1, int(float(warmup_epochs) * spe))
        base = warmup_cosine_decay_schedule(0.0, lr, warm, total)
    else:
        raise ValueError(f"unknown lr schedule '{kind}'")
    if start_step:
        return lambda step: base(step + start_step)
    return base


# ------------------------------- optimizer ----------------------------------

class Optimizer:
    """Adam over a fixed list of parameter tensors, updated in place, with
    the JAX package's optional transformations in optax's order: EMA
    outermost, then accumulation, then the clip, then Adam.

    ``init(params)`` binds the parameters and allocates the state;
    ``step(grads)`` takes one (micro-)gradient per parameter, ``None``
    standing for zeros as optax sees an unused parameter: its update is
    zero and it stays as it is."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, lr, clip_grad=None, accum_steps=1):
        self.lr = lr  # a float or a schedule: optimizer step -> float
        self.clip_grad = clip_grad
        self.accum_steps = max(1, int(accum_steps))
        self.ema_decay = None  # see with_ema
        self.params = None

    def init(self, params) -> "Optimizer":
        self.params = [p.detach() for p in
                       (params.values() if isinstance(params, dict) else params)]
        self.count = 0  # optimizer steps taken
        self.mini_step = 0  # micro-steps into the accumulation window
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.accum_steps > 1 else None)
        # Real copies: the parameters are updated in place.
        self.ema = ([p.clone() for p in self.params]
                    if self.ema_decay is not None else None)
        return self

    def learning_rate(self) -> float:
        """The rate the next optimizer step uses: ``schedule(steps taken)``."""
        return float(self.lr(self.count) if callable(self.lr) else self.lr)

    @torch.no_grad()
    def step(self, grads) -> None:
        if self.params is None:
            raise RuntimeError("Optimizer.init(params) was not called")
        grads = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                 for g, p in zip(grads, self.params, strict=True)]
        if self.acc is not None:
            # optax.MultiSteps: a running mean of the window's micro-gradients;
            # no update until the window's last micro-step.
            torch._foreach_add_(self.acc, torch._foreach_sub(grads, self.acc),
                                alpha=1.0 / (self.mini_step + 1))
            self.mini_step = (self.mini_step + 1) % self.accum_steps
            if self.mini_step == 0:
                self._adam(self.acc)
                torch._foreach_zero_(self.acc)
        else:
            self._adam(grads)
        if self.ema is not None:  # outermost: on every micro-step
            torch._foreach_mul_(self.ema, self.ema_decay)
            torch._foreach_add_(self.ema, self.params, alpha=1.0 - self.ema_decay)

    def _adam(self, grads) -> None:
        if self.clip_grad is not None:
            # optax.clip_by_global_norm: g * clip / max(norm, clip), with no
            # epsilon in the denominator.
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = self.clip_grad / norm.clamp_min(self.clip_grad)
            grads = torch._foreach_mul(grads, scale)
        lr = self.learning_rate()
        self.count += 1
        torch._foreach_lerp_(self.mu, grads, 1.0 - self.B1)
        torch._foreach_mul_(self.nu, self.B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.B2)
        # update = -lr * mu_hat / (sqrt(nu_hat) + eps)
        denom = torch._foreach_div(self.nu, 1.0 - self.B2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        torch._foreach_addcdiv_(self.params, self.mu, denom,
                                value=-lr / (1.0 - self.B1 ** self.count))

    # ---- the optimizer state in the JAX package's layout -------------------

    def state_dict(self, names) -> dict:
        """The state as ``flax.serialization.to_state_dict`` writes the optax
        state of pathtracker_tpu/train/steps.py::make_optimizer for the same
        options, so that each package resumes the other's checkpoints:

            adam                {"0": {count, mu, nu}, "1": {} or {count}}
            clip_grad           {"0": {}, "1": <adam>}
            accum_steps > 1     {mini_step, gradient_step,
                                 inner_opt_state: <above>, acc_grads, skip_state: {}}
            ema                 {"0": <above>, "1": <EMA params>}

        The "1" of adam holds the schedule's step count when the rate is a
        schedule. Counts are int32 0-d arrays; ``mu``, ``nu``, ``acc_grads``
        and the EMA are keyed and laid out like the JAX params
        (``torch_import.to_jax_params`` of ``{name: tensor}``, ``names`` the
        state_dict keys of the parameters in order)."""
        def tree(tensors):
            return to_jax_params(dict(zip(names, tensors, strict=True)))

        count = np.asarray(self.count, np.int32)
        out = {"0": {"count": count, "mu": tree(self.mu), "nu": tree(self.nu)},
               "1": {"count": count} if callable(self.lr) else {}}
        if self.clip_grad is not None:
            out = {"0": {}, "1": out}
        if self.acc is not None:
            out = {"mini_step": np.asarray(self.mini_step, np.int32),
                   "gradient_step": count, "inner_opt_state": out,
                   "acc_grads": tree(self.acc), "skip_state": {}}
        if self.ema is not None:
            out = {"0": out, "1": tree(self.ema)}
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict, names, model_name: str) -> None:
        """Restore a tree that ``state_dict`` (or the JAX package) wrote for
        the same options and parameters of a ``model_name`` model. A tree of
        other options or shapes raises KeyError, TypeError or ValueError and
        changes nothing."""
        _same_structure(self.state_dict(names), state, "opt_state")

        def tensors(tree):
            sd = state_dict_from_jax(model_name, tree)
            return [sd[n] for n in names]

        node, restore = state, []
        if self.ema is not None:
            node = state["0"]
            restore.append((self.ema, tensors(state["1"])))
        if self.acc is not None:
            restore.append((self.acc, tensors(node["acc_grads"])))
            mini_step = int(node["mini_step"])
            node = node["inner_opt_state"]
        if self.clip_grad is not None:
            node = node["1"]
        restore += [(self.mu, tensors(node["0"]["mu"])),
                    (self.nu, tensors(node["0"]["nu"]))]
        for dst, src in restore:
            for d, x in zip(dst, src, strict=True):
                d.copy_(x)  # onto the parameters' device
        self.count = int(node["0"]["count"])
        if self.acc is not None:
            self.mini_step = mini_step


def _same_structure(want, got, where: str) -> None:
    """Raise unless ``got`` has the nested keys and leaf shapes of ``want``."""
    if isinstance(want, dict):
        if not isinstance(got, dict):
            raise TypeError(f"{where}: a {type(got).__name__} where a map belongs")
        if set(want) != set(got):
            raise KeyError(f"{where}: keys {sorted(got)}, expected {sorted(want)}")
        for k in want:
            _same_structure(want[k], got[k], f"{where}/{k}")
    elif np.shape(want) != np.shape(got):
        raise ValueError(f"{where}: shape {np.shape(got)}, expected {np.shape(want)}")


def make_optimizer(lr: float, lr_steps=None, gamma: float = 0.1,
                   clip_grad: float | None = None,
                   accum_steps: int = 1,
                   ema: float | None = None,
                   schedule=None) -> Optimizer:
    """Adam with torch defaults (reference mainclean.py:157), unbound: call
    ``.init(params)`` or hand it to ``make_train_step``.

    lr_steps: optional step boundaries for a StepLR-style piecewise decay
    (x``gamma`` at each boundary). The reference *defined* a StepLR but never
    stepped it (reference mainclean.py:160); the capability is here for
    real use.

    schedule: a prebuilt schedule (see build_lr_schedule) — takes precedence
    over lr/lr_steps.

    clip_grad: optional global-norm gradient clip applied before Adam. The
    reference's clip_grad_norm_ is print-only (``do=False``,
    misc_functions.py:48-69) so the parity default is None.

    accum_steps: average the gradients of K micro-batches and apply Adam
    once per window. ema: keep a Polyak average of the parameters,
    ema <- decay*ema + (1-decay)*p after every micro-step; read it back with
    ``ema_params``."""
    if schedule is None and lr_steps:
        schedule = piecewise_constant_schedule(lr, {int(s): gamma for s in lr_steps})
    optimizer = Optimizer(schedule if schedule is not None else lr, clip_grad,
                          accum_steps)
    return optimizer if ema is None else with_ema(optimizer, ema)


def with_ema(optimizer: Optimizer, decay: float) -> Optimizer:
    """Make ``optimizer`` carry an exponential moving average of the
    PARAMETERS (Polyak averaging): ema <- decay*ema + (1-decay)*p after
    every update, the zero updates inside an accumulation window included.
    Evaluating or checkpointing the EMA weights smooths over the
    epoch-to-epoch wobble of long-horizon fine-tunes without touching the
    training trajectory."""
    optimizer.ema_decay = decay
    if optimizer.params is not None:
        optimizer.ema = [p.clone() for p in optimizer.params]
    return optimizer


def ema_params(optimizer: Optimizer):
    """The EMA parameter tensors of an optimizer built with ``ema=``, in the
    order of its parameters."""
    if optimizer.ema is None:
        raise ValueError("the optimizer keeps no EMA (make_optimizer(ema=...))")
    return optimizer.ema


# ---------------------------------- steps -----------------------------------

def make_train_step(model, model_name: str, optimizer: Optimizer,
                    penalty: bool = False, prepare_kwargs: dict | None = None,
                    seed: int = 0):
    """Build the step: ``train_step(raw_imgs, raw_labels) -> stats``. It
    consumes the *raw uint8* batch (tensors or arrays; normalization and
    layout run on the model's device), updates the model's parameters in
    place and returns the TRAIN_KEYS scalars from one packed host fetch.
    ``optimizer`` is bound to the model's parameters here unless it already
    is. ``seed`` seeds the generator of the models' stochastic layers; the
    recurrent family has none."""
    prep = dict(prepare_kwargs or {})
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    if optimizer.params is None:
        optimizer.init(params)
    generator = torch.Generator(device=device).manual_seed(seed)

    def train_step(raw_imgs, raw_labels):
        raw_imgs = torch.as_tensor(raw_imgs).to(device)
        raw_labels = torch.as_tensor(raw_labels).to(device)
        imgs, target = prepare_batch(raw_imgs, raw_labels, **prep)
        output, jv_penalty = model_step(model, imgs, model_name,
                                        generator=generator)
        loss = bce_with_logits(output, target)
        jv = jv_penalty.mean()
        total = loss + jv * 1e1 if penalty else loss
        optimizer.step(torch.autograd.grad(total, params, allow_unused=True))
        with torch.no_grad():
            packed = torch.stack([loss.float(), total.float(), jv.float(),
                                  *acc_scores(raw_labels.float(), output)])
        host = packed.cpu().numpy()  # single host fetch / sync point
        return dict(zip(TRAIN_KEYS, host))

    return train_step


def make_eval_step(model, model_name: str, prepare_kwargs: dict | None = None):
    """``eval_step(raw_imgs, raw_labels) -> stats``: the EVAL_KEYS scalars
    from one packed host fetch, and ``output``, the logits, left on the
    device."""
    prep = dict(prepare_kwargs or {})
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(raw_imgs, raw_labels):
        raw_imgs = torch.as_tensor(raw_imgs).to(device)
        raw_labels = torch.as_tensor(raw_labels).to(device)
        imgs, target = prepare_batch(raw_imgs, raw_labels, **prep)
        output, _ = model_step(model, imgs, model_name)
        packed = torch.stack([bce_with_logits(output, target).float(),
                              *acc_scores(target, output),
                              eval_accuracy(target, output)])
        stats = dict(zip(EVAL_KEYS, packed.cpu().numpy()))  # one scalar fetch
        stats["output"] = output
        return stats

    return eval_step
