"""Training loop (port of ``repro.train.train_loop``): a train step with
microbatch gradient accumulation and a gradient hook, the host loop, and
a straggler monitor.

Params are nested dicts of tensors, trained as leaves: each step detaches
them, marks them ``requires_grad_()`` and takes ``torch.autograd.grad`` of
the loss, so the state holds plain tensors between steps and no module or
optimizer object is involved. Gradients flow through plain PyTorch ops (the
reference defines no custom gradient). A step never runs under
``torch.inference_mode()``: the serving plans do, and a tensor made there
cannot enter autograd. Eager PyTorch has nothing to jit or donate: the
reference's ``lax.scan`` over microbatches is a Python loop here
(``unroll_microbatches`` is accepted and changes nothing), and
``train_loop(donate=True)`` is accepted and does nothing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core.sealing import (tree_leaves_with_names, tree_map,
                                      tree_map_with_names)
from repro_torch.models.model import Model
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         init_opt_state)

Params = Any


class TrainState(NamedTuple):
    params: Params
    opt: OptState


def init_train_state(model: Model, opt_cfg: AdamWConfig,
                     seed: int = 0) -> TrainState:
    """Random params from ``seed`` on the model's device, zero moments."""
    params = model.init_params(seed)
    return TrainState(params, init_opt_state(opt_cfg, params))


def abstract_train_state(model: Model, opt_cfg: AdamWConfig) -> TrainState:
    """The train state's structure with meta-device leaves (no memory)."""
    params = model.abstract_params()
    return TrainState(params, init_opt_state(opt_cfg, params))


def value_and_grad(model: Model, params: Params,
                   batch: Dict[str, torch.Tensor]):
    """(loss, metrics, grads) of ``model.loss`` at ``params``; the grads
    keep each param's dtype, and a param the loss does not reach gets
    zeros."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = model.loss(live, batch)
    names, leaves = zip(*tree_leaves_with_names(live))
    grads = dict(zip(names, torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True)))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map_with_names(lambda name, _: grads[name], live))


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, unroll_microbatches: bool = False,
                    grad_transform: Optional[Callable[[Params], Params]] = None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch`` is a dict of arrays or tensors (``tokens``, ``labels``, and
    ``frames`` for the encoder-decoder), moved to the params' device.
    ``microbatches > 1`` splits its leading dim and accumulates each
    part's gradients into f32 zeros, then divides (with one microbatch the
    gradients keep the params' dtypes); the loss is the mean of the parts'
    and the other metrics are the last part's. ``grad_transform`` runs on
    the gradients before the optimizer (gradient compression hooks in
    here)."""
    del unroll_microbatches   # a Python loop is the only form

    def train_step(state: TrainState, batch):
        device = next(tree_leaves_with_names(state.params))[1].device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(model, state.params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(microbatches):
                part = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                     + v.shape[1:])[i]
                        for k, v in batch.items()}
                part_loss, metrics, part_grads = value_and_grad(
                    model, state.params, part)
                tree_map(lambda a, g: a.add_(g), grads, part_grads)
                loss = loss + part_loss
                del part_grads
            loss = loss / microbatches
            grads = tree_map(lambda g: g.div_(microbatches), grads)

        if grad_transform is not None:
            grads = grad_transform(grads)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, state.params, grads, state.opt)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt), metrics

    return train_step


@dataclasses.dataclass
class StragglerMonitor:
    """Per-step deadline tracking, the straggler-mitigation hook. On a real
    fleet ``on_straggle`` would trigger rebalancing (a smaller microbatch,
    a slow host left out of the next allocation, a checkpoint and restart
    elsewhere); here it records and (optionally) calls back."""
    deadline_s: float
    on_straggle: Optional[Callable[[int, float], None]] = None
    history: list = dataclasses.field(default_factory=list)
    straggles: int = 0

    def observe(self, step: int, duration_s: float) -> bool:
        self.history.append(duration_s)
        if duration_s > self.deadline_s:
            self.straggles += 1
            if self.on_straggle:
                self.on_straggle(step, duration_s)
            return True
        return False

    @property
    def median_s(self) -> float:
        h = sorted(self.history)
        return h[len(h) // 2] if h else 0.0


def train_loop(model: Model, state: TrainState, train_step, data_iter, *,
               num_steps: int, log_every: int = 10,
               checkpoint_cb: Optional[Callable[[int, TrainState], None]] = None,
               checkpoint_every: int = 0,
               monitor: Optional[StragglerMonitor] = None,
               donate: bool = False):
    """Host-side loop: metrics as floats (which waits for the step's
    device work), straggler observation, periodic checkpoints. Returns
    (state, history). ``donate`` is accepted for the reference's signature;
    eager PyTorch frees the previous state when nothing else holds it."""
    history = []
    for step in range(num_steps):
        t0 = time.monotonic()
        batch = next(data_iter)
        state, metrics = train_step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.monotonic() - t0
        if monitor is not None:
            monitor.observe(step, dt)
        metrics["step_s"] = dt
        history.append(metrics)
        if checkpoint_every and checkpoint_cb and (step + 1) % checkpoint_every == 0:
            checkpoint_cb(step + 1, state)
    return state, history
