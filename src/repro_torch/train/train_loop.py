"""Training loop (port of ``repro.train.train_loop``): a train step with
microbatch gradient accumulation and a gradient hook, its sharded
counterpart over a mesh, the host loop, and a straggler monitor.

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
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_leaf,
                                         adamw_scalars, adamw_update,
                                         clip_by_global_norm, init_opt_state)

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


def make_sharded_train_step(model: Model, opt_cfg: AdamWConfig, mesh,
                            sspecs: Params, bspecs: Dict[str, Any], *,
                            microbatches: int = 1):
    """train_step(state, batch) -> (state, metrics) over ``mesh`` (logical
    shards or ranks, :func:`repro_torch.launch.mesh.make_host_mesh`): the
    counterpart of the reference's ``jax.jit(step, in_shardings=(sspecs,
    bspecs), out_shardings=(sspecs, None))``.

    ``state`` rests in the shards of ``sspecs``
    (:func:`repro_torch.distributed.sharding.place`) and the step returns
    it so. ``batch`` is the global batch, the same on every rank. A step:

      - gathers the whole params (each rank its own copy);
      - gives every batch shard of ``bspecs`` (its leading dim's axes:
        ``data``, or ``data`` x ``model`` under ``dp_over_model``) its rows
        of each microbatch: microbatch ``i`` is rows ``i*B/mb ..`` of the
        global batch, split over the batch shards. Shards of one batch
        block (ranks of one ``model`` group) compute the same rows; logical
        shards compute them once;
      - weighs each shard's loss and gradients by its share of the
        microbatch's unmasked labels over the microbatches (f32), so their
        sum is the reference's mean; sums them over the batch shards with
        the group's all-reduce (an all-gather and a sum in rank order: the
        same bits on logical shards and ranks, every rank alike);
      - clips the whole reduced gradients by their global norm, so every
        shard uses one norm;
      - updates each shard's own slices of params, ``m`` and ``v`` with
        AdamW, element by element; under ``zero1`` (params laid out unlike
        their moments) the updated slices are all-gathered and placed by
        the params' specs.

    Unlike :func:`make_train_step` the gradients accumulate in f32 at one
    microbatch too. Tensor-parallel compute is not part of it: every shard
    runs the whole model on its rows. A model whose rows are coupled (MoE
    expert capacity and its aux loss are reckoned over the call's tokens)
    refuses a split batch. metrics: ``loss``, ``ce_loss`` and ``aux_loss``
    (the last microbatch's) over the global batch, ``grad_norm``, ``lr``,
    and ``collective_bytes``/``collective_s``, what the step's gathers and
    reductions moved into one shard and their measured seconds."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.collectives import mark_seconds, take_all

    named = sharding.to_named(mesh, sspecs)
    axis = next(iter(bspecs.values()))[0]
    group = mesh.group(axis) if axis is not None else None
    shards = list(group.local) if group is not None else [0]
    n = group.size if group is not None else 1
    if n > 1 and model.rows_coupled:
        raise NotImplementedError(
            f"{model.cfg.family} couples a call's rows (expert capacity, aux "
            f"loss), so its batch does not split over a mesh yet "
            f"(ROADMAP.md queue A item 21 part 3c)")
    groups = (mesh.groups["data"], mesh.groups["model"], mesh.flat)

    def reduce(parts):
        return parts[0] if group is None else group.all_reduce(parts)

    def train_step(state: TrainState, batch):
        take_all(groups)
        device = mesh.device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        rows = next(iter(batch.values())).shape[0]
        if rows % (microbatches * n):
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{microbatches} microbatches over {n} shards")
        per_mb, per_shard = rows // microbatches, rows // microbatches // n
        params = sharding.gather(state.params)
        acc = {s: tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=device), params)
            for s in shards}
        stats = {s: torch.zeros(3, dtype=torch.float32, device=device)
                 for s in shards}
        for i in range(microbatches):
            lo = i * per_mb
            count = (batch["labels"][lo:lo + per_mb] >= 0).sum().clamp(min=1)
            for s in shards:
                part = {k: v[lo + s * per_shard:lo + (s + 1) * per_shard]
                        for k, v in batch.items()}
                share = (part["labels"] >= 0).sum() / count
                loss, metrics, grads = value_and_grad(model, params, part)
                w = share / microbatches
                tree_map(lambda a, g: a.add_(g.float() * w), acc[s], grads)
                del grads
                stats[s][0] += loss.float() * w
                if i == microbatches - 1:
                    stats[s][1:] = torch.stack([metrics["ce_loss"].float(),
                                                metrics["aux_loss"].float()
                                                ]) * share
        with torch.no_grad():
            grads = tree_map(lambda *parts: reduce(list(parts)),
                             *[acc[s] for s in shards])
            del acc
            loss, ce, aux = reduce([stats[s] for s in shards])
            grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
            step = sharding.gather_leaf(state.opt.step) + 1
            scalars = adamw_scalars(opt_cfg, step)

            def update(p, g, m, v, p_named):
                """New placed (param, m, v): each block of the moments
                updates the same region of the param."""
                mspec = m.named.spec
                new_p, new_m, new_v = {}, {}, {}
                for key, m_block in m.blocks.items():
                    region = lambda t: sharding.narrow(t, mspec, mesh, key)
                    new_p[key], new_m[key], new_v[key] = adamw_leaf(
                        opt_cfg, scalars, region(p), region(g), m_block,
                        v.blocks[key])
                moments = (sharding.Placed(m.named, m.shape, m.dtype, new_m),
                           sharding.Placed(v.named, v.shape, v.dtype, new_v))
                placed = sharding.Placed(m.named, p.shape, p.dtype, new_p)
                if tuple(p_named.spec) != tuple(mspec):
                    placed = sharding.place_leaf(placed, p_named)
                else:
                    placed.named = p_named
                return (placed,) + moments

            out = tree_map(update, params, grads, state.opt.m, state.opt.v,
                           named.params)
            new_p, new_m, new_v = (tree_map(lambda o: o[j], out)
                                   for j in range(3))
            new_state = TrainState(new_p, OptState(
                new_m, new_v, sharding.place_leaf(step, named.opt.step)))
        nbytes, marks = take_all(groups)
        return new_state, {"loss": loss, "ce_loss": ce, "aux_loss": aux,
                           "grad_norm": gnorm, "lr": scalars[0],
                           "collective_bytes": nbytes,
                           "collective_s": sum(map(mark_seconds, marks))}

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
