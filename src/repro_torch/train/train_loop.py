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
import functools
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core.sealing import (tree_leaves_with_names, tree_map,
                                      tree_map_with_names)
from repro_torch.models.model import Model
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_leaf,
                                         adamw_scalars, adamw_update,
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


def make_sharded_train_step(model: Model, opt_cfg: AdamWConfig, mesh,
                            sspecs: Params, bspecs: Dict[str, Any], *,
                            microbatches: int = 1):
    """train_step(state, batch) -> (state, metrics) over ``mesh`` (logical
    shards or ranks, :func:`repro_torch.launch.mesh.make_host_mesh`): the
    counterpart of the reference's ``jax.jit(step, in_shardings=(sspecs,
    bspecs), out_shardings=(sspecs, None))``, where XLA splits the compute
    by the specs.

    ``state`` rests in the shards of ``sspecs``
    (:func:`repro_torch.distributed.sharding.place`) and the step returns
    it so. ``batch`` is the global batch, the same on every rank. A step:

      - gathers the params over ``data`` only (FSDP): each model shard
        keeps its blocks of the leaves split over ``model`` and every
        replicated leaf whole;
      - gives every batch shard of ``bspecs`` (its leading dim's axes:
        ``data``, or ``data`` x ``model`` under ``dp_over_model``) its rows
        of each microbatch: microbatch ``i`` is rows ``i*B/mb ..`` of the
        global batch, split over the batch shards;
      - runs the tensor-parallel loss
        (:class:`~repro_torch.distributed.tensor_parallel.TensorParallelLoss`)
        of each model shard on its batch shard's rows, forward and
        backward touching only the shard's blocks of the split leaves;
        the local batch shards run in lockstep. A MoE model whose batch
        splits routes each layer's tokens over the whole batch group
        (expert capacity and drops are one device's) and its aux loss is
        the global batch's;
      - weighs each batch shard's loss by its share of the microbatch's
        unmasked labels over the microbatches (f32) inside the graph, so
        the shards' gradients sum to the reference's mean (the aux loss,
        alike on every batch shard, once); accumulates the gradients of
        each shard's blocks in f32 and sums them over the batch shards
        with the group's all-reduce (an all-gather and a sum in rank
        order: the same bits on logical shards and ranks, every rank
        alike);
      - clips the reduced gradients by their global norm, each element
        counted once: a split leaf's squares summed over ``model``, a
        replicated leaf's taken once;
      - updates each shard's own slices of params, ``m`` and ``v`` with
        AdamW, element by element (under ``zero1``, where a moment is laid
        out unlike its param, from the param and gradient gathered
        whole); the updated slices are placed by the params' specs.

    Under ``dp_over_model`` the specs drop ``model`` and the step is
    data-parallel over both axes. metrics: ``loss``, ``ce_loss`` and
    ``aux_loss`` (the last microbatch's) over the global batch,
    ``grad_norm``, ``lr``, and ``collective_bytes``/``collective_s``:
    what the step's collectives moved into one shard, and their measured
    seconds. The bytes count the params' gather over ``data``; in the
    forward pass the reductions of the embedding, of each mixer and FFN
    half and of Mamba's ``bcdt``, and the gathers of the vocabulary-split
    logits, of rwkv6's heads and receptance, of Mamba's ``w_in`` and of a
    split MoE batch's rows; the same again in remat's recompute; in the
    backward pass the all-reduce of every ``copy_to``'s cotangents; then
    the gradients' all-reduce over the batch shards, the norm's over
    ``model`` and the three metrics'."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.collectives import (LocalGroup,
                                                     mark_seconds, take_all)
    from repro_torch.distributed.tensor_parallel import (TensorParallelLoss,
                                                         model_dim)

    named = sharding.to_named(mesh, sspecs)
    axis = next(iter(bspecs.values()))[0]
    bg = mesh.group(axis) if axis is not None else LocalGroup(1, mesh.device)
    tp = 1 if model.cfg.parallel.dp_over_model else mesh.shape["model"]
    mg = mesh.groups["model"] if tp > 1 else LocalGroup(1, mesh.device)
    fwd = TensorParallelLoss(model, mg, bg if model.rows_coupled
                             and bg.size > 1 else None)
    pspecs = dict(tree_leaves_with_names(sspecs.params))
    split = {n: tp > 1 and model_dim(sp) >= 0 for n, sp in pspecs.items()}
    groups = tuple(mesh.groups.values()) + (mesh.flat,)
    bl, ml = list(bg.local), list(mg.local)

    def blocks_of(name, x):
        """{local model shard: its block gathered over data}, or {None:
        the whole leaf} for a leaf not split over model."""
        if split[name]:
            return sharding.gather_over(x, "data")
        return {None: sharding.gather_leaf(x)}

    def train_step(state: TrainState, batch):
        take_all(groups)
        device = mesh.device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        rows = next(iter(batch.values())).shape[0]
        if rows % (microbatches * bg.size):
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{microbatches} microbatches over {bg.size} "
                             f"shards")
        per_mb = rows // microbatches
        per_shard = per_mb // bg.size
        blocks = {n: blocks_of(n, x)
                  for n, x in tree_leaves_with_names(state.params)}
        # an autograd leaf per (name, batch shard, model shard or None)
        leaves: Dict[tuple, torch.Tensor] = {}

        def leaf(i, m, name, _):
            key = (name, i, m if split[name] else None)
            if key not in leaves:
                leaves[key] = blocks[name][key[2]].detach().requires_grad_()
            return leaves[key]

        trees = [[tree_map_with_names(functools.partial(leaf, i, m),
                                      state.params) for m in ml]
                 for i in range(len(bl))]
        keys = list(leaves)
        acc = {}          # the weighted gradients, f32 over microbatches
        stats = [torch.zeros(3, dtype=torch.float32, device=device)
                 for _ in bl]
        for mb in range(microbatches):
            lo = mb * per_mb
            count = (batch["labels"][lo:lo + per_mb] >= 0).sum().clamp(min=1)
            parts = [{k: v[lo + s * per_shard:lo + (s + 1) * per_shard]
                      for k, v in batch.items()} for s in bl]
            shares = [(p["labels"] >= 0).sum() / count for p in parts]
            with torch.enable_grad():
                outs = fwd.loss(trees, parts)
                terms = [loss * (share / microbatches)
                         for (loss, _, _), share in zip(outs, shares)]
                grads = torch.autograd.grad(
                    terms, [leaves[k] for k in keys], allow_unused=True,
                    materialize_grads=True)
            for k, g in zip(keys, grads):
                if microbatches == 1:
                    acc[k] = g          # made f32 as it is reduced
                elif k in acc:
                    acc[k].add_(g.float())
                else:
                    acc[k] = g.float()
            del grads
            for i, ((loss, ce, aux), share) in enumerate(zip(outs, shares)):
                stats[i][0] += loss.detach().float() * share / microbatches
                if mb == microbatches - 1:
                    stats[i][1:] = torch.stack([ce.detach().float(),
                                                aux.detach().float()]) * share
            del outs, terms
        names = list(blocks)
        del trees, leaves, blocks
        with torch.no_grad():
            grads = {}
            for n in names:
                for j, m in enumerate(ml if split[n] else [None]):
                    with bg.counted(bg.counting and j == 0):
                        # contiguous, as a rank's gathered parts are: a
                        # sum's order follows the layout
                        grads[n, m] = bg.all_reduce(
                            [acc.pop((n, i, m)).float().contiguous()
                             for i in range(len(bl))])
            loss, ce, aux = bg.all_reduce(stats)
            gnorm = _global_norm(grads, names, split, mg, ml)
            scale = torch.clamp(opt_cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            for g in grads.values():
                g.mul_(scale)
            step = sharding.gather_leaf(state.opt.step) + 1
            scalars = adamw_scalars(opt_cfg, step)

            def update(name, p, m, v, p_named):
                """New placed (param, m, v): each block of the moments
                updates the same region of the param: the param's own
                block, or under ``zero1`` (moments laid out unlike the
                param) a region of the param gathered whole."""
                mspec, pspec = tuple(m.named.spec), tuple(p_named.spec)
                mdim = model_dim(pspec)
                same = pspec == mspec
                if not same:
                    whole_p = sharding.gather_leaf(p)
                    whole_g = (mg.all_gather([grads[name, k] for k in ml],
                                             mdim) if split[name]
                               else grads[name, None])
                new_p, new_m, new_v = {}, {}, {}
                for key, m_block in m.blocks.items():
                    if not same:
                        pr, gr = (sharding.narrow(t, mspec, mesh, key)
                                  for t in (whole_p, whole_g))
                    elif split[name]:
                        pr, gr = p.blocks[key], sharding.narrow(
                            grads[name, key[mdim]], tuple(
                                None if a == "model" else a for a in mspec),
                            mesh, key)
                    else:
                        pr = p.blocks[key]
                        gr = sharding.narrow(grads[name, None], mspec, mesh,
                                             key)
                    new_p[key], new_m[key], new_v[key] = adamw_leaf(
                        opt_cfg, scalars, pr, gr, m_block, v.blocks[key])
                moments = (sharding.Placed(m.named, m.shape, m.dtype, new_m),
                           sharding.Placed(v.named, v.shape, v.dtype, new_v))
                placed = sharding.Placed(m.named, p.shape, p.dtype, new_p)
                if not same:
                    placed = sharding.place_leaf(placed, p_named)
                else:
                    placed.named = p_named
                return (placed,) + moments

            out = tree_map_with_names(update, state.params, state.opt.m,
                                      state.opt.v, named.params)
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


def _global_norm(grads, names, split, mg, ml) -> torch.Tensor:
    """The global norm of the reduced gradients ``grads[name, model
    shard]`` with every element counted once: each split leaf's squares
    summed over ``model`` (one all-reduce of the leaves' partial sums), a
    replicated leaf's squares taken once; the leaves summed in the
    reference's order (:func:`~repro_torch.train.optimizer.global_norm`'s
    sum on one device)."""
    sums = {}
    cut = [n for n in names if split[n]]
    if cut:
        sums.update(zip(cut, mg.all_reduce([torch.stack(
            [grads[n, m].square().sum() for n in cut]) for m in ml])))
    for n in names:
        if not split[n]:
            sums[n] = grads[n, None].square().sum()
    return torch.stack([sums[n] for n in names]).sum().sqrt()


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
