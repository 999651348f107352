"""What one rank of a gloo world runs for tests/test_torch_train_ranks.py
(CPU ranks), and what the parent runs on logical shards to compare: the
port's sharded train step on smoke deepseek-7b over a ``data x model``
mesh, a sealed checkpoint of the placed state saved and restored, one more
step; on the 2 x 2 mesh also smoke dbrx and jamba with their batch split
over ``data`` at a capacity factor that drops; and GPipe over the mesh's
``model`` group. Imports torch and repro_torch only, so a spawned rank
starts quickly."""

from datetime import timedelta

import numpy as np
import torch

# 8 rows in 2 microbatches: each data shard of dp=2 steps 2 rows of a
# microbatch (the CPU's GEMM rounds a single row differently from several)
BATCH, SEQ, MICROBATCHES = 8, 16, 2
STEPS = 2
KEY = b"train-ranks"
# MoE archs trained on the 2 x 2 mesh, at a capacity factor that drops
MOE_ARCHS = ("dbrx-132b", "jamba-v0.1-52b")
MOE_SHAPE = (2, 2)
MOE_CAPACITY = 1.0


def batches():
    rng = np.random.default_rng(3)
    for _ in range(STEPS + 1):
        yield {"tokens": rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32),
               "labels": rng.integers(-1, 256, (BATCH, SEQ)).astype(np.int32)}


def _whole(tree):
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.distributed import sharding

    return {n: t.clone() for n, t in
            tree_leaves_with_names(sharding.gather(tree))}


def train(shape, ckpt_dir, device="cpu"):
    """STEPS sharded steps over a ``shape`` mesh (logical shards, or the
    ranks of the initialized world), a sealed save of the placed state, a
    restore onto its shards, and one more step. Returns the whole state
    after the steps, after the restore and after the last step (every
    rank gathers it), the losses, and whether this process wrote."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import SealingKey, TrustDomain
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import (abstract_train_state,
                                              init_train_state,
                                              make_sharded_train_step)

    cfg = smoke_config("deepseek-7b")
    model = build_model(cfg, device=device)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    mesh = make_host_mesh(*shape, device=device)
    sspecs = sharding.state_specs(cfg, abstract_train_state(model, opt), mesh)
    data = list(batches())
    state = sharding.place(init_train_state(model, opt, seed=0),
                           sharding.to_named(mesh, sspecs))
    step = make_sharded_train_step(
        model, opt, mesh, sspecs, sharding.batch_specs(cfg, data[0], mesh),
        microbatches=MICROBATCHES)
    losses = []
    for b in data[:STEPS]:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    trained = _whole(state)
    td = TrustDomain("tdx", sealing_key=SealingKey.generate(KEY),
                     device=device)
    mgr = ckpt.CheckpointManager(ckpt_dir, trust_domain=td)
    mgr.save(STEPS, state)
    at, back = mgr.resume(state)
    restored = _whole(back)
    state, metrics = step(back, data[STEPS])
    losses.append(float(metrics["loss"]))
    return dict(trained=trained, restored=restored, final=_whole(state),
                losses=losses, step=at, writes=ckpt.writes(state),
                bytes=metrics["collective_bytes"],
                placed=sharding.placement(back) == sharding.to_named(
                    mesh, sspecs))


def moe_train(arch, shape, device="cpu"):
    """STEPS sharded steps of smoke ``arch`` at MOE_CAPACITY over a
    ``shape`` mesh, its batch split over ``data``: the whole final state,
    the losses and the last step's collective bytes."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import (abstract_train_state,
                                              init_train_state,
                                              make_sharded_train_step)

    cfg = smoke_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CAPACITY))
    model = build_model(cfg, device=device)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    mesh = make_host_mesh(*shape, device=device)
    sspecs = sharding.state_specs(cfg, abstract_train_state(model, opt), mesh)
    data = list(batches())
    state = sharding.place(init_train_state(model, opt, seed=0),
                           sharding.to_named(mesh, sspecs))
    step = make_sharded_train_step(
        model, opt, mesh, sspecs, sharding.batch_specs(cfg, data[0], mesh),
        microbatches=MICROBATCHES)
    losses = []
    for b in data[:STEPS]:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    return dict(final=_whole(state), losses=losses,
                bytes=metrics["collective_bytes"])


def gpipe_inputs(stages=2, d=16):
    rng = np.random.default_rng(5)
    ws = torch.from_numpy((rng.standard_normal((stages, d, d)) * 0.3
                           ).astype(np.float32))
    mb = torch.from_numpy(rng.standard_normal((6, 8, d)).astype(np.float32))
    return ws, mb


def gpipe(group):
    """make_gpipe over ``group``: (output, gradient of sum(out ** 2) with
    respect to the stacked params)."""
    from repro_torch.distributed.pipeline import make_gpipe

    ws, mb = gpipe_inputs(group.size)
    ws.requires_grad_()
    out = make_gpipe(group, lambda w, x: torch.tanh(x @ w))(ws, mb)
    (g,) = torch.autograd.grad((out ** 2).sum(), ws)
    return out.detach(), g


def rank_main(rank, world, init_file, shape, out_dir, with_gpipe):
    """One rank: join the gloo world, train, and save what it saw."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        out = train(shape, f"{out_dir}/ckpt")
        if tuple(shape) == MOE_SHAPE:
            out["moe"] = {a: moe_train(a, shape) for a in MOE_ARCHS}
        if with_gpipe:
            from repro_torch.launch.mesh import make_host_mesh
            out["gpipe"] = gpipe(make_host_mesh(1, world,
                                                device="cpu").groups["model"])
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(shape, tmp_path, with_gpipe=False):
    """``rank_main`` on data x model spawned CPU ranks; each rank's
    record. A rank that fails fails the call."""
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    mp.spawn(rank_main, args=(world, str(tmp_path / "init"), shape,
                              str(tmp_path), with_gpipe),
             nprocs=world, join=True)
    out = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(world)]
    out[0]["ckpt"] = tmp_path / "ckpt"
    return out
