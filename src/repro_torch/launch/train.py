"""Training launcher (port of ``repro.launch.train``): a (possibly
sharded, possibly confidential) training job for any registered decoder
architecture.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \
        --smoke --steps 20 --batch 8 --seq 128 --tee tdx --ckpt-dir /tmp/run1

Runs on the CUDA card unless ``--device cpu``. With ``--ckpt-dir`` it
checkpoints every ``--ckpt-every`` steps (sealed under a confidential
``--tee``), resumes from the latest checkpoint after a failure, and
``--fail-at`` injects failures as a drill. It prints the reference
launcher's report lines.

``--data-mesh N --model-mesh M`` (a product above 1) places the train state
by ``sharding.state_specs`` on an N x M mesh and trains with the sharded
step (``make_sharded_train_step``), printing the reference's ``mesh:``
line. In one process the mesh is logical shards on the one device; under
torchrun it spans the ranks of the world (N x M of them), each taking its
card (or ``--device``), all under rank 0's key material, rank 0 alone
printing and writing checkpoints::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch deepseek-7b --smoke \
        --data-mesh 2 --model-mesh 2 --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, list_configs, smoke_config
from repro_torch.core import TrustDomain
from repro_torch.data.pipeline import PackedLMDataset
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     run_with_restarts)
from repro_torch.launch.mesh import join_world, make_host_mesh, shared_keys
from repro_torch.models import build_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import (abstract_train_state,
                                          init_train_state,
                                          make_sharded_train_step,
                                          make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tee", default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        raise SystemExit("use a decoder-family arch for the LM trainer")
    sharded = args.data_mesh * args.model_mesh > 1
    rank, device = (join_world(args.device) if sharded
                    else (None, args.device))
    device = resolve_device(device)
    model = build_model(cfg, device=device)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(1, args.steps // 10),
                      moment_dtype=cfg.parallel.optimizer_dtype)

    state = init_train_state(model, opt, seed=0)
    step_fn = make_train_step(model, opt, microbatches=args.microbatches)

    if sharded:
        mesh = make_host_mesh(args.data_mesh, args.model_mesh, device=device)
        sspecs = sharding.state_specs(
            cfg, abstract_train_state(model, opt), mesh)
        state = sharding.place(state, sharding.to_named(mesh, sspecs))
        shape = torch.empty((args.batch, args.seq), dtype=torch.int32,
                            device="meta")
        bspecs = sharding.batch_specs(cfg, {"tokens": shape,
                                            "labels": shape}, mesh)
        step_fn = make_sharded_train_step(model, opt, mesh, sspecs, bspecs,
                                          microbatches=args.microbatches)
        print(f"mesh: {dict(mesh.shape)}")

    td = (TrustDomain(args.tee, device=device) if rank is None
          else TrustDomain(args.tee, device=device, **shared_keys()))
    mgr = (CheckpointManager(args.ckpt_dir,
                             trust_domain=td if td.confidential else None)
           if args.ckpt_dir else None)

    def data_factory(cursor):
        ds = PackedLMDataset(batch_size=args.batch, seq_len=args.seq, seed=0)
        it = iter(ds)
        for _ in range(cursor):
            next(it)
        return it

    total, active = cfg.params_count()
    print(f"arch={cfg.name} params={total / 1e6:.1f}M "
          f"(active {active / 1e6:.1f}M) tee={args.tee}")
    t0 = time.monotonic()
    if mgr is not None:
        injector = FailureInjector(set(args.fail_at)) if args.fail_at else None
        state, losses, restarts = run_with_restarts(
            state=state, train_step=step_fn, data_factory=data_factory,
            num_steps=args.steps, manager=mgr,
            checkpoint_every=args.ckpt_every, injector=injector)
        print(f"restarts: {restarts}")
    else:
        data = data_factory(0)
        losses = []
        for step in range(args.steps):
            state, metrics = step_fn(state, next(data))
            losses.append(float(metrics["loss"]))
    wall = time.monotonic() - t0
    print(f"{args.steps} steps in {wall:.1f}s "
          f"({args.steps * args.batch * args.seq / wall:.0f} tok/s)")
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    if rank is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
