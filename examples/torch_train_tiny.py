"""Train a small LM end to end on the PyTorch port with the full
fault-tolerance stack: sealed checkpoints every 10 steps, an injected
failure, and a restart that resumes to the same loss curve. On the CUDA
card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_train_tiny.py [--steps 60] \
        [--d-model 128] [--device cpu]
    (--d-model 512 --layers 12 approximates the ~100M-param configuration;
     defaults are CPU-demo sized)

Checkpoints go to ``--ckpt-dir``, or to a temporary directory removed at
the end.
"""

import argparse
import tempfile
import time

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import TrustDomain
from repro_torch.data.pipeline import PackedLMDataset
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     run_with_restarts)
from repro_torch.models import build_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import init_train_state, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = ModelConfig(
        name="train-tiny", family="dense", num_layers=args.layers,
        d_model=args.d_model, num_heads=4, num_kv_heads=4,
        head_dim=args.d_model // 4, d_ff=4 * args.d_model,
        vocab_size=ByteTokenizer.vocab_size, dtype="float32",
        parallel=ParallelConfig(remat="none"))
    model = build_model(cfg, device=device)
    total, _ = cfg.params_count()
    print(f"model: {total / 1e6:.1f}M params, {args.steps} steps")

    opt = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=args.steps)
    state = init_train_state(model, opt, seed=0)
    step_fn = make_train_step(model, opt, microbatches=2)

    def data_factory(cursor):
        ds = PackedLMDataset(batch_size=args.batch, seq_len=args.seq, seed=0)
        it = iter(ds)
        for _ in range(cursor):
            next(it)
        return it

    td = TrustDomain("tdx", device=device)  # sealed checkpoints
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(args.ckpt_dir or tmp, keep_n=2,
                                trust_domain=td)
        injector = FailureInjector(fail_at={args.steps // 2})
        t0 = time.monotonic()
        state, losses, restarts = run_with_restarts(
            state=state, train_step=step_fn, data_factory=data_factory,
            num_steps=args.steps, manager=mgr, checkpoint_every=10,
            injector=injector)
        wall = time.monotonic() - t0

    print(f"survived {restarts} injected failure(s); {wall:.1f}s total")
    for i in range(0, len(losses), max(1, len(losses) // 10)):
        print(f"  step {i:4d}  loss {losses[i]:.4f}")
    print(f"  final loss {losses[-1]:.4f} "
          f"(start {losses[0]:.4f} -> {'improved' if losses[-1] < losses[0] else 'check'})")


if __name__ == "__main__":
    main()
