"""What one rank of a gloo world runs for tests/test_torch_ranks.py (CPU
ranks) and tests/test_torch_gpu.py (ranks sharing the card), and what the
parent runs on logical shards to compare: the port's engine (one of
``RUNS``: smoke deepseek-7b on the slot backend, or on the paged backend
with prefix sharing, or with one KV head (sequence parallelism), smoke
dbrx-132b, deepseek-v3-671b or jamba-v0.1-52b paged, smoke rwkv6-3b on
the slot backend) through two waves of
sampled requests, the second preempting, with every seal's names and
ciphertext and every step's page table recorded; and the ring collective
matmuls over the mesh's ``model`` group. Imports torch and repro_torch
only, so a spawned rank starts quickly."""

from datetime import timedelta

import numpy as np
import torch

# 4 slots: a data shard of dp=2 holds 2 rows (the CPU's GEMM rounds a
# single row differently from several: 2 rows a shard keep every row's
# bits those of the logical run's 4-row step)
ENGINE = dict(max_slots=4, max_len=64, prefill_buckets=(4, 8),
              kv_backend="slot")
RING_SHAPES = dict(x=(64, 32), w=(32, 48), xk=(64, 128), wk=(128, 48))
PAGED = dict(kv_backend="paged", page_size=8)
# run name -> (arch, engine overrides, a shared prompt pair in the low
# wave, config overrides): "sp" has one KV head, which tp=2 does not
# divide, so each rank keeps the whole pool; "mla" keeps the latent whole;
# "jamba" keeps each rank's Mamba channels of every row slot-dense beside
# its KV heads of every page; "rwkv" each rank's wkv heads of every row
RUNS = {"slot": ("deepseek-7b", {}, False, {}),
        "paged": ("deepseek-7b", dict(PAGED, prefix_sharing=True), True, {}),
        "dbrx": ("dbrx-132b", PAGED, False, {}),
        "sp": ("deepseek-7b", PAGED, False, dict(num_kv_heads=1)),
        "mla": ("deepseek-v3-671b", PAGED, False, {}),
        "jamba": ("jamba-v0.1-52b", PAGED, False, {}),
        "rwkv": ("rwkv6-3b", {}, False, {})}


def specs(shared=False):
    """(prompt, max_new_tokens, priority, seed): five lows on four slots
    (with ``shared`` a sixth whose 8-token prompt equals the third's, so
    the pair maps one full page), then two highs that preempt."""
    p8 = np.arange(1, 9, dtype=np.int32)
    p4 = np.arange(1, 5, dtype=np.int32)
    low = [(p4, 8, 0, 100), (p4 + 1, 5, 0, 101), (p8, 8, 0, 102),
           (p8 + 2, 6, 0, 103), (np.arange(1, 13, dtype=np.int32), 6, 0, 104)]
    if shared:
        low.append((p8.copy(), 7, 0, 107))
    high = [(np.full(8, 7, np.int32), 4, 5, 105),
            (np.full(8, 9, np.int32), 3, 5, 106)]
    return low, high


def serve(mesh, device="cpu", run="slot"):
    """The waves of ``RUNS[run]`` on one engine over ``mesh`` (logical
    shards, or the ranks of the initialized world) on ``device``. Returns
    the tokens, every seal's {name: (ciphertext bytes, mac)}, every step's
    page table (paged), the egress frames and the plan's description."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import SealingKey, TrustDomain
    from repro_torch.models import build_model
    from repro_torch.runtime import Engine, GenerationRequest, SamplingParams

    import dataclasses

    arch, kv, shared, cfg_kw = RUNS[run]
    model = build_model(dataclasses.replace(smoke_config(arch), **cfg_kw),
                        device=device)
    td = TrustDomain("tdx", sealing_key=SealingKey.generate(b"seal"),
                     io_key=SealingKey.generate(b"io"), device=device)
    eng = Engine(model, model.init_params(0), trust_domain=td, mesh=mesh,
                 device=device, **dict(ENGINE, **kv))
    seals = []
    for meth in ("seal", "seal_tail_pages"):
        def recording(*a, _inner=getattr(eng.kv, meth), **k):
            out = _inner(*a, **k)
            seals.append({n: (st.ciphertext.cpu().numpy().tobytes(), st.mac)
                          for n, st in out.items()})
            return out
        setattr(eng.kv, meth, recording)

    def gen(spec):
        prompt, mnt, prio, seed = spec
        return GenerationRequest(
            prompt=prompt.copy(), max_new_tokens=mnt, priority=prio,
            params=SamplingParams(temperature=0.9, top_k=16, seed=seed))

    tables = []

    def step():
        eng.step()
        if hasattr(eng.kv, "table"):
            tables.append(eng.kv.table.copy())

    low, high = specs(shared)
    reqs = [eng.submit(gen(s)) for s in low]
    for _ in range(3):
        step()
    reqs += [eng.submit(gen(s)) for s in high]
    while not eng.idle:
        step()
    stats = eng.run()
    return dict(tokens=[list(r.output) for r in reqs], seals=seals,
                tables=tables, frames=td.channel.stats.messages_out,
                preemptions=stats.preemptions,
                shared_pages=stats.shared_pages,
                steps=td.channel.stats.collective_steps,
                describe=eng.plan.describe())


def ring_inputs():
    rng = np.random.default_rng(11)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in RING_SHAPES.items()}


def ring(group):
    """Both ring matmuls over ``group`` under ``shard_map``, as global
    arrays."""
    from repro_torch.distributed import overlap
    from repro_torch.distributed.collectives import shard_map

    a = ring_inputs()
    y = shard_map(lambda x, w: overlap.all_gather_matmul(x, w, group),
                  group, (0, None), None)(a["x"], a["w"])
    y2 = shard_map(lambda x, w: overlap.matmul_reduce_scatter(x, w, group),
                   group, (1, 0), 0)(a["xk"], a["wk"])
    return y, y2


def rank_main(rank, world, init_file, mesh, out_dir, with_ring, device,
              runs):
    """One rank: join the gloo world, serve each of ``runs``, record which
    names this rank sealed itself, and save what it saw."""
    import torch.distributed as dist
    from repro_torch.runtime import kvcache

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        own = []
        seal_tensor = kvcache.seal_tensor

        def sealing(key, name, array, **kw):
            own.append(name)
            return seal_tensor(key, name, array, **kw)

        kvcache.seal_tensor = sealing
        out = {}
        for run in runs:
            own.clear()
            out[run] = serve(mesh, device, run)
            out[run]["own"] = list(own)
        if with_ring:
            from repro_torch.launch.mesh import make_host_mesh
            out["ring"] = ring(make_host_mesh(1, world,
                                              device="cpu").groups["model"])
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(mesh, world, tmp_path, with_ring=False, device="cpu",
          runs=("slot",)):
    """Run ``rank_main`` on ``world`` spawned ranks on ``device`` (the CPU,
    or all of them on the one card); returns each rank's record: one entry
    per run of ``runs`` (and ``"ring"``). A rank that fails fails the
    call."""
    import torch.multiprocessing as mp

    mp.spawn(rank_main, args=(world, str(tmp_path / "init"), mesh,
                              str(tmp_path), with_ring, device, tuple(runs)),
             nprocs=world, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
