#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (src/repro_torch) runs on a GPU.

    python3 chip_smoke.py          # one CUDA card; builds every kernel first

Phases, each fatal on failure:
  1. device: the card's name, count, and nvidia-smi name and power limit;
  2. build: every CUDA kernel of the main path, with nvcc for sm_90a;
  3. kernel check: each kernel held bit for bit against its plain PyTorch
     version on the card (the RFC 8439 vector; random data at the main
     path's sizes: a token frame, a KV leaf, the largest weight; counter
     bases across the u32 wrap);
  4. kernel timing: CUDA events at the largest main-path shape, beside the
     bound and the plain version's time;
  5. serve: Llama2-7B at full width (random weights from a seed) under a
     TDX trust domain: seal, attest, unseal (bit-exact), then an Engine on
     the dense slot KV backend serves a low-priority wave and a preempting
     high-priority wave (sealed preemption), and every request's tokens
     must equal the same request served alone on a fresh engine;
  6. report: tokens, wall time, sealed bytes, seal/unseal time, peak device
     memory, kernel launches on the main path, and one JSON line listing
     every ported kernel. The last line is the device JSON.

Imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and the peak rate
# of 32-bit integer ops: one op per lane per clock on the 128 lanes per SM
# behind the 67 TFLOP/s fp32 figure (which counts an FMA as 2 flops). Integer
# adds also issue on the FMA pipe (IMAD), so the 64 dedicated int32 lanes
# are not the limit: the kernel measured faster than 67e12 / 4 ops/s allows.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2

# ChaCha20 per 64-byte block: 80 quarter rounds x 12 ops (4 add, 4 xor,
# 4 rotate) + 16 feed-forward adds + 16 data xors; 64 B read + 64 B written.
CHACHA_OPS_PER_BLOCK = 80 * 12 + 16 + 16
CHACHA_BYTES_PER_BLOCK = 128

RFC_KEY = bytes(range(32))
RFC_NONCE = bytes([0, 0, 0, 0, 0, 0, 0, 0x4A, 0, 0, 0, 0])
RFC_PLAIN = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
             b"only one tip for the future, sunscreen would be it.")
RFC_CIPHER = bytes.fromhex(
    "6e2e359a2568f98041ba0728dd0d6981e97e7aec1d4360c20a27afccfd9fae0b"
    "f91b65c5524733ab8f593dabcd62b3571639d624e65152ab8f530c359f0861d8"
    "07ca0dbf500d6a6156a38e088a22b65e52bc514d16ccf806818ce91ab7793736"
    "5af90bbf74a35be6b40b8eedf2785e42874d")

# the largest ChaCha20 call of the main path: sealing ffn.w_gate of
# Llama2-7B, [32, 4096, 11008] bf16 = 44032 tiles of 1024 blocks; a sealed
# KV leaf of one slot, [32, 1, 256, 32, 128] bf16, is 1024 tiles
W_GATE_BLOCKS = 44032 * 1024
KV_LEAF_BLOCKS = 1024 * 1024


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_cuda(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_host(fn, iters: int) -> float:
    """Mean seconds per call on the host clock, after one warm-up call,
    around work that ends in a device synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def phase_kernel_check(C, ops, torch, np) -> int:
    """Kernel vs plain version, bit for bit. Returns the max |difference|
    over every word compared (0 when bit-equal)."""
    dev = "cuda"
    # RFC 8439 section 2.4.2: counter 1, 114 bytes
    raw = torch.frombuffer(bytearray(RFC_PLAIN), dtype=torch.uint8).to(dev)
    blocked, n = ops.pack_u32(raw)
    kw, nw = np.frombuffer(RFC_KEY, np.uint32), np.frombuffer(RFC_NONCE, np.uint32)
    out = C.chacha20_xor_blocked(kw, nw, blocked, counter_base=1)
    plain = C.chacha20_xor_plain(kw, nw, blocked, counter_base=1)
    torch.cuda.synchronize()
    cipher = ops.unpack_u32(out, n).cpu().numpy().tobytes()
    check(cipher == RFC_CIPHER, "RFC 8439 2.4.2 vector through the kernel")
    check(torch.equal(out, plain), "RFC 8439 vector: kernel == plain")
    worst = 0
    rng = np.random.default_rng(0)
    for n_blocks in (1024, 5 * 1024, KV_LEAF_BLOCKS, W_GATE_BLOCKS):
        data = torch.from_numpy(rng.integers(
            0, 2**32, (16, n_blocks), dtype=np.uint32).view(np.int32)).to(dev)
        for cb in (0, 7, 2**32 - 2):
            kw = rng.integers(0, 2**32, 8, dtype=np.uint32)
            nw = rng.integers(0, 2**32, 3, dtype=np.uint32)
            out = C.chacha20_xor_blocked(kw, nw, data, counter_base=cb)
            plain = C.chacha20_xor_plain(kw, nw, data, counter_base=cb)
            torch.cuda.synchronize()
            err = int((out.long() - plain.long()).abs().max())
            worst = max(worst, err)
            check(err == 0, f"kernel == plain at N={n_blocks}, "
                            f"counter_base={cb} (max |diff| {err})")
            print(f"  N={n_blocks} counter_base={cb}: bit-equal")
            del out, plain
        del data
    torch.cuda.empty_cache()
    return worst


def phase_kernel_timing(C, torch, np) -> dict:
    n = W_GATE_BLOCKS
    data = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2**32, (16, n), dtype=np.uint32).view(np.int32)).to("cuda")
    out = torch.empty_like(data)
    kw = np.arange(8, dtype=np.uint32)
    nw = np.arange(3, dtype=np.uint32)
    ms = time_cuda(lambda: C.chacha20_xor_blocked(kw, nw, data, out=out),
                   iters=20, warmup=3)
    plain_ms = time_cuda(lambda: C.chacha20_xor_plain(kw, nw, data),
                         iters=2, warmup=1)
    bytes_s = n * CHACHA_BYTES_PER_BLOCK / HBM_BYTES_PER_S
    ops_s = n * CHACHA_OPS_PER_BLOCK / INT32_OPS_PER_S
    del data, out
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "bytes_ms": bytes_s * 1e3, "ops_ms": ops_s * 1e3}


# (prompt length, max_new_tokens, priority): the low wave's first two share
# the 32 bucket (one batched prefill of two rows); the last high request
# chunks past the largest bucket (its tail feeds through decode steps).
LOW_WAVE = [(20, 16, 0), (24, 12, 0), (100, 10, 0), (40, 14, 0)]
HIGH_WAVE = [(50, 8, 5), (150, 6, 5)]
ENGINE_KW = dict(kv_backend="slot", max_slots=2, max_len=256,
                 prefill_buckets=(32, 64, 128))


def phase_serve(torch, np) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import SealingKey, TrustDomain
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.kernels import chacha20 as C
    from repro_torch.models import build_model
    from repro_torch.runtime import Engine, GenerationRequest

    cfg = get_config("llama2-7b")
    model = build_model(cfg)            # the card
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    rng = np.random.default_rng(7)
    specs = [(rng.integers(1, cfg.vocab_size, n).astype(np.int32), mnt, prio)
             for n, mnt, prio in LOW_WAVE + HIGH_WAVE]

    def gen(spec):
        prompt, mnt, prio = spec
        return GenerationRequest(prompt=prompt.copy(), max_new_tokens=mnt,
                                 priority=prio)

    # ---- the main path: every kernel count starts at 0 here -------------
    torch.cuda.reset_peak_memory_stats()
    C.reset_launches()
    td = TrustDomain("tdx", sealing_key=SealingKey.generate(b"chip-smoke"),
                     io_key=SealingKey.generate(b"chip-smoke-io"))
    t0 = time.perf_counter()
    sealed = td.seal_params(params)
    torch.cuda.synchronize()
    seal_s = time.perf_counter() - t0
    verifier = td.make_verifier(cfg.name)
    quote = td.quote(verifier.challenge(), cfg.name)
    verifier.verify(quote)
    t0 = time.perf_counter()
    unsealed = td.load_sealed(sealed, params)
    torch.cuda.synchronize()
    unseal_s = time.perf_counter() - t0
    weight_launches = C.launches
    engine = Engine(model, unsealed, trust_domain=td, **ENGINE_KW)
    t0 = time.perf_counter()
    reqs = [engine.submit(gen(s)) for s in specs[:len(LOW_WAVE)]]
    for _ in range(3):
        engine.step()
    reqs += [engine.submit(gen(s)) for s in specs[len(LOW_WAVE):]]
    stats = engine.run(max_steps=10_000)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = C.launches
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the main path ---------------------------------------------

    n_weights = sum(st.n_bytes for st in sealed.values())
    leaves = dict(tree_leaves_with_names(params))
    for name, leaf in tree_leaves_with_names(unsealed):
        check(torch.equal(leaf, leaves[name]),
              f"unsealed weight {name} equals the original")
    print(f"  sealed + attested + unsealed {len(sealed)} tensors / "
          f"{n_weights} B: unsealed weights bit-equal to the originals")
    del sealed, params, leaves
    check(all(r.finished for r in reqs), "every request finished")
    check(stats.preemptions > 0, "the high wave forced a sealed preemption")
    outputs = [list(r.output) for r in reqs]
    for spec, out in zip(specs, outputs):
        check(len(out) == spec[1], f"request produced {spec[1]} tokens")
        check(all(0 <= t < cfg.vocab_size for t in out), "tokens in vocab")
    ch = td.channel.stats

    # ---- each request alone on a fresh engine (comparison only) ---------
    for i, spec in enumerate(specs):
        solo = Engine(model, unsealed, trust_domain=TrustDomain("tdx"),
                      **ENGINE_KW)
        r = solo.submit(gen(spec))
        solo.run(max_steps=10_000)
        check(list(r.output) == outputs[i],
              f"request {i} tokens equal its solo run "
              f"({outputs[i]} vs {list(r.output)})")
    print(f"  {len(specs)} requests: tokens equal their solo runs")
    # logits are finite on a real prompt (one prefill through the model)
    cache = model.init_cache(1, ENGINE_KW["max_len"])
    with torch.inference_mode():
        logits, _ = model.prefill(unsealed, {"tokens": torch.as_tensor(
            specs[0][0][None, :], device="cuda")}, cache)
    check(bool(torch.isfinite(logits).all()) and
          tuple(logits.shape) == (1, cfg.vocab_size), "prefill logits finite")

    # ---- where a served token's time goes (measurement only) -------------
    b, max_len = ENGINE_KW["max_slots"], ENGINE_KW["max_len"]
    cache = model.init_cache(b, max_len)
    cache["pos"].fill_(128)
    tok = torch.ones((b, 1), dtype=torch.int32, device="cuda")
    prompt = torch.ones((1, 128), dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        decode_s = time_host(lambda: model.decode_step(unsealed, tok, cache), 10)
        prefill_s = time_host(lambda: model.prefill(
            unsealed, {"tokens": prompt}, model.init_cache(1, max_len)), 3)
    probe = TrustDomain("tdx")
    sid = probe.open_stream()
    frame_s = time_host(lambda: probe.egress_tokens(sid, [1]), 20)
    return dict(stats=stats, channel=ch, seal_s=seal_s, unseal_s=unseal_s,
                serve_s=serve_s, launches=launches,
                weight_launches=weight_launches, peak=peak,
                weight_bytes=n_weights, n_requests=len(specs),
                decode_s=decode_s, prefill_s=prefill_s, frame_s=frame_s)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import chacha20 as C
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[1/6] device: {name} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    C._kernel_fn()
    log = build.BUILD_LOG["chacha20.cu"]
    print(f"[2/6] build: chacha20.cu with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.2f}s (cached={log['cached']})")
    for line in log["ptxas"].splitlines():
        if "registers" in line:
            print(f"  {line.strip()}")

    print("[3/6] kernel check: chacha20_xor_blocked vs plain, bit for bit")
    max_err = phase_kernel_check(C, ops, torch, np)

    tm = phase_kernel_timing(C, torch, np)
    print(f"[4/6] kernel timing at N={W_GATE_BLOCKS} blocks "
          f"({W_GATE_BLOCKS * 64} B): kernel {tm['ms']:.4f} ms, bound "
          f"{tm['bound_ms']:.4f} ms (bytes {tm['bytes_ms']:.4f} ms, integer "
          f"ops {tm['ops_ms']:.4f} ms -> {tm['bound_by']}), plain version "
          f"{tm['plain_ms']:.2f} ms")

    print("[5/6] serve: llama2-7b (32 layers, d_model 4096, bf16) under tdx")
    sv = phase_serve(torch, np)

    st, ch = sv["stats"], sv["channel"]
    per_req = (sv["launches"] - sv["weight_launches"]) / sv["n_requests"]
    print(f"[6/6] served {st.total_requests} requests / {st.total_tokens} "
          f"tokens in {sv['serve_s']:.2f}s wall; {st.preemptions} preemptions")
    print(f"  sealed KV: {ch.seal_events} seals / {ch.seal_bytes} B out, "
          f"{ch.restore_events} restores / {ch.restore_bytes} B back; egress "
          f"{ch.messages_out} frames / {ch.tokens_out} tokens")
    print(f"  weights: seal {sv['seal_s']:.2f}s + unseal {sv['unseal_s']:.2f}s "
          f"for {sv['weight_bytes']} B")
    print(f"  next-token latency p50 {st.p50_latency_s * 1e3:.2f} ms, mean "
          f"{st.mean_latency_s * 1e3:.2f} ms; TTFT mean "
          f"{st.mean_ttft_s * 1e3:.2f} ms")
    weight_read_ms = sv["weight_bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"  breakdown: decode_step (2 rows) {sv['decode_s'] * 1e3:.2f} ms vs "
          f"{weight_read_ms:.2f} ms to read the weights once; prefill (1 x 128) "
          f"{sv['prefill_s'] * 1e3:.2f} ms; one egress frame (seal + MAC + "
          f"unseal + MAC) {sv['frame_s'] * 1e3:.3f} ms")
    print(f"  peak device memory on the main path: {sv['peak']} B")
    print(f"  chacha20_xor_blocked launches on the main path: {sv['launches']} "
          f"({sv['weight_launches']} for the weights, {per_req:.1f} per served "
          f"request)")
    check(sv["launches"] > 0, "the main path launched the ChaCha20 kernel")
    print(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [{
        "name": "chacha20_xor_blocked", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chacha20.cu",
        "replaces": "src/repro/kernels/chacha20.py:98",
        "launches": sv["launches"], "max_abs_err": float(max_err),
        "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
