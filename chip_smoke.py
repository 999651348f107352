#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (src/repro_torch) runs on a GPU.

    python3 chip_smoke.py          # one CUDA card; builds every kernel first

Phases, each fatal on failure:
  1. device: the card's name, count, and nvidia-smi name and power limit;
  2. build: every CUDA kernel of the main paths (ChaCha20, paged attention,
     int8 matmul, flash attention), one nvcc per source, all started
     together, for sm_90a; each kernel's registers, stack and spills as
     nvcc -Xptxas -v reports them (B4's and B5's summed up on a line each);
  3. kernel check: each kernel held against its plain PyTorch version on
     the card. ChaCha20 bit for bit (the RFC 8439 vector; random data at the
     main path's sizes: a token frame, a KV leaf, the largest weight,
     and the families path's largest leaf, deepseek-v3's expert stack,
     compared range by range; counter bases across the u32 wrap). Paged attention (B3) and its
     fused-unseal variant (B4) at the Llama2-7B geometry (bf16), at
     chameleon-34b's (bf16, 64 query heads over 8 kv heads) and a GQA
     f32 geometry, valid on and off page boundaries, an idle row, live and
     dead pages, within the stated tolerances; B4 on a ciphertext pool
     bit-equal to B3 on the same pool in plaintext; and every slot's B3 and
     B4 output bit-equal alone and in a batch of 16 at the larger timed
     shape (the split of the walk never depends on the batch); B4's
     keystream configuration (blocks a page, producer threads, ring
     stages) at each geometry. The int8 matmul (B5) bit for bit at
     Llama2-7B's FFN shapes for M = 1, 16, 128 and 2048, with an all-zero
     weight column, and the plan (regime, tiles, split of K) of each shape. Flash attention (B2) at [1, s, 32,
     128] bf16 for s = 128 and 4096, a ragged s = 200 (padded as
     ops.mha_flash pads it, and unpadded through the kernel's own edge
     masks), and a GQA f32 case, within the stated tolerances (and the
     share of each tolerance used);
  4. kernel timing: CUDA events at the main paths' shapes (B3 and B4 also
     at chameleon-34b's call), beside the bound, the plain version's time
     and, where one exists, a PyTorch call's; B4 also with every page dead
     (its walk without keystream), beside its keystream blocks timed at
     B1's measured rate;
  5. serve: Llama2-7B at full width (random weights from a seed) under a
     TDX trust domain: seal, attest, unseal (bit-exact), then two paths over
     a low-priority wave and a preempting high-priority wave: an Engine on
     the dense slot KV backend, then one on the paged backend with
     kv_decode="kernel" (B3, and B4 on pages restored as ciphertext), then
     the sharing path: the paged-kernel engine with prefix sharing and
     on-demand pages, every request sampled, over a shared 96-token system
     prompt, a pair of identical prompts whose shared partial page copies
     on write, and a preempting wave (B3 over pages two tables map, B4 on
     private pages restored as ciphertext while the shared head re-links).
     Then the store path: the paged-kernel engine with prefix sharing and a
     SealedPageStore (64 pages, cost policy) over four 128-token prompts
     that share a 96-token head and a preempting high-priority request, two
     epochs on one engine: the warm epoch hits the store and writes fewer
     pages, its tokens equal the cold epoch's, and a tampered store entry
     fails a consumer's admission before any page moves. Then the
     two-phase path: a burst of two 128-token prompts into sixteen 16-token
     ones (and a preempting high-priority request) under the slot baseline,
     slot continuous batching, the paged-kernel baseline and the
     paged-kernel dedicated prefill plan (its own CUDA stream, sealed
     handoff two rows a crossing): tokens equal within each backend, the
     handoff crossings as counted from the prefills in flight, TTFT and
     next-token latency per mode. Then the fleet path: two EngineWorkers
     sharing the weights behind an attested Gateway and a tenant-affinity
     Orchestrator, two tenants' sampled traffic over their own shared
     heads; the busiest worker is killed mid-decode (its KV migrates
     sealed under the tenant key domains and the survivor decodes it
     through B4), the killed name is respawned and the survivor drained
     onto it: every request equals its solo run and the run without the
     kill, the migrated bytes equal the migrants' sealed bytes, a
     cross-tenant restore fails MAC without a leak, and every pool ends
     all free. Then the RAG path: RAGPipeline in bm25+rerank mode over the
     paged-kernel engine, the corpus sealed through the bounce buffer, the
     dense encoder on the card ranking as on the CPU, each answer
     reproduced by engine.generate on its trimmed prompt (a determinism
     check: B3 at this engine's 9-page table is held to its plain walk in
     the kernel checks). Then the mesh path: the same weights on a dp=2
     mesh of logical shards on the card (ShardedPlan: each sharded leaf at
     rest in two chunks, gathered before every step), the slot path's
     waves on the slot backend and on the paged backend with gather decode:
     tokens bit-equal to the single-device engine's and to each request's
     solo run on the mesh engine, every sealed name tagged /s0 or /s1, a
     victim restored onto the other shard, one counted gather of half the
     non-norm weights a decode step, B1 the only kernel beside the
     prefills' B2. Then the TP path:
     the same weights on a tp=2 mesh of logical shards (each shard's
     heads and d_ff block as views, every layer's attention and FFN
     partials all-reduced), the same waves on the slot backend and on
     paged-gather: each request equal to its solo run on the tp=2 engine,
     the collective bytes a step equal to tp_step_bytes' formula, one
     decode step's logits within TP_LOGITS_REL_TOL of one device's, B1 the
     only kernel beside B2. Then, the weights freed, the ranks path: two processes
     on the card over gloo (file:// rendezvous under build/), each
     building the seed-0 weights in turn, checking their fingerprints
     against the parent's and keeping its tp=2 half; the slot waves on a
     tp=2 engine spanning the ranks give the TP path's tokens, sealed
     names and blob bytes bit for bit, every name sealed by one rank and
     the frames sent by rank 0 alone; then dp=2 over the same ranks on
     Llama2-7B cut to 2 layers gives a logical dp=2 run's tokens. Then the
     paged ranks path (PAGED_RANKS): Llama2-70B at published width, 2 of
     80 layers, dbrx-132b, 1 layer, and jamba-v0.1-52b, one group of 8 on
     an 11-page pool, each first on a logical tp=2 mesh here, then on a
     paged tp=2 engine with gather decode spanning two processes on the
     card (each rank its KV heads of every page and its Mamba channels of
     every row): tokens, page tables after every step, sealed names and
     blob bytes equal the logical run's, every page and recurrent row
     sealed whole by rank 0 through B1, every paused row's state frozen.
     Each path runs with every kernel count set to 0 just before it; every
     request's tokens must equal the same request served alone on a fresh
     engine of that path; the pool invariants hold after every sharing and
     store step, and sharing writes fewer pages than the same waves
     unshared; one
     decode step's logits on the paged-kernel path must agree with the
     slot path's for the same cache. Before the paths, the sampler's keys,
     raw bits and uniforms on the card must equal the CPU's bit for bit and
     its Gumbel noise stay within the stated ulp bound; it is timed at
     vocab 32000 and 2 rows;
  6. families: after Llama2-7B is freed, one model of each family beyond
     dense at its published widths, depth cut (FAMILIES): rwkv6-3b (4
     layers, slot backend), chameleon-34b (2 layers, paged-kernel: B3, and
     B4 on pages restored as ciphertext), dbrx-132b (1 layer), deepseek-v3
     (one MLA + dense and one MLA + MoE layer) and jamba (one group of 8)
     on the paged backend with gather decode; one at a time: random weights
     on the card, sealed, the plaintext freed, attested, unsealed bit-equal
     (by fingerprint: at most two copies of the weights on the card), then
     the low wave and a preempting request under tdx. Chameleon's and
     rwkv6's requests equal their solo runs; the MoE families' rerun on a
     fresh engine repeats every token; on jamba a partially evicted row's
     Mamba state stays bit-equal through a step it sits out. Every family
     but whisper then serves the same waves on a tp=2 mesh of logical
     shards over the same unsealed weights (FAMILY_TP: heads, experts, MLA
     heads, Mamba channels and rwkv6 heads split, every token routed on
     every shard; jamba's paused row frozen there too): each
     request equal to its solo run (the MoE families: a rerun on a fresh
     tp=2 engine), the collective bytes a step equal to tp_step_bytes, one
     decode step's logits within FAMILY_TP's limit of one device's (jamba:
     tp_f32_witness on its served weights upcast to f32, in f32 within
     TP_F32_TOL, in bf16 within TP_BF16_RATIO x one device's own error),
     B1 the only kernel beside B2. Then whisper-small at full size: prefill over
     1,500 frames and 16 decode steps, each within a stated tolerance of
     the cache-free forward;
  7. training: Llama2-7B at full width, 2 of 32 layers, bf16, with the
     reference's train variant (attention and loss chunks of 512, 8
     microbatches, full remat, f32 moments) on packed 8 x 1024-token
     batches: the chunked loss within a stated tolerance of the unchunked
     one, the first step's loss at 8 microbatches within 5e-2 of one
     microbatch's, a clean train_loop of 6 steps (every gradient finite,
     the loss falling, CUDA events a step), one step under
     FlopCounterMode beside the 6ND model FLOPs, then run_with_restarts
     over the same data with sealed checkpoints every 3 steps (keep_n=1)
     and a failure at step 4: one restart, two sealed saves and one sealed
     restore through B1, its losses and final state (by fingerprint)
     equal to the clean run's; last, the port's training launcher in a
     subprocess (smoke deepseek-7b on the card, a failure drill). Then the
     sharded training path: the same cut with FSDP on a dp=2 mesh of
     logical shards (make_sharded_train_step; 16 x 1,024 tokens a step,
     one row a shard of each microbatch): the first step's loss within a
     stated tolerance of one device's on the same global batch, the
     collective bytes a step equal to train_step_bytes' formula, each
     shard's state bytes; the same run through a sealed checkpoint (B1)
     and a FailureInjector kill, restored onto data=1, model=2 by
     restore_checkpoint(shardings=) with every leaf bit-equal to the saved
     one, its next loss within the tolerance of the uninterrupted run's;
     the tensor-parallel training path: the same cut on model=2 and
     data=2, model=2 logical shards (each shard's forward and backward on
     its heads and d_ff block), every loss and each leaf's update against
     the one-device run, the bytes a step equal to train_step_bytes' with
     tp, and the 2 x 2 state sealed (B1) and restored onto data=2, model=1
     bit for bit; two gloo ranks on the card training a 1-layer cut on
     dp=2 and on tp=2, every block and loss equal to a logical run's
     (deterministic algorithms on); GPipe over a LocalGroup(4), one
     Llama2-7B block a stage, output and gradient against the sequential
     stages; the launcher with --data-mesh 2 --model-mesh 2 in a
     subprocess; then dbrx at published width (1 of 40 layers, bf16
     moments) on data=2, model=2 with the batch split over data at
     capacity factor 1.0 (tokens dropped, each MoE layer routing the
     global batch) and whisper-small at full size on model=2 (bf16, and an
     f32 witness), each against one device with its params kept on the
     host. Beside these phases a subprocess runs the dry run
     (launch/dryrun.py, fake tensors on the card's torch): the training
     cut on 1 x 1, model=2 and 2 x 2 dry meshes, the TP path's tp=2 decode
     step and deepseek-7b's production cells (DRY_CELLS); after phase 8
     its counts are held to the runs above (phase_dryrun): collective
     bytes equal to train_step_bytes, tp_step_bytes and the bytes counted,
     FLOPs x n_chips equal to the real steps' FlopCounterMode counts, the
     1 x 1 footprint within DRY_MEM_TOL of a 1 x 1 step's peak memory;
  8. int8 weight path: the same model's weights quantized on the card
     (quant.quantize_params), sealed, attested and unsealed bit for bit,
     then ops.qmm (B5) on layer 0's unsealed w_gate, w_up and w_down (and
     on w_gate at M = 1, a decode-shaped call in the small-M regime) and
     ops.mha_flash (B2) on layer 0's q, k, v for a 128-token prompt, with
     every kernel count set to 0 just before; qmm bit-equal to its plain
     version and near the bf16 product with the original weights, flash
     near layers.sdpa;
  9. report: tokens, wall time, sealed bytes, seal/unseal time, peak device
     memory (slot, paged, sharing, store, two-phase, fleet and int8 paths),
     each family's load, step times, latency and memory (printed with
     phase 6), the training path's step time, tokens/s, model FLOPs and
     their share of the peak, checkpoint seal and restore rates and peak
     memory (printed with phase 7), TTFT and next-token latency of every serving path (the fleet's with
     and without the kill), the fleet's gateway and migration counters and
     its kill-to-resume time, the RAG path's retrieval and generation
     times, a bucket group's prefill
     as one batched call against one row a call (the plan's),
     the store's restore-vs-recompute price at the measured prefill time,
     the mesh path's wall, TTFT and next-token latency beside a warm
     single-device run on the same backend, the CUDA-event time of every
     decode step's gather (the plan's collective seconds) beside its bound,
     its link-tax line and peak memory, kernel launches on each path, and one JSON line listing every ported
     kernel, with its launches summed over the paths it runs on. The last
     line is the device JSON.

Imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and the peak rate
# of 32-bit integer ops: one op per lane per clock on the 128 lanes per SM
# behind the 67 TFLOP/s fp32 figure (which counts an FMA as 2 flops). Integer
# adds also issue on the FMA pipe (IMAD), so the 64 dedicated int32 lanes
# are not the limit: the kernel measured faster than 67e12 / 4 ops/s allows.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
# time_cuda holds the card with a sleep kernel of this many clocks per
# timed call (about 1 ms at the H100's 1.98 GHz boost) while the host
# queues the calls: a wrapper's host work (checks, allocation, the ctypes
# call) is some tens of us, as long as a short kernel itself
SLEEP_CYCLES_PER_CALL = 2_000_000

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
# the largest ChaCha20 call of the families path: sealing deepseek-v3's
# expert stack, [1, 256, 7168, 2048] bf16 = 114688 tiles; phase 3 checks it
# whole against the plain version range by range, and load_family holds
# every leaf it seals to at most this size
FAMILY_LEAF_BLOCKS = 114688 * 1024

# paged attention checks: (label, dtype, geometry, (rtol, atol) of
# torch.testing.assert_close against the plain version). The kernel sums in
# another order than the plain version's einsums, so a bf16 output may
# round one ulp (2**-8 relative) the other way; f32 agrees to 4.2e-7 and
# bf16 to 2.4e-4 absolute on these inputs (NVIDIA H100 80GB HBM3, 700 W).
PAGED_CASES = [
    ("llama2-7b bf16", "bfloat16",
     dict(b=4, h=32, hk=32, hd=128, ps=16, pages=16, valid=[256, 100, 0, 17]),
     (1e-2, 1e-3)),
    ("gqa f32", "float32",
     dict(b=3, h=8, hk=2, hd=64, ps=8, pages=6, valid=[48, 13, 0]),
     (1e-5, 1e-5)),
    # the RAG path's engine: 2 slots x 9 pages (max_len 144), 5 splits of
    # 2 pages whose last holds 1; a full slot and one at the trimmed prompt
    ("llama2-7b bf16, RAG 2 x 9 pages", "bfloat16",
     dict(b=2, h=32, hk=32, hd=128, ps=16, pages=9, valid=[144, 129]),
     (1e-2, 1e-3)),
    # the two-phase path's engine: 4 slots x 12 pages (max_len 192)
    ("llama2-7b bf16, two-phase 4 x 12 pages", "bfloat16",
     dict(b=4, h=32, hk=32, hd=128, ps=16, pages=12,
          valid=[192, 130, 17, 0]),
     (1e-2, 1e-3)),
    # the families path's chameleon-34b engine: GQA, 64 query heads over 8
    # kv heads (a group of 8 per CTA), 16 pages of 16
    ("chameleon-34b bf16, GQA 64/8", "bfloat16",
     dict(b=4, h=64, hk=8, hd=128, ps=16, pages=16, valid=[256, 100, 0, 17]),
     (1e-2, 1e-3)),
]
PAGED_LAYER = 5      # counter_base = layer * blocks_per_page
# the main path's paged call: one Llama2-7B layer, 2 slots at 256 positions
PAGED_MAIN = dict(b=2, h=32, hk=32, hd=128, ps=16, pages=16, valid=[256, 256])
# a larger shape where launch overhead no longer hides the kernel
PAGED_LARGE = dict(b=16, h=32, hk=32, hd=128, ps=16, pages=128,
                   valid=[2048] * 16)
# the families path's chameleon-34b call: one layer, 2 slots at 256
# positions, 64 query heads over 8 kv heads
PAGED_CHAMELEON = dict(b=2, h=64, hk=8, hd=128, ps=16, pages=16,
                       valid=[256, 256])
# one decode step's logits, paged-kernel vs slot path, bf16 Llama2-7B: the
# slot path's sdpa casts probabilities to bf16 before p.v, the kernel does
# not, so the two differ by bf16 rounding carried through 32 layers
LOGITS_REL_TOL = 0.05


# H100 SXM dense tensor-core peaks (NVIDIA data sheet): int8 ops/s and
# bf16 flop/s
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12

# B5 at Llama2-7B's FFN shapes: (label, K, N) and the rows M of the checks;
# the main path's call is w_gate at M = 128 (a 128-token prompt)
QMM_WEIGHTS = [("w_gate", 4096, 11008), ("w_down", 11008, 4096)]
QMM_ROWS = (1, 16, 128, 2048)
QMM_MAIN = ("w_gate", 128)
# B2 checks: (label, dtype, q [b, s, h, d], kv heads, blocks (bq, bkv),
# (rtol, atol) of torch.testing.assert_close against the plain version).
# The kernel tiles by 64 rows and the plain version by the reference's
# blocks, so the online softmax rescales at other points and f32 sums run
# in another order: f32 agrees to about 1e-6, and a bf16 output may round
# one ulp (2**-8 relative) the other way.
FLASH_CASES = [
    ("llama2-7b s=128 bf16", "bfloat16", (1, 128, 32, 128), 32, (128, 128),
     (1e-2, 1e-2)),
    ("llama2-7b s=4096 bf16", "bfloat16", (1, 4096, 32, 128), 32, (128, 128),
     (1e-2, 1e-2)),
    ("ragged s=200 bf16, padded", "bfloat16", (1, 200, 32, 128), 32, None,
     (1e-2, 1e-2)),
    ("ragged s=200 bf16, unpadded", "bfloat16", (1, 200, 32, 128), 32,
     (40, 40), (1e-2, 1e-2)),
    ("gqa f32", "float32", (2, 256, 8, 64), 2, (128, 128), (1e-5, 1e-5)),
    # the shapes the serving paths' prefills give B2 (blocks as
    # ops.mha_flash picks them): grouped-query bf16 at group 8, whisper's
    # decoder, and buckets shorter than one 64-row tile
    ("chameleon-34b 64/8 s=1024 bf16", "bfloat16", (1, 1024, 64, 128), 8,
     (128, 128), (1e-2, 1e-2)),
    ("mistral-nemo 32/8 s=2048 bf16", "bfloat16", (1, 2048, 32, 128), 8,
     (128, 128), (1e-2, 1e-2)),
    ("whisper-small decoder 12/12 hd 64 s=4 bf16", "bfloat16",
     (1, 4, 12, 64), 12, (4, 4), (1e-2, 1e-2)),
    ("whisper-small decoder 12/12 hd 64 s=448 bf16", "bfloat16",
     (1, 448, 12, 64), 12, (128, 128), (1e-2, 1e-2)),
    ("deepseek-7b bucket s=32 bf16", "bfloat16", (1, 32, 32, 128), 32,
     (32, 32), (1e-2, 1e-2)),
    ("mistral-nemo 32/8 bucket s=32 bf16", "bfloat16", (1, 32, 32, 128), 8,
     (32, 32), (1e-2, 1e-2)),
]
# the int8 path: ops.qmm against the bf16 product with the original weights
# by relative error (||diff|| / ||product||), within QMM_ERR_MARGIN times
# what int8 rounding predicts for those operands (qmm_err_limit). A fixed
# limit does not fit both inputs: the reference's test allows 0.05 (max
# |diff| / max |product|) on Gaussian x, but w_down's input silu(gate) * up
# has a crest (max / rms) near 20, so its per-tensor step, and its error,
# is about 4x that of a Gaussian x. ops.mha_flash against layers.sdpa
# within (rtol, atol): sdpa rounds probabilities to bf16 before p.v, the
# kernel keeps them f32
QMM_ERR_MARGIN = 1.5
FLASH_SDPA_TOL = (2e-2, 2e-2)
QUANT_PROMPT = 128
# the int8 path runs at full width but QUANT_LAYERS of Llama2-7B's 32
# layers deep: it reads layer 0 only, and sealing all 32 quantized layers
# cost some 17 s of host MAC a run
QUANT_LAYERS = 2


def qmm_err_limit(x, w) -> float:
    """QMM_ERR_MARGIN times the relative error that int8 rounding predicts
    for ``x @ w``: x per tensor and w per column, each rounded to a step of
    max / 127, add uniform noise of step / sqrt(12), which relative to the
    operand's rms is crest / (127 sqrt(12)) with crest = max |.| / rms; the
    two add in quadrature (w's worst column taken)."""
    import math
    xf, wf = x.float(), w.float()
    crest_x = float(xf.abs().max() / xf.square().mean().sqrt())
    crest_w = float((wf.abs().amax(0) / wf.square().mean(0).sqrt()).max())
    return (QMM_ERR_MARGIN * math.hypot(crest_x, crest_w)
            / (127 * math.sqrt(12)))


def ptxas_summary(ptxas: str) -> list:
    """(kernel with its template arguments, registers, spill bytes) per
    entry function in nvcc -Xptxas -v output."""
    import re
    out, name = [], None
    for line in ptxas.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\S+?)'?( for|$)", line)
        if m:
            mangled = m.group(1)
            k = re.search(r"\d+([a-z_]+_kernel)I(.*?)EEv", mangled)
            name = (f"{k.group(1)}<{','.join(re.findall(r'L[bi](\d+)E', k.group(2) + 'E'))}>"
                    if k else mangled)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
            out.append([name, None, spill])
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            if out and out[-1][0] == name and out[-1][1] is None:
                out[-1][1] = int(m.group(1))
            else:
                out.append([name, int(m.group(1)), 0])
    return out


def paged_keystream_text(P, hk, hd, ps, es) -> str:
    """B4's keystream configuration at one geometry."""
    nb = P.keystream_blocks(hk, ps, hd * es // 4)
    return (f"{nb} keystream blocks a page for K and {nb} for V (of "
            f"{ps * hk * hd * es // 64} in the page), {P.PRODUCERS} producer "
            f"threads beside 128 consumers, a ring of {P.KS_STAGES} pages, "
            f"block stride {P.KS_STRIDE} words")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_cuda(fn, iters: int, warmup: int = 1,
              sleep_cycles: int = SLEEP_CYCLES_PER_CALL) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls.
    The calls are queued behind a sleep kernel of ``sleep_cycles`` a call,
    so the card runs them back to back and the events time the device's
    work, not the rate at which the host issues it (for work whose host
    side outlasts the sleep, the plain versions' thousands of launches,
    the time stays host-bound)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles * iters)
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
    # the families path's largest leaf: one launch over the whole tensor,
    # compared with the plain version over W_GATE_BLOCKS columns at a time
    # (each range's counters start at its first block), so the plain
    # version's temporaries stay those of the size above; every range is
    # compared, the counter wrapping past 2**32 in the second case
    n_blocks = FAMILY_LEAF_BLOCKS
    gen = torch.Generator(device=dev).manual_seed(1)
    data = torch.randint(0, 256, (16 * n_blocks * 4,), dtype=torch.uint8,
                         device=dev, generator=gen).view(torch.int32)
    data = data.view(16, n_blocks)
    for cb in (0, 2**32 - 2):
        kw = rng.integers(0, 2**32, 8, dtype=np.uint32)
        nw = rng.integers(0, 2**32, 3, dtype=np.uint32)
        out = C.chacha20_xor_blocked(kw, nw, data, counter_base=cb)
        err = 0
        for a in range(0, n_blocks, W_GATE_BLOCKS):
            b = min(a + W_GATE_BLOCKS, n_blocks)
            plain = C.chacha20_xor_plain(kw, nw, data[:, a:b],
                                         counter_base=(cb + a) % 2**32)
            err = max(err, int((out[:, a:b].long() - plain.long())
                               .abs().max()))
            del plain
        torch.cuda.synchronize()
        worst = max(worst, err)
        check(err == 0, f"kernel == plain at N={n_blocks} (the families' "
                        f"largest leaf), counter_base={cb} (max |diff| {err})")
        print(f"  N={n_blocks} counter_base={cb}: bit-equal over "
              f"{-(-n_blocks // W_GATE_BLOCKS)} ranges")
        del out
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


def paged_case(torch, np, dtype, *, b, h, hk, hd, ps, pages, valid,
               live_every=2, copies=1, seed=0, sealed=True):
    """Random q and pools on the card (``copies`` layers of them), a
    shuffled page table, and a ciphertext copy of the pools in which every
    ``live_every``-th mapped page is sealed as the paged backend seals an
    [L, ps, hk, hd] page (this layer's slice placed in the pool, its
    sidecar row armed). With ``sealed=False`` (timing only) the live pages
    keep their plaintext bits under random nonces: the kernel's work is the
    same, its output garbage."""
    from repro_torch.core import SealingKey
    from repro_torch.core.sealing import nonce_words_for, seal_tensor
    from repro_torch.kernels import ops
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = b * pages
    shape = (copies, n + 1, ps, hk, hd)
    kp = torch.randn(shape, generator=g, device="cuda").to(dt)
    vp = torch.randn(shape, generator=g, device="cuda").to(dt)
    q = torch.randn((b, h, hd), generator=g, device="cuda").to(dt)
    perm = np.random.default_rng(seed).permutation(n) + 1
    table = torch.as_tensor(perm.reshape(b, pages).astype(np.int32),
                            device="cuda")
    key = SealingKey.generate(b"chip-smoke-paged")
    crypts, cipher = [], []
    live = perm[::live_every].tolist()
    rng = np.random.default_rng(seed)
    for leaf, pool in (("k", kp), ("v", vp)):
        crypt = np.zeros((n + 1, 4), np.uint32)
        cp = pool.clone() if sealed else pool
        for phys in live if not sealed else ():
            crypt[phys, :3] = rng.integers(0, 2**32, 3, dtype=np.uint32)
            crypt[phys, 3] = 1
        for phys in live if sealed else ():
            stacked = torch.zeros((PAGED_LAYER + 1,) + pool.shape[2:],
                                  dtype=dt, device="cuda")
            stacked[PAGED_LAYER] = pool[0, phys]
            name = f"smoke['{leaf}']/p{phys}"
            st = seal_tensor(key, name, stacked)
            bits = ops.unpack_u32(st.ciphertext, st.n_bytes).view(dt)
            cp[0, phys] = bits.reshape(stacked.shape)[PAGED_LAYER]
            crypt[phys, :3], crypt[phys, 3] = nonce_words_for(key, name), 1
        crypts.append(torch.as_tensor(crypt.view(np.int32), device="cuda"))
        cipher.append(cp)
    bpp = ps * hk * hd * kp.element_size() // 64
    return dict(q=q, plain=(kp, vp), cipher=tuple(cipher), table=table,
                valid=torch.as_tensor(np.asarray(valid, np.int32),
                                      device="cuda"),
                crypts=tuple(crypts), key=np.frombuffer(key.key, np.uint32),
                bpp=bpp, n_live=len(live))


def phase_paged_check(P, torch, np) -> dict:
    """B3 and B4 against their plain versions on the card, and B4 on
    ciphertext against B3 on plaintext bit for bit. Returns the max
    |kernel - plain| per kernel."""
    worst = {"paged_attention": 0.0, "paged_attention_unseal": 0.0}
    for label, dtype, geo, tol in PAGED_CASES:
        c = paged_case(torch, np, dtype, **geo)
        plain = tuple(p[0] for p in c["plain"])
        cipher = tuple(p[0] for p in c["cipher"])
        args = (c["table"], c["valid"])
        b3 = P.paged_attention(c["q"], *plain, *args)
        b4 = P.paged_attention_unseal(c["q"], *cipher, *args, PAGED_LAYER,
                                      c["key"], *c["crypts"],
                                      blocks_per_page=c["bpp"])
        torch.cuda.synchronize()
        ref3 = P.paged_attention_plain(c["q"], *plain, *args)
        ref4 = P.paged_attention_unseal_plain(
            c["q"], *cipher, *args, PAGED_LAYER, c["key"], *c["crypts"],
            blocks_per_page=c["bpp"])
        for name, out, ref in (("paged_attention", b3, ref3),
                               ("paged_attention_unseal", b4, ref4)):
            err = float((out.float() - ref.float()).abs().max())
            worst[name] = max(worst[name], err)
            try:
                torch.testing.assert_close(out, ref, rtol=tol[0], atol=tol[1])
            except AssertionError as e:
                check(False, f"{name} vs plain at {label}: {e}")
        check(torch.equal(b4, b3), f"B4 on ciphertext == B3 on plaintext, "
                                   f"bit for bit, at {label}")
        idle = [i for i, v in enumerate(geo["valid"]) if v == 0]
        check(not b3[idle].any(), f"idle row attends nothing at {label}")
        print(f"  {label}: B3 max |err| {float((b3.float() - ref3.float()).abs().max()):.3g}, "
              f"B4 max |err| {float((b4.float() - ref4.float()).abs().max()):.3g} "
              f"(rtol, atol {tol}); B4(ciphertext) == B3(plaintext) bit for bit; "
              f"{c['n_live']} of {geo['b'] * geo['pages']} pages live")
        print(f"    B4 at {label}: " + paged_keystream_text(
            P, geo["hk"], geo["hd"], geo["ps"], c["q"].element_size()))
        del c, b3, b4, ref3, ref4
    torch.cuda.empty_cache()
    return worst


def phase_paged_batch_check(P, torch, np) -> None:
    """Every slot's B3 and B4 output bit-equal alone (b = 1) and inside the
    batch of 16 at PAGED_LARGE's shape, with valid lengths staggered across
    the slots (the split never depends on the batch or another slot's
    valid). Every 8th page is sealed, so B4 decrypts live pages and must
    also give B3's bits."""
    geo = dict(PAGED_LARGE, valid=[PAGED_LARGE["valid"][0] - 131 * i
                                   for i in range(PAGED_LARGE["b"])])
    c = paged_case(torch, np, "bfloat16", **geo, live_every=8, seed=3)
    plain = tuple(p[0] for p in c["plain"])
    cipher = tuple(p[0] for p in c["cipher"])
    unseal = dict(layer=PAGED_LAYER, key_words=c["key"], k_crypt=c["crypts"][0],
                  v_crypt=c["crypts"][1], blocks_per_page=c["bpp"])
    b3 = P.paged_attention(c["q"], *plain, c["table"], c["valid"])
    b4 = P.paged_attention_unseal(c["q"], *cipher, c["table"], c["valid"],
                                  **unseal)
    check(torch.equal(b4, b3), f"B4 on ciphertext == B3 on plaintext at "
                               f"{geo['b']} slots")
    for i in range(geo["b"]):
        one = [t[i:i + 1].contiguous() for t in (c["q"], c["table"], c["valid"])]
        check(torch.equal(P.paged_attention(one[0], *plain, *one[1:]),
                          b3[i:i + 1]), f"slot {i}'s B3 bits alone == in the "
                                        f"batch of {geo['b']}")
        check(torch.equal(P.paged_attention_unseal(one[0], *cipher, *one[1:],
                                                   **unseal), b4[i:i + 1]),
              f"slot {i}'s B4 bits alone == in the batch of {geo['b']}")
    torch.cuda.synchronize()
    print(f"  B3 and B4 at {geo['b']} slots x {geo['pages']} pages (valid "
          f"{geo['valid'][-1]}..{geo['valid'][0]}, {c['n_live']} pages "
          f"sealed): every slot's output bit-equal alone and in the batch; "
          f"B4 == B3")
    del c, b3, b4
    torch.cuda.empty_cache()


def library_attention(F, q, k_pool, v_pool, table):
    """The gather ``pool[table]`` plus PyTorch's scaled_dot_product_attention
    over the same work (every table position valid): the yardstick, used
    nowhere in the port."""
    b, h, hd = q.shape
    hk = k_pool.shape[2]
    k = k_pool[table.long()].reshape(b, -1, hk, hd).transpose(1, 2)
    v = v_pool[table.long()].reshape(b, -1, hk, hd).transpose(1, 2)
    return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                          enable_gqa=h != hk)


def paged_bounds(c, geo) -> dict:
    """Least times for B3 and B4 on this case: q, out and the attended K and
    V pages once at the memory rate; for B4 also 992 integer ops per 64-B
    block XORed (the live attended pages) at the int32 rate."""
    es = c["q"].element_size()
    pages = sum(-(-v // geo["ps"]) for v in geo["valid"])
    kv_bytes = 2 * pages * geo["ps"] * geo["hk"] * geo["hd"] * es
    nbytes = 2 * c["q"].numel() * es + kv_bytes
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    live_frac = c["n_live"] / (geo["b"] * geo["pages"])
    blocks = 2 * pages * live_frac * c["bpp"]
    ops_ms = blocks * CHACHA_OPS_PER_BLOCK / INT32_OPS_PER_S * 1e3
    return {"b3": (bytes_ms, "bytes"),
            "b4": (max(bytes_ms, ops_ms),
                   "operations" if ops_ms > bytes_ms else "bytes"),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bytes": nbytes,
            "ks_blocks": blocks}


def phase_paged_timing(P, torch, np, F) -> dict:
    """CUDA events at the main path's call (8 layer copies of the pools in
    turn, 67 MB, so the 50 MB L2 does not hold them between calls), at the
    larger shape and at the families path's chameleon-34b call."""
    out = {}
    # 32 layer copies of chameleon's pools (hk 8) are 69 MB, as 8 of
    # Llama2-7B's (hk 32) are 67 MB
    for tag, geo, copies in (("main", PAGED_MAIN, 8), ("large", PAGED_LARGE, 1),
                             ("chameleon", PAGED_CHAMELEON, 32)):
        c = paged_case(torch, np, "bfloat16", **geo, live_every=1,
                       copies=copies, seed=1, sealed=False)
        args = (c["table"], c["valid"])

        def run(fn):
            return lambda: [fn(i) for i in range(copies)]

        def b3(i):
            return P.paged_attention(c["q"], c["plain"][0][i],
                                     c["plain"][1][i], *args)

        def b4(i):
            return P.paged_attention_unseal(
                c["q"], c["cipher"][0][i], c["cipher"][1][i], *args,
                PAGED_LAYER, c["key"], *c["crypts"], blocks_per_page=c["bpp"])

        dead = torch.zeros_like(c["crypts"][0])

        def b4_dead(i):     # every sidecar dead: B4's walk without keystream
            return P.paged_attention_unseal(
                c["q"], c["cipher"][0][i], c["cipher"][1][i], *args,
                PAGED_LAYER, c["key"], dead, dead, blocks_per_page=c["bpp"])

        def lib(i):
            return library_attention(F, c["q"], c["plain"][0][i],
                                     c["plain"][1][i], c["table"])

        r = {"ms3": time_cuda(run(b3), 20, 2) / copies,
             "ms4": time_cuda(run(b4), 20, 2) / copies,
             "ms4_dead": time_cuda(run(b4_dead), 20, 2) / copies,
             "lib3": time_cuda(run(lib), 20, 2) / copies}
        if tag == "main":
            plain = tuple(p[0] for p in c["plain"])
            cipher = tuple(p[0] for p in c["cipher"])
            r["plain3"] = time_cuda(lambda: P.paged_attention_plain(
                c["q"], *plain, *args), 3, 1)
            r["plain4"] = time_cuda(lambda: P.paged_attention_unseal_plain(
                c["q"], *cipher, *args, PAGED_LAYER, c["key"], *c["crypts"],
                blocks_per_page=c["bpp"]), 2, 1)
        r.update(paged_bounds(c, geo))
        out[tag] = r
        del c
        torch.cuda.empty_cache()
    return out


def qmm_case(torch, k, n, rows, seed=0, copies=1):
    """Random int8 x ``[max(rows), k]`` and ``copies`` int8 w ``[k, n]``
    with column 5 all zero, and an f32 scale ``[1, n]`` (activation scale
    folded in), on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-127, 128, (max(rows), k), generator=g, device="cuda",
                      dtype=torch.int8)
    ws = []
    for _ in range(copies):
        w = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                          dtype=torch.int8)
        w[:, 5] = 0
        ws.append(w)
    scale = torch.rand((1, n), generator=g, device="cuda") * 1e-3 + 1e-5
    return x, ws, scale


def qmm_plan_text(Q, m, n, k) -> str:
    """B5's plan for one shape as the wrapper picks it on this card."""
    import torch
    p = Q.qmm_plan(m, n, k, torch.cuda.get_device_properties(0)
                   .multi_processor_count)
    ctas = -(-n // Q.BN) * -(-m // p.bm) * p.splits
    return (f"{p.regime}-M regime, {p.bm} x {Q.BN} tiles, {p.stages}-stage "
            f"ring, K split {p.splits} x {p.k_per_split} (cluster of "
            f"{p.splits}), {ctas} CTAs")


def phase_qmm_check(Q, torch) -> int:
    """B5 against its plain version (float64, exact) bit for bit at
    Llama2-7B's FFN shapes; returns the max |kernel - plain| (0)."""
    worst = 0.0
    for label, k, n in QMM_WEIGHTS:
        x, (w,), scale = qmm_case(torch, k, n, QMM_ROWS)
        for m in QMM_ROWS:
            for out_dtype in ((torch.bfloat16, torch.float32) if m == 16
                              else (torch.bfloat16,)):
                got = Q.qmatmul(x[:m], w, scale, out_dtype=out_dtype)
                ref = Q.qmatmul_plain(x[:m], w, scale, out_dtype=out_dtype)
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                worst = max(worst, err)
                check(torch.equal(got, ref), f"qmatmul == plain at {label} "
                      f"[{m}, {k}] x [{k}, {n}] {out_dtype} (max |diff| {err})")
                check(not got[:, 5].any(), "the all-zero weight column gives 0")
        print(f"  qmatmul {label} [M, {k}] x [{k}, {n}], M in {QMM_ROWS}: "
              f"bit-equal to plain (bf16 out; f32 out too at M=16)")
        for m in QMM_ROWS:
            print(f"    plan at M={m}: {qmm_plan_text(Q, m, n, k)}")
        del x, w, scale
    torch.cuda.empty_cache()
    return worst


def flash_inputs(torch, dtype, shape, hk, seed=0):
    """Random q ``[b, s, h, d]`` and k/v ``[b, s, hk, d]`` on the card."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, s, h, d = shape
    q = torch.randn((b, s, h, d), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((b, s, hk, d), generator=g, device="cuda").to(dt)
            for _ in range(2))
    return q, k, v


def to_heads(x, s_pad=None):
    """[b, s, h, d] -> contiguous [b * h, s_pad, d], zero rows past s (the
    layout and padding of ops.mha_flash)."""
    import torch
    b, s, h, d = x.shape
    y = x.transpose(1, 2).reshape(b * h, s, d)
    if s_pad and s_pad != s:
        y = torch.cat([y, y.new_zeros(b * h, s_pad - s, d)], dim=1)
    return y.contiguous()


def tolerance_share(got, ref, tol) -> float:
    """The largest |got - ref| / (atol + rtol |ref|): 1 is the edge of
    torch.testing.assert_close's tolerance."""
    g, r = got.float(), ref.float()
    return float(((g - r).abs() / (tol[1] + tol[0] * r.abs())).max())


def phase_flash_check(FA, torch) -> float:
    """B2 against its plain version within the stated tolerances; returns
    the max |kernel - plain| over the checks. Prints the share of the
    tolerance each case uses: B2's bf16 path rounds p to bf16 before p.v,
    and a share past one half would call for a second (lo) p.v product."""
    worst = 0.0
    for label, dtype, shape, hk, blocks, tol in FLASH_CASES:
        q, k, v = flash_inputs(torch, dtype, shape, hk)
        s = shape[1]
        bq, bkv = blocks or (128, 128)
        s_pad = s + (-s) % bq
        qf, kf, vf = (to_heads(t, s_pad) for t in (q, k, v))
        got = FA.flash_attention(qf, kf, vf, bq=bq, bkv=bkv)
        torch.cuda.synchronize()
        ref = FA.flash_attention_plain(qf, kf, vf, bq=bq, bkv=bkv)
        got, ref = got[:, :s], ref[:, :s]
        err = float((got.float() - ref.float()).abs().max())
        worst = max(worst, err)
        check(bool(torch.isfinite(got).all()), f"flash finite at {label}")
        try:
            torch.testing.assert_close(got, ref, rtol=tol[0], atol=tol[1])
        except AssertionError as e:
            check(False, f"flash_attention vs plain at {label}: {e}")
        print(f"  flash {label} (kernel s={s_pad}, plain blocks {bq}x{bkv}): "
              f"max |err| {err:.3g} (rtol, atol {tol}; "
              f"{tolerance_share(got, ref, tol):.3f} of it used)")
        del q, k, v, qf, kf, vf, got, ref
    torch.cuda.empty_cache()
    return worst


def library_qmm(torch, x, w, scale):
    """torch._int_mm plus the scale multiply and the bf16 cast: the
    yardstick, used nowhere in the port."""
    return (torch._int_mm(x, w).float() * scale).to(torch.bfloat16)


def phase_qmm_timing(Q, torch) -> dict:
    """CUDA events at every checked shape, cycling two weight copies (90 MB,
    past the 50 MB L2) so each call reads its weight from device memory."""
    out = {}
    for label, k, n in QMM_WEIGHTS:
        x, ws, scale = qmm_case(torch, k, n, QMM_ROWS, seed=1, copies=2)
        for m in QMM_ROWS:
            xm = x[:m].contiguous()

            def cycle(fn):
                return lambda: [fn(w) for w in ws]

            r = {"ms": time_cuda(cycle(lambda w: Q.qmatmul(xm, w, scale)),
                                 20, 2) / 2,
                 "plain_ms": time_cuda(lambda: Q.qmatmul_plain(
                     xm, ws[0], scale), 3, 1)}
            r["lib_ms"] = None
            r["plan"] = qmm_plan_text(Q, m, n, k)
            if m > 16:      # torch._int_mm takes M > 16, K and N % 8 == 0
                r["lib_ms"] = time_cuda(cycle(lambda w: library_qmm(
                    torch, xm, w, scale)), 20, 2) / 2
            nbytes = m * k + k * n + 4 * n + 2 * m * n
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * m * n * k / INT8_OPS_PER_S * 1e3
            r.update(bytes_ms=bytes_ms, ops_ms=ops_ms,
                     bound_ms=max(bytes_ms, ops_ms),
                     bound_by="operations" if ops_ms > bytes_ms else "bytes")
            out[(label, m)] = r
        del x, ws, scale
    torch.cuda.empty_cache()
    return out


def phase_flash_timing(FA, torch, F) -> dict:
    """CUDA events at [1, s, 32, 128] bf16 for s = 128 (the path's call)
    and 4096, beside the plain version and scaled_dot_product_attention."""
    out = {}
    for s in (128, 4096):
        q, k, v = flash_inputs(torch, "bfloat16", (1, s, 32, 128), 32, seed=1)
        qf, kf, vf = (to_heads(t) for t in (q, k, v))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        iters = 20 if s == 128 else 5
        r = {"ms": time_cuda(lambda: FA.flash_attention(qf, kf, vf), iters, 2),
             "plain_ms": time_cuda(lambda: FA.flash_attention_plain(
                 qf, kf, vf), 2, 1),
             "lib_ms": time_cuda(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True), iters, 2)}
        bh, d = 32, 128
        bytes_ms = 4 * bh * s * d * 2 / HBM_BYTES_PER_S * 1e3
        flops_ms = 4 * d * (s * (s + 1) // 2) * bh / BF16_FLOPS_PER_S * 1e3
        r.update(bytes_ms=bytes_ms, flops_ms=flops_ms,
                 bound_ms=max(bytes_ms, flops_ms),
                 bound_by="operations" if flops_ms > bytes_ms else "bytes")
        out[s] = r
        del q, k, v, qf, kf, vf, qt, kt, vt
    torch.cuda.empty_cache()
    return out


# (prompt length, max_new_tokens, priority): the low wave's first two share
# the 32 bucket (one batched prefill of two rows); the last high request
# chunks past the largest bucket (its tail feeds through decode steps).
LOW_WAVE = [(20, 16, 0), (24, 12, 0), (100, 10, 0), (40, 14, 0)]
HIGH_WAVE = [(50, 8, 5), (150, 6, 5)]
ENGINE_KW = dict(kv_backend="slot", max_slots=2, max_len=256,
                 prefill_buckets=(32, 64, 128))
PAGED_KW = dict(ENGINE_KW, kv_backend="paged", page_size=16,
                kv_decode="kernel")


# the sharing path: the paged-kernel engine with prefix sharing (on-demand
# pages implied), every request sampled (temperature 0.9, top-k 16, seeds
# 100 and up). A pair of identical 20-token prompts goes first and lands in
# one batched prefill; then a low wave of four 128-token prompts whose first
# 96 tokens (6 pages) are one shared system prompt, and after 3 steps a
# high wave: one more prompt with that head, and one of 150 tokens that
# chunks. Buckets that are multiples of the page leave no partial page, so
# the 24 bucket is added: the pair's second page is then a shared partial
# page, copied on write by the first decode. Every page a sharing request
# prefills is content-indexed and seals by reference, so the second low
# opts out (share_prefix=False): its full pages are private, and its
# restore admits them as ciphertext for B4 while its batch-mate's shared
# head re-links.
SHARE_KW = dict(PAGED_KW, prefix_sharing=True,
                prefill_buckets=(24, 32, 64, 128))
SHARE_PAIR = [(20, 3, 0)]  # (prompt length, max_new_tokens, priority), x2
SHARE_HEAD = 96
SHARE_LOW = [(128, 16, 0), (128, 12, 0), (128, 10, 0), (128, 14, 0)]
SHARE_OPT_OUT = 3          # the spec index (after the pair) that opts out
SHARE_HIGH = [(128, 8, 5), (150, 6, 5)]
SAMPLE_SEED0 = 100

# the store path (the reference bench's page_store_sweep, on the card):
# the paged-kernel engine with prefix sharing and a SealedPageStore (64
# pages, cost policy), one 128-token bucket; four 128-token prompts share a
# 96-token head (6 pages), every request sampled (temperature 0.8, top-k
# 32), served twice on one engine. A high-priority request with the same
# head arrives STORE_HIGH_AT steps into each epoch and preempts the later
# low, whose full private decode page then comes back as ciphertext (B4).
# bucket groups whose prefill is timed as one [rows, s] call against the
# plan's one row a call: two rows of the slot and paged paths' 128 bucket,
# four 16-token rows of the two-phase path's short stream
PREFILL_GROUPS = [(2, 128), (4, 16)]
STORE_KW = dict(PAGED_KW, prefix_sharing=True, prefill_buckets=(128,))
STORE_BUDGET = 64
STORE_HEAD = 96
STORE_LOW = [(128, 32, 0)] * 4
STORE_HIGH = (128, 8, 5)
STORE_HIGH_AT = 20
STORE_SEED0 = 500
# the two-phase path (the reference bench's two_phase_sweep, on the card):
# 4 slots, max_len 192, buckets 16 and 128; two 128-token prompts burst into
# a stream of sixteen 16-token ones (numpy seed 31), all sampled as there,
# and a high-priority 16-token request at step TWO_PHASE_HIGH_AT preempts
# (on the paged backend its victim's full pages come back as ciphertext).
# Baseline and continuous batching run on the slot backend, baseline and
# the dedicated prefill plan (two rows a sealed handoff) on the
# paged-kernel backend: tokens agree within a backend, and every request
# equals its solo run on that backend (slot and paged-kernel tokens differ
# where the slot sdpa's bf16 probabilities tip a sample).
TWO_PHASE_KW = dict(max_slots=4, max_len=192, prefill_buckets=(16, 128))
TWO_PHASE_STEP_TOKENS = 130
TWO_PHASE_HIGH_AT = 2
TWO_PHASE_MODES = {
    "slot baseline": dict(kv_backend="slot"),
    "slot continuous": dict(kv_backend="slot", continuous_batching=True,
                            step_tokens=TWO_PHASE_STEP_TOKENS),
    "paged-kernel baseline": dict(kv_backend="paged", page_size=16,
                                  kv_decode="kernel"),
    "paged-kernel two-plan": dict(kv_backend="paged", page_size=16,
                                  kv_decode="kernel",
                                  prefill_plan="dedicated", handoff_batch=2),
}
# the fleet path (the reference's examples/fleet_rag.py at Llama2-7B width):
# two EngineWorkers on the card share the unsealed weights, each its own
# tdx TrustDomain, behind a Gateway (attestation, tenant key domains,
# prompt envelopes) and a tenant-affinity Orchestrator. The paged-kernel
# engine with prefix sharing, 2 slots, max_len 256, one 128 bucket. Two
# tenants each send four 128-token prompts over their own 96-token head
# (numpy seed 29), sampled (temperature 0.7, top-k 20, a seed per request)
# for 16 tokens. After FLEET_KILL_AT fleet steps the busiest worker is
# killed: its requests migrate sealed under their tenant's key domain to
# the survivor, which restores them as ciphertext (B4) once a slot frees.
# When a migrant has decoded its next token there, the killed worker's name
# is respawned once through the worker factory, the survivor is drained
# onto it, and the fleet runs to the end.
FLEET_KW = dict(PAGED_KW, prefix_sharing=True, prefill_buckets=(128,))
FLEET_TENANTS = ("hospital", "bank")
FLEET_HEAD = 96
FLEET_PROMPT = 128
FLEET_PER_TENANT = 4
FLEET_NEW = 16
FLEET_KILL_AT = 4
FLEET_SEED0 = 700
# the RAG path: RAGPipeline in bm25+rerank mode over the paged-kernel
# Llama2-7B engine (tdx) and the tests' corpus (tests/test_rag.py: fifteen
# synthetic five-sentence documents and one needle); the corpus crosses the
# bounce buffer sealed, the dense encoder (bf16, the port's seeded init)
# runs on the card. Its card embeddings must agree with the CPU's on the
# same weights within RAG_EMB_TOL (two bf16 roundings of a unit-norm
# embedding) and rank the documents the same up to near ties (two
# documents whose CPU scores lie within 2 x RAG_EMB_TOL may swap). The
# engine's max_len 144 holds the 128 bucket and 16 new tokens, so the
# pipeline trims each prompt to 129 tokens: one bucket's prefill and one
# prompt token fed through decode.
RAG_KW = dict(PAGED_KW, max_len=144)
RAG_QUERIES = ("confidential enclave attestation llama",
               "which enclave protects patient records?")
RAG_TOP_K = 3
RAG_NEW = 16
RAG_EMB_TOL = 4e-3
# the card's Gumbel noise against the CPU's: both evaluate -log(-log(u)) in
# float64 and round to float32, so they may differ where the two float64
# logs round the last bit apart (tests/test_torch_sampling.py states the
# same bound in ulps of max(|g|, 1) against jax's float32 noise)
GUMBEL_ULPS = 3


def check_pool_invariants(kv) -> None:
    """The paged pool's structural invariants at a step boundary (a copy of
    tests/conftest.py's, which this script does not import): no leaked or
    double-freed page, the null page never mapped, refcounts equal to the
    live table mappings, a consistent two-way content index, and parked
    ciphertext only while sealed references remain."""
    from collections import Counter
    mapped = []
    for slot in range(kv.max_slots):
        n = int(kv._alloc[slot])
        check(bool((kv.table[slot, n:] == 0).all()),
              f"slot {slot}: no mapping past its allocation")
        pages = [int(p) for p in kv.table[slot, :n]]
        check(0 not in pages, f"slot {slot} never maps the null page")
        mapped.extend(pages)
    free = [int(p) for p in kv._free_pages]
    check(0 not in free and len(set(free)) == len(free),
          "free list: no null page, no double free")
    check(not set(free) & set(mapped), "no page both free and mapped")
    check(len(free) + len(set(mapped)) == kv.num_pages, "no page leaked")
    counts = Counter(mapped)
    check(all(int(kv._page_ref[p]) == counts.get(p, 0)
              for p in range(1, kv.num_pages + 1)),
          "refcounts equal the live mappings")
    check(len(kv._index) == len(kv._page_key) and all(
        kv._page_key.get(p) == k and counts.get(p, 0) >= 1
        for k, p in kv._index.items()), "content index consistent")
    check(all(kv._sealed_refs.get(k, 0) > 0 for k in kv._parked),
          "parked ciphertext only while sealed references remain")
    store = kv.page_store
    check(store is None or store.budget_pages is None
          or store.resident_pages <= store.budget_pages,
          "the page store within its budget")


def phase_sampler(torch, np) -> dict:
    """The sampler on the card against the CPU for the same seeds and
    steps (keys, raw bits and uniforms bit for bit; Gumbel noise within
    GUMBEL_ULPS), and its time at vocab 32000 and 2 rows."""
    from repro_torch.runtime import sampling as S
    b, v = 2, 32000
    tiny = float(np.finfo(np.float32).tiny)
    keys = torch.as_tensor(np.stack([S.prng_key(SAMPLE_SEED0 + i)
                                     for i in range(64)]).astype(np.int64))
    steps = torch.arange(64, dtype=torch.int64) * 37
    fk = S.fold_in(keys, steps)
    fk_card = S.fold_in(keys.cuda(), steps.cuda())
    check(torch.equal(fk_card.cpu(), fk), "sampler keys on the card == CPU")
    check(torch.equal(S.random_bits(fk_card, (v,)).cpu(),
                      S.random_bits(fk, (v,))),
          "sampler raw bits on the card == CPU")
    check(torch.equal(S.uniform(fk_card, (v,), minval=tiny).cpu(),
                      S.uniform(fk, (v,), minval=tiny)),
          "sampler uniforms on the card == CPU")
    g = S.gumbel(fk, (v,)).double()
    err = (S.gumbel(fk_card, (v,)).cpu().double() - g).abs()
    ulp = torch.as_tensor(np.spacing(np.maximum(g.abs().numpy(), 1.0)
                                     .astype(np.float32))).double()
    ulps = float((err / ulp).max())
    check(ulps <= GUMBEL_ULPS, f"Gumbel noise on the card within "
          f"{GUMBEL_ULPS} ulp of max(|g|, 1) of the CPU's ({ulps:.2f})")
    logits = torch.randn(b, v, device="cuda") * 3
    state = S.SamplingState(
        torch.full((b,), 0.9, device="cuda"),
        torch.full((b,), 16, dtype=torch.int32, device="cuda"),
        keys[:b].cuda(), torch.full((b,), 5, device="cuda"))
    # its ~400 small launches take the host 3-5 ms a call to issue, and the
    # card's launch queue holds about a thousand: more than two calls queued
    # behind one sleep would stall the host until the sleep ends, and the
    # events would time its issue rate. So one call at a time behind a
    # 25 ms sleep, the median of 7
    ms = float(np.median([time_cuda(
        lambda: S.sample(logits, state, kmax=16), 1,
        sleep_cycles=25 * SLEEP_CYCLES_PER_CALL) for _ in range(7)]))
    host_ms = time_host(lambda: S.sample(logits, state, kmax=16), 20) * 1e3
    return dict(draws=64 * v, gumbel_ulps=ulps, ms=ms, host_ms=host_ms)


def phase_share(torch, np, model, params, cfg) -> dict:
    """The sharing path: SHARE_KW's engine over the pair and the two waves
    under tdx, every kernel count set to 0 just before it."""
    from repro_torch.core import SealingKey, TrustDomain
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.runtime import Engine, GenerationRequest, SamplingParams

    rng = np.random.default_rng(11)
    head = rng.integers(1, cfg.vocab_size, SHARE_HEAD).astype(np.int32)
    pair = rng.integers(1, cfg.vocab_size, SHARE_PAIR[0][0]).astype(np.int32)

    def prompt(n, shared):
        p = rng.integers(1, cfg.vocab_size, n).astype(np.int32)
        if shared:
            p[:SHARE_HEAD] = head
        return p
    specs = [(pair, *SHARE_PAIR[0][1:]), (pair.copy(), *SHARE_PAIR[0][1:])]
    specs += [(prompt(n, True), mnt, prio) for n, mnt, prio in SHARE_LOW]
    specs += [(prompt(SHARE_HIGH[0][0], True), *SHARE_HIGH[0][1:]),
              (prompt(SHARE_HIGH[1][0], False), *SHARE_HIGH[1][1:])]
    specs = [(p, mnt, prio, SAMPLE_SEED0 + i)
             for i, (p, mnt, prio) in enumerate(specs)]
    n_low = 2 + len(SHARE_LOW)

    def gen(spec):
        p, mnt, prio, seed = spec
        return GenerationRequest(
            prompt=p.copy(), max_new_tokens=mnt, priority=prio,
            share_prefix=seed != SAMPLE_SEED0 + SHARE_OPT_OUT,
            params=SamplingParams(temperature=0.9, top_k=16, seed=seed))

    def waves(kw, key):
        td = TrustDomain("tdx", sealing_key=SealingKey.generate(key),
                         io_key=SealingKey.generate(key + b"-io"))
        eng = Engine(model, params, trust_domain=td, **kw)
        reqs = [eng.submit(gen(s)) for s in specs[:n_low]]
        for _ in range(3):
            eng.step()
            check_pool_invariants(eng.kv)
        reqs += [eng.submit(gen(s)) for s in specs[n_low:]]
        steps = 0
        while not eng.idle and steps < 10_000:
            eng.step()
            steps += 1
            check_pool_invariants(eng.kv)
        return eng, reqs

    # ---- the sharing path: every kernel count starts at 0 here -----------
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(C, P, Q, FA)
    t0 = time.perf_counter()
    eng, reqs = waves(SHARE_KW, b"chip-smoke-3")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"chacha20_xor_blocked": C.launches, **P.launches,
                "flash_attention": FA.launches}
    peak = torch.cuda.max_memory_allocated()
    check(Q.launches == 0, "the sharing path runs no int8 kernel")
    check(FA.launches > 0, "the sharing path prefilled through B2")
    # ---- end of the sharing path ------------------------------------------
    kv, stats = eng.kv, eng.run()
    check(all(r.finished for r in reqs), "sharing: every request finished")
    outputs = [list(r.output) for r in reqs]
    for spec, out in zip(specs, outputs):
        check(len(out) == spec[1], f"sharing: request produced {spec[1]} "
              f"tokens")
        check(all(0 <= t < cfg.vocab_size for t in out),
              "sharing: tokens in vocab")
    check(stats.preemptions > 0, "sharing: the high wave forced a preemption")
    check(kv.shared_page_maps > 0, "sharing: pages were shared")
    check(kv.cow_copies > 0, "sharing: the partial page copied on write")
    check(kv.fused_restore_pages > 0,
          "sharing: a restore admitted pages as ciphertext")
    for name in ("chacha20_xor_blocked", "paged_attention",
                 "paged_attention_unseal"):
        check(launches[name] > 0, f"sharing: the path launched {name}")
    check_solo(Engine, TrustDomain, model, params, specs, gen, outputs,
               SHARE_KW)
    plain_eng, plain_reqs = waves(dict(SHARE_KW, prefix_sharing=False),
                                  b"chip-smoke-4")
    check(kv.pages_written < plain_eng.kv.pages_written,
          f"sharing writes fewer pages ({kv.pages_written}) than the same "
          f"waves unshared ({plain_eng.kv.pages_written})")
    ch, pch = eng.td.channel.stats, plain_eng.td.channel.stats
    out = dict(stats=stats, wall_s=wall_s, peak=peak, launches=launches,
               n=len(specs), tokens=[len(o) for o in outputs],
               shared=kv.shared_page_maps, cow=kv.cow_copies,
               written=kv.pages_written, fused=kv.fused_restore_pages,
               plain_written=plain_eng.kv.pages_written,
               seal_bytes=ch.seal_bytes, plain_seal_bytes=pch.seal_bytes,
               plain_same=sum(list(r.output) == o
                              for r, o in zip(plain_reqs, outputs)))
    del eng, plain_eng
    return out


def path_launches() -> dict:
    """Every kernel's count since the last reset_counts."""
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    return {"chacha20_xor_blocked": C.launches, **P.launches,
            "flash_attention": FA.launches, "qmatmul": Q.launches}


def phase_store(torch, np, model, params, cfg) -> dict:
    """The store path: STORE_KW's engine over two epochs of the recurring
    prompts under tdx, every kernel count set to 0 just before it; then the
    checks (warm hits, fewer pages, equal tokens, solo runs) and a tampered
    store entry failing a consumer's admission before any page moves."""
    from repro_torch.core import SealingKey, TrustDomain
    from repro_torch.core.sealing import IntegrityError
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.runtime import (Engine, GenerationRequest,
                                     SamplingParams, SealedPageStore,
                                     stats_from_requests)

    rng = np.random.default_rng(29)
    head = rng.integers(1, cfg.vocab_size, STORE_HEAD).astype(np.int32)

    def prompt(n):
        return np.concatenate([head, rng.integers(
            1, cfg.vocab_size, n - STORE_HEAD).astype(np.int32)])
    specs = [(prompt(n), mnt, prio) for n, mnt, prio in STORE_LOW + [STORE_HIGH]]
    specs = [(p, mnt, prio, STORE_SEED0 + i)
             for i, (p, mnt, prio) in enumerate(specs)]

    def gen(spec):
        p, mnt, prio, seed = spec
        return GenerationRequest(
            prompt=p.copy(), max_new_tokens=mnt, priority=prio,
            params=SamplingParams(temperature=0.8, top_k=32, seed=seed))

    def epoch(eng):
        reqs = [eng.submit(gen(s)) for s in specs[:len(STORE_LOW)]]
        steps = 0
        while not eng.idle and steps < 10_000:
            if steps == STORE_HIGH_AT:
                reqs.append(eng.submit(gen(specs[-1])))
            eng.step()
            steps += 1
            check_pool_invariants(eng.kv)
        check(all(r.finished for r in reqs), "store: every request finished")
        return reqs

    store = SealedPageStore(budget_pages=STORE_BUDGET, policy="cost",
                            profile="tdx")
    td = TrustDomain("tdx", sealing_key=SealingKey.generate(b"chip-store"),
                     io_key=SealingKey.generate(b"chip-store-io"))
    eng = Engine(model, params, trust_domain=td, page_store=store, **STORE_KW)
    # ---- the store path: every kernel count starts at 0 here -------------
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(C, P, Q, FA)
    runs = []
    for _ in range(2):
        written, hits = eng.kv.pages_written, eng.kv.store_hits
        restored = eng.kv.store_restored_bytes
        t0 = time.perf_counter()
        reqs = epoch(eng)
        torch.cuda.synchronize()
        runs.append(dict(wall_s=time.perf_counter() - t0,
                         stats=stats_from_requests(reqs),
                         outputs=[list(r.output) for r in reqs],
                         written=eng.kv.pages_written - written,
                         hits=eng.kv.store_hits - hits,
                         restored=eng.kv.store_restored_bytes - restored))
    launches = path_launches()
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the store path --------------------------------------------
    check(launches["qmatmul"] == 0, "the store path runs no int8 kernel")
    check(launches["flash_attention"] > 0,
          "the store path prefilled through B2")
    cold, warm = runs
    for spec, out in zip(specs, cold["outputs"]):
        check(len(out) == spec[1] and all(0 <= t < cfg.vocab_size
                                          for t in out),
              f"store: request produced {spec[1]} tokens in vocab")
    check(warm["outputs"] == cold["outputs"],
          "store: the warm epoch's tokens equal the cold epoch's")
    check(warm["hits"] > 0, f"store: the warm epoch hit the store "
          f"({warm['hits']} pages)")
    check(warm["written"] < cold["written"],
          f"store: the warm epoch wrote fewer pages ({warm['written']}) "
          f"than the cold one ({cold['written']})")
    check(cold["stats"].preemptions > 0 and eng.kv.fused_restore_pages > 0,
          "store: a preemption's restore admitted pages as ciphertext")
    for name in ("chacha20_xor_blocked", "paged_attention",
                 "paged_attention_unseal"):
        check(launches[name] > 0, f"store: the path launched {name}")
    solo_kw = dict(STORE_KW, page_store=True)
    check_solo(Engine, TrustDomain, model, params, specs, gen,
               cold["outputs"], solo_kw)

    # a tampered store entry (the head's first page): a consumer sharing
    # the store and the key fails its admission before a page or refcount
    # moves
    consumer = Engine(model, params, page_store=store, **STORE_KW,
                      trust_domain=TrustDomain(
                          "tdx", sealing_key=td.sealing_key,
                          io_key=SealingKey.generate(b"chip-store-io-2")))
    first = consumer.kv.page_keys(specs[0][0], STORE_KW["prefill_buckets"][0])
    entry = store._domains[td.sealing_key.key_id()][first[0]]
    blob = next(iter(entry.blobs.values()))
    blob.ciphertext[0, 0] ^= 1
    consumer.submit(gen(specs[0]))
    try:
        consumer.run(max_steps=100)
        failed = False
    except IntegrityError:
        failed = True
    blob.ciphertext[0, 0] ^= 1
    check(failed, "store: a tampered entry fails the consumer's admission")
    check(consumer.kv.free_physical_pages == consumer.kv.num_pages
          and consumer.kv.store_hits == 0,
          "store: the failed admission moved no page")
    out = dict(cold=cold, warm=warm, launches=launches, peak=peak,
               n=len(specs), publishes=store.publishes,
               evictions=store.evictions, resident=store.resident_pages,
               restored_pages=eng.kv.store_restored_pages,
               restored_bytes=eng.kv.store_restored_bytes,
               fused=eng.kv.fused_restore_pages,
               page_size=eng.kv.page_size)
    del eng, consumer
    return out


def phase_two_phase(torch, np, model, params, cfg) -> dict:
    """The two-phase path: the burst under each TWO_PHASE_MODES engine
    (tdx), every kernel count set to 0 just before each mode; then equal
    tokens within a backend and every request equal to its solo run."""
    from repro_torch.core import SealingKey, TrustDomain
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.runtime import (Engine, GenerationRequest,
                                     SamplingParams, stats_from_requests)

    rng = np.random.default_rng(31)
    longs = [rng.integers(1, cfg.vocab_size, 128).astype(np.int32)
             for _ in range(2)]
    shorts = [rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
              for _ in range(16)]
    # the reference bench's order: 4 shorts, the 2 longs, 12 shorts;
    # staggered short lengths; seeds as there
    specs = [(shorts[i], 6 + i % 8, 0, 100 + i) for i in range(4)]
    specs += [(p, 32, 0, i) for i, p in enumerate(longs)]
    specs += [(shorts[i], 6 + i % 8, 0, 100 + i) for i in range(4, 16)]
    high = (rng.integers(1, cfg.vocab_size, 16).astype(np.int32), 8, 5, 200)

    def gen(spec):
        p, mnt, prio, seed = spec
        return GenerationRequest(
            prompt=p.copy(), max_new_tokens=mnt, priority=prio,
            params=SamplingParams(temperature=0.8, top_k=32, seed=seed))

    results = {}
    for i, (label, extra) in enumerate(TWO_PHASE_MODES.items()):
        kw = dict(TWO_PHASE_KW, **extra)
        td = TrustDomain("tdx", sealing_key=SealingKey.generate(b"chip-2p"),
                         io_key=SealingKey.generate(b"chip-2p-io"))
        eng = Engine(model, params, trust_domain=td, **kw)
        # ---- this mode: every kernel count starts at 0 here --------------
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(C, P, Q, FA)
        t0 = time.perf_counter()
        reqs = [eng.submit(gen(s)) for s in specs]
        steps = expect_crossings = 0
        while not eng.idle and steps < 10_000:
            if steps == TWO_PHASE_HIGH_AT:
                reqs.append(eng.submit(gen(high)))
            expect_crossings += -(-len(eng._inflight) // eng._handoff_batch)
            eng.step()
            steps += 1
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = path_launches()
        peak = torch.cuda.max_memory_allocated()
        # ---- end of this mode ---------------------------------------------
        check(all(r.finished for r in reqs), f"{label}: every request "
              f"finished")
        check(launches["qmatmul"] == 0, f"{label}: no int8 kernel")
        check(launches["flash_attention"] > 0,
              f"{label}: prefilled through B2")
        stats = stats_from_requests(reqs)
        check(stats.preemptions > 0, f"{label}: the high request preempted")
        results[label] = dict(
            kw=kw, stats=stats, wall_s=wall_s, launches=launches, peak=peak,
            outputs=[list(r.output) for r in reqs],
            crossings=eng.handoff_crossings, expect_crossings=expect_crossings,
            backfills=eng.backfills, steps=steps,
            fused=getattr(eng.kv, "fused_restore_pages", 0),
            seal_bytes=td.channel.stats.seal_bytes)
        del eng
    slot_b, slot_cb, pk_b, pk_2p = results.values()
    check(slot_b["outputs"] == slot_cb["outputs"],
          "two-phase: continuous batching's tokens equal the slot baseline's")
    check(pk_b["outputs"] == pk_2p["outputs"],
          "two-phase: the two-plan mode's tokens equal the paged-kernel "
          "baseline's")
    check(pk_2p["stats"].handoffs == len(specs) + 1
          and pk_2p["stats"].handoff_bytes > 0,
          "two-phase: every request crossed the sealed handoff")
    check(pk_2p["crossings"] == pk_2p["expect_crossings"]
          and pk_2p["crossings"] < len(specs) + 1,
          f"two-phase: {pk_2p['crossings']} sealed crossings, as expected "
          f"from the prefills in flight at each step "
          f"({pk_2p['expect_crossings']}), some carrying two rows")
    for r in (pk_b, pk_2p):
        check(r["fused"] > 0 and r["launches"]["paged_attention_unseal"] > 0,
              "two-phase: the paged restore admitted ciphertext for B4")
        check(r["launches"]["paged_attention"] > 0,
              "two-phase: the paged modes launched B3")
    for r in results.values():
        check(r["launches"]["chacha20_xor_blocked"] > 0,
              "two-phase: every mode launched B1")
    all_specs = specs + [high]
    check_solo(Engine, TrustDomain, model, params, all_specs, gen,
               slot_b["outputs"], dict(TWO_PHASE_KW, kv_backend="slot"))
    check_solo(Engine, TrustDomain, model, params, all_specs, gen,
               pk_b["outputs"], dict(TWO_PHASE_KW,
                                     **TWO_PHASE_MODES["paged-kernel baseline"]))
    agree = sum(a == b for o, p in zip(slot_b["outputs"], pk_b["outputs"])
                for a, b in zip(o, p))
    return dict(modes=results, n=len(all_specs),
                tokens=sum(map(len, slot_b["outputs"])), agree=agree)


def phase_fleet(torch, np, model, params, cfg) -> dict:
    """The fleet path: each request alone on a one-slot engine, the fleet
    without a kill, a cross-tenant restore, then (every kernel count set to
    0 just before it) the fleet with the kill, the respawn and the drain;
    then the checks."""
    from repro_torch.core import TrustDomain
    from repro_torch.core.sealing import IntegrityError, sealed_nbytes
    from repro_torch.fleet import (DEAD, READY, EngineWorker, Gateway,
                                   Orchestrator)
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.runtime import (Engine, GenerationRequest,
                                     SamplingParams, stats_from_requests)

    rng = np.random.default_rng(29)
    specs = []
    for tenant in FLEET_TENANTS:
        head = rng.integers(1, cfg.vocab_size, FLEET_HEAD).astype(np.int32)
        for _ in range(FLEET_PER_TENANT):
            tail = rng.integers(1, cfg.vocab_size, FLEET_PROMPT - FLEET_HEAD)
            specs.append((np.concatenate([head, tail.astype(np.int32)]),
                          tenant, FLEET_SEED0 + len(specs)))

    def gen(spec):
        prompt, tenant, seed = spec
        return GenerationRequest(
            prompt=prompt.copy(), max_new_tokens=FLEET_NEW, tenant=tenant,
            params=SamplingParams(temperature=0.7, top_k=20, seed=seed))

    def worker(name):
        return EngineWorker(name, model, params, engine_kw=FLEET_KW)

    def fleet():
        workers = [worker(f"w{i}") for i in range(2)]
        gateway = Gateway(config_repr=cfg.name)
        for tenant in FLEET_TENANTS:
            gateway.register_tenant(tenant)
        return gateway, Orchestrator(gateway, workers,
                                     placement="tenant_affinity",
                                     worker_factory=worker), workers

    def pool_free(w):
        kv = w.engine.kv
        check(w.engine.slots.num_active == 0
              and kv.free_physical_pages == kv.num_pages,
              f"fleet: worker {w.name}'s pool is back to all pages free")
        check_pool_invariants(kv)

    solo = []
    for spec in specs:
        eng = Engine(model, params, trust_domain=TrustDomain("tdx"),
                     **dict(FLEET_KW, max_slots=1))
        solo.append(eng.generate(gen(spec)).tokens)
        del eng

    # the fleet without a kill (comparison only)
    _, orch, workers = fleet()
    t0 = time.perf_counter()
    handles = [orch.submit(gen(s)) for s in specs]
    orch.run()
    torch.cuda.synchronize()
    calm_s = time.perf_counter() - t0
    calm = [list(h.output) for h in handles]
    calm_stats = stats_from_requests(handles)
    check(calm == solo, "fleet: without a kill every request equals its "
          "solo run")
    check(orch.stats.migrations == 0, "fleet: no migration without a kill")
    for w in workers:
        pool_free(w)
    # a hospital migrant presented under the bank's domain fails MAC on the
    # other worker, which leaks nothing; under its own domain it finishes
    # with its solo tokens
    a, b = workers
    req = a.engine.submit(gen(specs[0]))
    for _ in range(2):
        a.engine.step()
    (m,), _ = a.export_state()
    try:
        b.engine.restore_slot(m.sealed, m.req, key=b.tenant_keys["bank"],
                              prefix=m.prefix)
        failed = False
    except IntegrityError:
        failed = True
    check(failed, "fleet: a migrant restored under the other tenant's "
          "domain fails MAC")
    pool_free(b)
    b.engine.import_sealed_state([m])
    b.engine.run()
    check(req.output == solo[0], "fleet: the same migrant under its own "
          "domain finishes with its solo tokens")
    pool_free(b)
    del orch, workers, a, b, m
    gc.collect()
    torch.cuda.empty_cache()

    seen = []
    real_import = Engine.import_sealed_state

    def spy(self, migrants, queued=()):
        seen.extend(migrants)
        return real_import(self, migrants, queued)

    # ---- the fleet path: every kernel count starts at 0 here -------------
    torch.cuda.reset_peak_memory_stats()
    reset_counts(C, P, Q, FA)
    Engine.import_sealed_state = spy
    try:
        gateway, orch, (w0, w1) = fleet()
        t0 = time.perf_counter()
        handles = [orch.submit(gen(s)) for s in specs]
        for _ in range(FLEET_KILL_AT):
            orch.step()
        victim = max(orch.ready_workers(), key=lambda w: w.load())
        survivor = w1 if victim is w0 else w0
        b4_0 = P.launches["paged_attention_unseal"]
        fused_0 = survivor.engine.kv.fused_restore_pages
        torch.cuda.synchronize()
        t_kill = time.perf_counter()
        orch.kill(victim.name)
        killed = [p.req for p in seen]
        seal_s = time.perf_counter() - t_kill
        lens = [len(r.output) for r in killed]
        steps = 0
        while not any(len(r.output) > n for r, n in zip(killed, lens)):
            check(steps < 10_000, "fleet: a migrant resumed")
            orch.step()
            steps += 1
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t_kill
        survivor_b4 = P.launches["paged_attention_unseal"] - b4_0
        survivor_fused = survivor.engine.kv.fused_restore_pages - fused_0
        respawned = orch.respawn(victim.name)
        orch.drain(survivor.name)
        orch.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        Engine.import_sealed_state = real_import
    launches = path_launches()
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the fleet path ---------------------------------------------
    outputs = [list(h.output) for h in handles]
    check(all(h.finished for h in handles), "fleet: every request finished")
    check(outputs == solo, "fleet: with the kill every request equals its "
          "solo run")
    check(outputs == calm, "fleet: with the kill every request equals the "
          "fleet run without it")
    fs = orch.stats
    check(fs.migrations > 0 and fs.migrations == len(seen),
          f"fleet: {fs.migrations} migrations, one per migrant imported")
    moved = sum(sealed_nbytes(p.sealed) for p in seen)
    check(fs.migrated_bytes == moved > 0
          and sum(h.migrated_bytes for h in handles) == moved,
          f"fleet: migrated bytes ({fs.migrated_bytes}) equal the sum of "
          f"the migrants' sealed bytes ({moved})")
    check((fs.kills, fs.drains, fs.respawns) == (1, 1, 1),
          "fleet: one kill, one drain, one respawn")
    check(victim.state == DEAD and survivor.state == DEAD
          and respawned.state == READY, "fleet: the worker states")
    check(survivor_fused > 0 and survivor_b4 > 0,
          f"fleet: the survivor restored {survivor_fused} migrated pages as "
          f"ciphertext and launched B4 on them ({survivor_b4} launches)")
    for name in ("chacha20_xor_blocked", "paged_attention",
                 "paged_attention_unseal"):
        check(launches[name] > 0, f"fleet: the path launched {name}")
    check(launches["qmatmul"] == 0, "the fleet path runs no int8 kernel")
    check(launches["flash_attention"] > 0,
          "the fleet path prefilled through B2")
    for w in (w0, w1, respawned):
        pool_free(w)
    shared = sum(w.engine.kv.shared_page_maps for w in (w0, w1, respawned))
    out = dict(n=len(specs), launches=launches, peak=peak, wall_s=wall_s,
               calm_s=calm_s, resume_s=resume_s, seal_s=seal_s,
               resume_steps=steps, stats=stats_from_requests(handles),
               calm_stats=calm_stats, fleet=fs, gateway=gateway.stats,
               channel=orch.channel_totals(), migrated=len(seen),
               moved=moved, survivor_b4=survivor_b4,
               survivor_fused=survivor_fused, shared=shared,
               victim=victim.name, survivor=survivor.name)
    del orch, w0, w1, respawned, survivor, victim, seen, killed
    return out


def rag_corpus() -> dict:
    """The corpus of tests/test_rag.py."""
    from repro_torch.data import synthetic_text
    docs = {f"d{i}": synthetic_text(i, 5) for i in range(15)}
    docs["needle"] = ("confidential enclave attestation protects llama "
                      "inference throughput inside trusted hardware")
    return docs


def same_ranking(got, ref, tol, what) -> None:
    """``got`` ranks ``ref``'s documents with scores within ``tol`` and in
    the same order up to near ties (reference scores within 2 x tol)."""
    want = dict(ref)
    check(sorted(d for d, _ in got) == sorted(want),
          f"{what}: the same documents")
    check(all(abs(s - want[d]) <= tol for d, s in got),
          f"{what}: scores within {tol}")
    order = [d for d, _ in got]
    check(all(want[x] >= want[y] - 2 * tol for x, y in zip(order, order[1:])),
          f"{what}: the same ranking up to near ties")


def phase_rag(torch, np, model, params, cfg) -> dict:
    """The RAG path: RAGPipeline(bm25+rerank) over the paged-kernel engine,
    every kernel count set to 0 just before it; then the encoder card vs
    CPU and each answer against engine.generate on the trimmed prompt on
    the same engine. That last check shows determinism only (the same
    kernel on the same input); B3's correctness at this engine's 9-page
    table is checked against its plain walk in PAGED_CASES."""
    from repro_torch.core import TrustDomain
    from repro_torch.core.sealing import tree_map
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.rag import DenseRetriever, RAGPipeline
    from repro_torch.runtime import Engine, GenerationRequest

    docs = rag_corpus()
    engine = Engine(model, params, trust_domain=TrustDomain("tdx"), **RAG_KW)
    # ---- the RAG path: every kernel count starts at 0 here ---------------
    reset_counts(C, P, Q, FA)
    t0 = time.perf_counter()
    rag = RAGPipeline(docs, mode="bm25+rerank", engine=engine)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    results = [rag.query(q, top_k=RAG_TOP_K, max_new_tokens=RAG_NEW)
               for q in RAG_QUERIES]
    torch.cuda.synchronize()
    launches = path_launches()
    # ---- end of the RAG path -----------------------------------------------
    for name in ("chacha20_xor_blocked", "paged_attention"):
        check(launches[name] > 0, f"rag: the path launched {name}")
    check(launches["qmatmul"] == 0, "the RAG path runs no int8 kernel")
    check(launches["flash_attention"] > 0,
          "the RAG path prefilled through B2")
    cpu = DenseRetriever(device="cpu")
    cpu.params = tree_map(lambda t: t.cpu(), rag.dense.params)
    cpu.build(docs)
    emb_err = float((rag.dense.embeddings.cpu() - cpu.embeddings).abs().max())
    check(emb_err <= RAG_EMB_TOL, f"rag: encoder embeddings card vs CPU "
          f"within {RAG_EMB_TOL} ({emb_err:.3g})")
    for q in RAG_QUERIES:
        same_ranking(rag.dense.search(q, len(docs)), cpu.search(q, len(docs)),
                     RAG_EMB_TOL, f"rag: the card's ranking for {q!r}")
    for q, r in zip(RAG_QUERIES, results):
        check(len(r.retrieved) == RAG_TOP_K and len(r.answer_tokens) ==
              RAG_NEW and all(0 <= t < cfg.vocab_size
                              for t in r.answer_tokens),
              f"rag: {RAG_TOP_K} hits and {RAG_NEW} answer tokens")
        prompt = rag.prompt_for(q, r.retrieved, RAG_NEW)
        again = engine.generate(GenerationRequest(prompt=prompt,
                                                  max_new_tokens=RAG_NEW))
        check(again.tokens == r.answer_tokens, "rag: determinism: the "
              "answer equals engine.generate on the same trimmed prompt")
    out = dict(launches=launches, build_s=build_s, emb_err=emb_err,
               retrieval_ms=[r.retrieval_s * 1e3 for r in results],
               generation_ms=[r.generation_s * 1e3 for r in results],
               hits=[[d for d, _ in r.retrieved] for r in results],
               prompt_len=[len(rag.prompt_for(q, r.retrieved, RAG_NEW))
                           for q, r in zip(RAG_QUERIES, results)])
    del rag, engine, cpu
    return out


# the mesh path: Llama2-7B on a dp=2 mesh of logical shards on the card
# (ShardedPlan: the weights at rest in two chunks a leaf, gathered before
# every decode step and prefill call), 2 slots so each shard holds one, the
# slot path's waves, first on the slot backend and then on the paged
# backend with gather decode (a mesh runs no kernel decode, as in the
# reference). Tokens must equal the single-device engine's on the same
# backend and waves, and each request's solo run on the same mesh engine.
MESH = "dp=2"
MESH_BACKENDS = {"slot": ENGINE_KW,
                 "paged-gather": dict(PAGED_KW, kv_decode="gather")}


def mesh_serve(Engine, TrustDomain, model, params, specs, gen, kw, mesh):
    """The waves on one engine (a mesh engine when ``mesh``), recording in
    order each whole-slot seal ("seal", rid, sealed names) and restore
    ("restore", rid, slot) and counting decode steps. Returns (engine,
    requests, stats, wall seconds, events, decode steps)."""
    import torch
    eng = Engine(model, params, trust_domain=TrustDomain("tdx"), mesh=mesh,
                 **kw)
    events, steps = [], [0]
    seal_slot, restore_slot, decode = (eng.seal_slot, eng.restore_slot,
                                       eng.kv.decode)

    def sealing(slot, **k):
        sealed, req = seal_slot(slot, **k)
        events.append(("seal", req.rid, sorted(sealed)))
        return sealed, req

    def restoring(sealed, req, **k):
        slot = restore_slot(sealed, req, **k)
        events.append(("restore", req.rid, slot))
        return slot

    def decoding(*a, **k):
        steps[0] += 1
        return decode(*a, **k)

    eng.seal_slot, eng.restore_slot, eng.kv.decode = (sealing, restoring,
                                                      decoding)
    t0 = time.perf_counter()
    reqs, stats = serve_waves(eng, specs, gen)
    torch.cuda.synchronize()
    return eng, reqs, stats, time.perf_counter() - t0, events, steps[0]


def phase_mesh(torch, np, model, params, specs, gen, slot_outputs) -> dict:
    """The mesh path on each of MESH_BACKENDS, every kernel count set to 0
    just before each engine is built. A warm single-device run on the same
    backend just before it gives the times to compare with, and the
    paged-gather backend's tokens (the slot backend's are the slot path's,
    ``slot_outputs``)."""
    from repro_torch.core import TrustDomain
    from repro_torch.core.overheads import measured_link_tax
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.runtime import Engine, ShardedKVBackend

    # half of every weight but the norms: what a dp=2 gather moves into
    # one shard
    expect_b = sum(t.numel() * t.element_size()
                   for name, t in tree_leaves_with_names(params)
                   if not name.endswith("['scale']")) // 2
    out = {}
    for label, kw in MESH_BACKENDS.items():
        eng, reqs, stats, wall, *_ = mesh_serve(
            Engine, TrustDomain, model, params, specs, gen, kw, None)
        single = dict(outputs=[list(r.output) for r in reqs], stats=stats,
                      wall_s=wall)
        del eng
        if label == "slot":
            check(single["outputs"] == slot_outputs, "mesh path: the warm "
                  "single-device slot run repeats the slot path's tokens")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # ---- the mesh path on this backend: counts start at 0 here -------
        reset_counts(C, P, Q, FA)
        eng, reqs, stats, wall, events, steps = mesh_serve(
            Engine, TrustDomain, model, params, specs, gen, kw, MESH)
        launches = path_launches()
        peak = torch.cuda.max_memory_allocated()
        # ---- end of the mesh path ------------------------------------------
        want = slot_outputs if label == "slot" else single["outputs"]
        outputs = [list(r.output) for r in reqs]
        check(isinstance(eng.kv, ShardedKVBackend) and eng.plan.dp == 2,
              f"mesh {label}: the engine spans a dp=2 plan")
        check(all(r.finished for r in reqs) and stats.preemptions > 0,
              f"mesh {label}: every request finished, after a preemption")
        check(outputs == want, f"mesh {label}: tokens bit-equal to the "
              f"single-device engine's ({outputs} vs {want})")
        check(launches["chacha20_xor_blocked"] > 0,
              f"mesh {label}: B1 ran under the seals and unseals")
        check(launches["flash_attention"] > 0 and sum(launches.values())
              == launches["chacha20_xor_blocked"] + launches["flash_attention"],
              f"mesh {label}: no kernel but B1 and the prefills' B2 ran "
              f"({launches})")
        names = [n for kind, _, ns in events if kind == "seal" for n in ns]
        check(names and all(n.startswith("kvslot/")
                            and n.endswith(("/s0", "/s1")) for n in names),
              f"mesh {label}: every sealed kvslot/ name ends in /s0 or /s1")
        # 2 slots over dp=2: slot i is shard i
        sealed_on, crossed = {}, []
        for kind, rid, what in events:
            if kind == "seal":
                sealed_on[rid] = what[0][-3:]
            elif sealed_on[rid] != f"/s{what}":
                crossed.append(rid)
        check(bool(crossed), f"mesh {label}: a victim was restored onto the "
              f"other shard from the one it was sealed on ({events})")
        ch = eng.td.channel.stats
        per_step = ch.collective_bytes // max(ch.collective_steps, 1)
        check(ch.collective_steps == steps,
              f"mesh {label}: collective_steps {ch.collective_steps} == "
              f"{steps} decode steps")
        check(per_step == eng.plan.collective_bytes_per_step == expect_b
              and ch.collective_bytes == steps * expect_b,
              f"mesh {label}: {per_step} collective B/step == half the "
              f"non-norm weights ({expect_b} B)")
        check(ch.collective_s > 0, f"mesh {label}: collective_s measured")
        moved = eng.params.sharded_bytes
        _, _, link_line = measured_link_tax(ch, "tdx",
                                            stats.mean_latency_s or 1e-3)
        # solo runs on the same mesh engine (comparison only)
        for i, spec in enumerate(specs):
            r = eng.submit(gen(spec))
            eng.run(max_steps=10_000)
            check(list(r.output) == want[i], f"mesh {label}: request {i} "
                  f"equals its solo run on the mesh engine")
        out[label] = dict(stats=stats, wall_s=wall, launches=launches,
                          peak=peak, steps=steps, per_step=per_step,
                          gather_ms=ch.collective_s_per_step * 1e3,
                          moved=moved,
                          gather_bound_ms=2 * moved / HBM_BYTES_PER_S * 1e3,
                          link=link_line,
                          seals=sum(k == "seal" for k, _, _ in events),
                          crossed=len(crossed), describe=eng.plan.describe(),
                          single=single)
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the TP path: the same weights on a tp=2 mesh of logical shards on the card
# (ShardedPlan + the dense TensorParallel compute: each shard holds views of
# its 16 query and 16 KV heads and its 5,504-wide d_ff block, and every
# layer's attention and FFN partials are all-reduced -- an all-gather and a
# sum in rank order), the slot path's waves on the slot backend and on the
# paged backend with gather decode. Sealing keys from TP_KEY, so the ranks
# path can hold its blobs to this run's.
TP_MESH = "tp=2"
TP_KEY = b"chip-smoke-tp"
# one decode step's logits, tp=2 vs one device, bf16 Llama2-7B: each of the
# 65 reductions rounds two bf16 partials and their bf16 sum where one device
# rounds one product, so each residual add moves by up to about 2 x 2^-9 of
# the residual's scale; over 64 adds a random walk gives about
# sqrt(64) x 2 x 2^-9 = 3 % -- under the 5 % of max |logit| that the
# paged-kernel check allows for the same kind of bf16 drift
TP_LOGITS_REL_TOL = 0.05
# the ranks path: 2 processes on the one card (gloo through host memory,
# file:// rendezvous under build/), each holding its tp=2 half of the
# weights; then dp=2 over the same 2 ranks on Llama2-7B cut to 2 of 32
# layers (every rank gathers the other half of the 1.07 GB of sharded
# leaves through the host each step), 4 slots so a data shard steps 2 rows
RANKS = 2
RANKS_DP_LAYERS = 2
RANKS_DP_KW = dict(ENGINE_KW, max_slots=4)
RANKS_TIMEOUT_S = 600


def tp_step_bytes(cfg, rows: int, tp: int) -> int:
    """What one tp decode step's collectives move into a shard (dp=1),
    written down before the run from the model's layer slots: every mixer
    (attn, mla, mamba, rwkv) and every FFN (swiglu, moe, cmix) reduces one
    [rows, 1, d_model] partial in the model's dtype -- an all-gather of the
    other shards' partials; attention whose KV heads do not divide tp
    (sequence parallelism) also gathers the query heads and each shard's
    f32 (o, max, sum). A Mamba mixer also reduces its f32 [rows, 1,
    2 d_state + dt_rank] ``bcdt`` partials; rwkv6's time mix gathers its
    heads' [rows, 1, d_model / tp] outputs in the model's dtype for
    ``ln_out``, its channel mix the f32 receptance blocks of the same
    width (``vv`` is the FFN's reduction); ``ln0`` is replicated and moves
    nothing. A MoE layer routes on every shard (its router is replicated)
    and MLA's latent is computed on every shard, so neither moves more.
    When tp divides the vocabulary the embedding reduces one more partial
    and the f32 logits are gathered along it."""
    from repro_torch.models.transformer import _blocks, _mamba_cfg
    d, vocab, el = cfg.d_model, cfg.vocab_size, cfg.torch_dtype.itemsize
    part = (tp - 1) * rows * d * el
    block = (tp - 1) * rows * (d // tp)
    total = 0
    for _, n, slots in _blocks(cfg):
        for mixer, ffn in slots:
            layer = 2 * part
            if mixer == "attn" and cfg.num_kv_heads % tp:
                h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
                layer += ((tp - 1) * rows * (h // tp) * hd * el
                          + (tp - 1) * rows * h * (hd + 2) * 4)
            if mixer == "mamba":
                m = _mamba_cfg(cfg)
                layer += (tp - 1) * rows * (2 * m.d_state + m.dt_rank_) * 4
            if mixer == "rwkv":
                layer += block * el
            if ffn == "cmix":
                layer += block * 4
            total += n * layer
    if vocab % tp == 0:
        total += part + (tp - 1) * rows * (vocab // tp) * 4
    return total


def record_seals(eng) -> list:
    """Wrap the engine's KV seals (whole and, on the paged backend, tail
    pages): each seal's {name: sha256 of its ciphertext and MAC}, in order
    (the bit-for-bit blob check keeps these)."""
    import hashlib
    seals = []
    for meth in ("seal", "seal_tail_pages"):
        inner = getattr(eng.kv, meth, None)
        if inner is None:
            continue

        def recording(*a, _inner=inner, **k):
            out = _inner(*a, **k)
            seals.append({n: hashlib.sha256(
                st.ciphertext.cpu().numpy().tobytes() + st.mac).hexdigest()
                for n, st in out.items()})
            return out

        setattr(eng.kv, meth, recording)
    return seals


def tp_keys():
    from repro_torch.core import SealingKey
    return dict(sealing_key=SealingKey.generate(TP_KEY),
                io_key=SealingKey.generate(TP_KEY + b"-io"))


def step_logits(torch, Engine, model, params, mesh, prompts, toks):
    """One decode step's logits through a 2-slot engine's plan, both rows
    prefilled (comparison only)."""
    eng = Engine(model, params, mesh=mesh, **ENGINE_KW)
    cache = eng.kv.fresh_prefill_cache(prompts.shape[0])
    with torch.inference_mode():
        _, cache = eng.plan.compile_prefill()(eng.params, prompts, cache)
        compute = eng.plan.gather(eng.params) if mesh else eng.params
        logits, _ = eng.plan.decode_step(compute, toks, cache)
    return logits


def phase_tp(torch, np, model, params, specs, gen, mesh_out) -> dict:
    """The TP path on each of MESH_BACKENDS, every kernel count set to 0
    just before each engine is built. The warm single-device run on the
    same backend is the mesh path's (just before it, in this call)."""
    from repro_torch.core import TrustDomain
    from repro_torch.core.overheads import measured_link_tax
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.runtime import Engine

    cfg = model.cfg
    expect_b = tp_step_bytes(cfg, ENGINE_KW["max_slots"], 2)
    out = {}
    for label, kw in MESH_BACKENDS.items():
        single = mesh_out[label]["single"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # ---- the TP path on this backend: counts start at 0 here ---------
        reset_counts(C, P, Q, FA)
        td = TrustDomain("tdx", **tp_keys())
        eng = Engine(model, params, trust_domain=td, mesh=TP_MESH, **kw)
        seals = record_seals(eng)
        t0 = time.perf_counter()
        reqs, stats = serve_waves(eng, specs, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = path_launches()
        peak = torch.cuda.max_memory_allocated()
        # ---- end of the TP path ----------------------------------------------
        outputs = [list(r.output) for r in reqs]
        check(eng.plan.tensor_parallel is not None and eng.plan.tp == 2,
              f"tp {label}: the engine spans a tp=2 plan")
        check(all(r.finished for r in reqs) and stats.preemptions > 0,
              f"tp {label}: every request finished, after a preemption")
        check(launches["chacha20_xor_blocked"] > 0,
              f"tp {label}: B1 ran under the seals and unseals")
        check(launches["flash_attention"] > 0 and sum(launches.values())
              == launches["chacha20_xor_blocked"] + launches["flash_attention"],
              f"tp {label}: no kernel but B1 and the prefills' B2 ran "
              f"({launches})")
        names = [n for s_ in seals for n in s_]
        check(names and all(n.endswith("/s0") for n in names),
              f"tp {label}: every sealed name ends in /s0")
        ch = td.channel.stats
        steps = ch.collective_steps
        per_step = ch.collective_bytes // max(steps, 1)
        check(per_step == eng.plan.collective_bytes_per_step == expect_b
              and ch.collective_bytes == steps * expect_b,
              f"tp {label}: {per_step} collective B/step == the formula's "
              f"{expect_b} B")
        check(ch.collective_s > 0, f"tp {label}: collective_s measured")
        coll_ms = ch.collective_s / max(steps, 1) * 1e3  # before the solos
        _, _, link = measured_link_tax(
            ch, "tdx", stats.mean_latency_s or 1e-3,
            measures=eng.plan.collective_measures)
        agree = sum(a == b for o, p in zip(outputs, single["outputs"])
                    for a, b in zip(o, p))
        for i, spec in enumerate(specs):
            r = eng.submit(gen(spec))
            eng.run(max_steps=10_000)
            check(list(r.output) == outputs[i], f"tp {label}: request {i} "
                  f"equals its solo run on the tp=2 engine")
        out[label] = dict(stats=stats, wall_s=wall, launches=launches,
                          peak=peak, steps=steps, per_step=per_step,
                          expect_b=expect_b, outputs=outputs, seals=seals,
                          coll_ms=coll_ms, link=link, agree=agree,
                          tokens=sum(map(len, outputs)),
                          describe=eng.plan.describe(), single=single)
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    prompts = torch.as_tensor(np.stack([specs[0][0][:20], specs[1][0][:20]]),
                              device="cuda")
    toks = torch.tensor([[5], [9]], dtype=torch.int32, device="cuda")
    ref = step_logits(torch, Engine, model, params, None, prompts, toks)
    got = step_logits(torch, Engine, model, params, TP_MESH, prompts, toks)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(bool(torch.isfinite(got).all()), "tp logits finite")
    check(err <= TP_LOGITS_REL_TOL * scale,
          f"tp=2 logits within {TP_LOGITS_REL_TOL} x max |logit| of one "
          f"device's ({err:.4g} vs max {scale:.4g})")
    out["logits"] = dict(err=err, scale=scale, argmax=bool(torch.equal(
        got.argmax(-1), ref.argmax(-1))))
    out["fingerprints"] = {n: fingerprint(torch, t)
                           for n, t in tree_leaves_with_names(params)}
    return out


def rank_worker(rank, world, init_file, device, cfg_name, smoke, specs,
                fps, out_dir):
    """One rank of the ranks path (spawned): join the gloo world; build the
    weights from seed 0 in turn (rank 0, then rank 1: the card holds at
    most one whole copy beside the halves), check their fingerprints
    against the parent's and keep this rank's tp=2 half; serve the slot
    path's waves on a tp=2 engine spanning the ranks; then a dp=2 engine
    on the depth cut. Saves what it saw under ``out_dir``."""
    import dataclasses
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=RANKS_TIMEOUT_S))
    try:
        from repro_torch.configs import get_config, smoke_config
        from repro_torch.core import SealingKey, TrustDomain
        from repro_torch.core.sealing import tree_leaves_with_names
        from repro_torch.kernels import chacha20 as C
        from repro_torch.models import build_model
        from repro_torch.runtime import Engine, ShardedPlan, kvcache

        cfg = (smoke_config if smoke else get_config)(cfg_name)
        model = build_model(cfg, device=device)
        plan = ShardedPlan(model, tp=world)
        weights = None
        for turn in range(world):
            if turn == rank:
                params = model.init_params(seed=0)
                got = {n: fingerprint(torch, t)
                       for n, t in tree_leaves_with_names(params)}
                check(got == fps, f"rank {rank}: its seed-0 weights' "
                      f"fingerprints equal the parent's")
                weights = plan.place_params(params)
                del params
                gc.collect()
                if device == "cuda":
                    torch.cuda.empty_cache()
            dist.barrier()
        own = []
        seal_tensor = kvcache.seal_tensor

        def sealing(key, name, array, **kw):
            own.append(name)
            return seal_tensor(key, name, array, **kw)

        kvcache.seal_tensor = sealing

        def gen(spec):
            from repro_torch.runtime import GenerationRequest
            prompt, mnt, prio = spec
            return GenerationRequest(prompt=prompt.copy(), max_new_tokens=mnt,
                                     priority=prio)

        def run(eng, td):
            seals = record_seals(eng)
            t0 = time.perf_counter()
            reqs, stats = serve_waves(eng, specs, gen)
            if device == "cuda":
                torch.cuda.synchronize()
            ch = td.channel.stats
            return dict(tokens=[list(r.output) for r in reqs], seals=seals,
                        wall_s=time.perf_counter() - t0,
                        p50=stats.p50_latency_s, ttft=stats.p50_ttft_s,
                        preemptions=stats.preemptions,
                        frames=ch.messages_out, steps=ch.collective_steps,
                        per_step=ch.collective_bytes // max(
                            ch.collective_steps, 1),
                        coll_ms=ch.collective_s / max(ch.collective_steps, 1)
                        * 1e3, describe=eng.plan.describe(),
                        measures=eng.plan.collective_measures)

        C.reset_launches()
        td = TrustDomain("tdx", device=device, **tp_keys())
        eng = Engine(model, weights, plan=plan, trust_domain=td,
                     device=device, **ENGINE_KW)
        del weights
        result = {"tp": run(eng, td)}
        result["tp"].update(own=list(own), launches=C.launches,
                            peak=(torch.cuda.max_memory_allocated()
                                  if device == "cuda" else 0))
        del eng, plan
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        cut = build_model(dataclasses.replace(cfg, num_layers=RANKS_DP_LAYERS),
                          device=device)
        td = TrustDomain("tdx", device=device, **tp_keys())
        own.clear()
        eng = Engine(cut, cut.init_params(seed=0), mesh=f"dp={world}",
                     trust_domain=td, device=device, **RANKS_DP_KW)
        result["dp"] = run(eng, td)
        result["dp"]["own"] = list(own)
        torch.save(result, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_reference(torch, Engine, cfg, specs, gen, device) -> list:
    """The dp case's tokens on a logical dp=2 mesh of the same cut, in this
    process (comparison only)."""
    import dataclasses
    from repro_torch.core import TrustDomain
    from repro_torch.models import build_model
    cut = build_model(dataclasses.replace(cfg, num_layers=RANKS_DP_LAYERS),
                      device=device)
    eng = Engine(cut, cut.init_params(seed=0), mesh=f"dp={RANKS}",
                 trust_domain=TrustDomain("tdx", device=device, **tp_keys()),
                 device=device, **RANKS_DP_KW)
    reqs, _ = serve_waves(eng, specs, gen)
    return [list(r.output) for r in reqs]


def phase_ranks(torch, np, cfg_name, specs, tp_out, device="cuda",
                smoke=False) -> dict:
    """The ranks path: RANKS spawned processes on the one card, after the
    parent has freed its weights. Tokens, sealed names and blob bytes of
    the tp=2 run equal the TP path's logical-shard run (slot backend) bit
    for bit, each name sealed by one rank, frames from rank 0 alone; the
    dp=2 run's tokens equal the logical dp=2 run of the same cut."""
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.runtime import Engine, GenerationRequest

    def gen(spec):
        prompt, mnt, prio = spec
        return GenerationRequest(prompt=prompt.copy(), max_new_tokens=mnt,
                                 priority=prio)

    cfg = (smoke_config if smoke else get_config)(cfg_name)
    dp_want = dp_reference(torch, Engine, cfg, specs, gen, device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    work = Path(__file__).resolve().parent / "build" / "ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    outs = [work / f"rank{r}.pt" for r in range(RANKS)]
    t0 = time.perf_counter()
    mp.spawn(rank_worker, nprocs=RANKS, join=True, args=(
        RANKS, str(work / "init"), device, cfg_name, smoke, specs,
        tp_out["fingerprints"], str(work)))
    wall = time.perf_counter() - t0
    ranks = [torch.load(f, weights_only=False) for f in outs]
    want = tp_out["slot"]
    names = sorted(n for s_ in want["seals"] for n in s_)
    for r, got in enumerate(ranks):
        tp = got["tp"]
        check(tp["tokens"] == want["outputs"], f"ranks tp=2: rank {r}'s "
              f"tokens equal the logical tp=2 run's")
        check(tp["seals"] == want["seals"], f"ranks tp=2: rank {r}'s sealed "
              f"names and blob bytes equal the logical tp=2 run's")
        check(tp["preemptions"] > 0, "ranks tp=2: a preemption")
        check(got["dp"]["tokens"] == dp_want, f"ranks dp=2: rank {r}'s "
              f"tokens equal the logical dp=2 run of the cut")
    sealed_by = sorted(n for got in ranks for n in got["tp"]["own"])
    check(sealed_by == names, "ranks tp=2: every name sealed by exactly one "
          "rank")
    check(not ranks[1]["tp"]["own"], "ranks tp=2: rank 1 sealed nothing")
    check(ranks[0]["tp"]["frames"] > 0 and ranks[1]["tp"]["frames"] == 0,
          "ranks: rank 0 alone sent egress frames")
    launches = sum(got["tp"]["launches"] for got in ranks)
    check(launches > 0, "ranks tp=2: B1 ran under the seals and unseals")
    shutil.rmtree(work, ignore_errors=True)
    return dict(ranks=ranks, wall_s=wall, launches=launches, seals=len(names))


# the paged ranks path: the paged backend with gather decode over the same
# 2 gloo ranks on the card, tp=2 (each rank holds its KV heads of every
# page), on the slot path's preempting waves, so per-page seals and their
# restores run through B1 over ranks: Llama2-70B at published width (d_model
# 8192, GQA 64/8, d_ff 28672; the paper's largest model) cut to 2 of 80
# layers, then dbrx-132b's 1-layer cut (8 of its 16 experts a rank), then
# jamba-v0.1-52b's group of 8 (4,096 of 8,192 Mamba channels and 8 of 16
# experts a rank; each rank's channels of every row slot-dense beside its
# KV heads of every page) on its 11-page pool, where a row's tail is
# evicted and the row pauses. Each against a logical tp=2 run of the same
# seed-0 weights in the parent, freed before the ranks spawn; a rank builds
# the whole seed-0 tree once, in turn, and keeps its slice.
PAGED_RANKS_KW = dict(PAGED_KW, kv_decode="gather")
# jamba's pool and waves (the families path's too): 11 pages of 16
# positions, four lows and one high, so the low that loses its tail page
# sits out the high request's steps
JAMBA_PAGES = 11
FAMILY_WAVE = [(20, 16, 0), (24, 16, 0), (100, 16, 0), (40, 16, 0)]
FAMILY_HIGH = (100, 8, 5)
# (name, depth cut, engine kwargs, waves: the lows, then the highs)
PAGED_RANKS = [("llama2-70b", dict(num_layers=2), PAGED_RANKS_KW,
                LOW_WAVE + HIGH_WAVE),
               ("dbrx-132b", dict(num_layers=1), PAGED_RANKS_KW,
                LOW_WAVE + HIGH_WAVE),
               ("jamba-v0.1-52b", dict(num_layers=8),
                dict(PAGED_RANKS_KW, num_pages=JAMBA_PAGES),
                FAMILY_WAVE + [FAMILY_HIGH])]


def serve_waves_tables(engine, specs, gen):
    """serve_waves, stepping by hand to keep every step's page table. On a
    model with recurrent state (slot-dense leaves) the lower-rid running
    low loses its tail page as the high wave arrives, as family_waves
    does, and pauses; for each step a row sat out paused, whether its
    recurrent-state rows (this process's block of them) came out
    bit-equal is kept (``engine.frozen``: one bool a paused row a
    step)."""
    tables = []
    engine.frozen = []

    def step():
        import torch
        dense = engine.kv._dense
        paused = sorted(engine._paused) if dense else []
        before = {s: {k: v[:, s].clone() for k, v in dense.items()}
                  for s in paused}
        engine.step()
        tables.append(engine.kv.table.copy())
        engine.frozen += [all(torch.equal(v[:, s], before[s][k])
                              for k, v in dense.items())
                          for s in paused if s in engine._paused]

    reqs = [engine.submit(gen(s)) for s in specs[:len(LOW_WAVE)]]
    for _ in range(3):
        step()
    reqs += [engine.submit(gen(s)) for s in specs[len(LOW_WAVE):]]
    if engine.kv._dense:
        running = engine.scheduler.running
        engine.partial_preempt(min(running, key=lambda s: running[s].rid), 1)
    while not engine.idle:
        step()
    return reqs, engine.run(max_steps=10_000), tables


def paged_ranks_config(name, cut, smoke):
    from repro_torch.configs import smoke_config
    return smoke_config(name) if smoke else family_config(name, cut)


def paged_run_record(torch, eng, td, specs, gen, device) -> dict:
    """The waves on a paged engine: tokens, every seal's hashes, every
    step's page table, timings and the collective counters."""
    seals = record_seals(eng)
    t0 = time.perf_counter()
    reqs, stats, tables = serve_waves_tables(eng, specs, gen)
    if device == "cuda":
        torch.cuda.synchronize()
    ch = td.channel.stats
    steps = max(ch.collective_steps, 1)
    return dict(tokens=[list(r.output) for r in reqs], seals=seals,
                tables=tables, wall_s=time.perf_counter() - t0,
                finished=all(r.finished for r in reqs),
                p50=stats.p50_latency_s, preemptions=stats.preemptions,
                seal_events=ch.seal_events, restore_events=ch.restore_events,
                frames=ch.messages_out, steps=ch.collective_steps,
                frozen=list(eng.frozen),
                per_step=ch.collective_bytes // steps,
                coll_ms=ch.collective_s / steps * 1e3,
                describe=eng.plan.describe())


def paged_rank_worker(rank, world, init_file, device, runs, smoke, out_dir):
    """One rank of the paged ranks path (spawned): join the gloo world;
    for each run build the seed-0 weights in turn (fingerprints checked
    against the parent's), keep this rank's tp=2 half, and serve the waves
    on a paged tp=2 engine spanning the ranks, recording which names this
    rank sealed itself and its B1 launches."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=RANKS_TIMEOUT_S))
    try:
        from repro_torch.core import TrustDomain
        from repro_torch.core.sealing import tree_leaves_with_names
        from repro_torch.kernels import chacha20 as C
        from repro_torch.models import build_model
        from repro_torch.runtime import (Engine, GenerationRequest,
                                         ShardedPlan, kvcache)

        own = []
        seal_tensor = kvcache.seal_tensor

        def sealing(key, name, array, **kw):
            own.append(name)
            return seal_tensor(key, name, array, **kw)

        kvcache.seal_tensor = sealing

        def gen(spec):
            prompt, mnt, prio = spec
            return GenerationRequest(prompt=prompt.copy(), max_new_tokens=mnt,
                                     priority=prio)

        result = {}
        for name, cut, kw, specs, fps in runs:
            model = build_model(paged_ranks_config(name, cut, smoke),
                                device=device)
            plan = ShardedPlan(model, tp=world)
            weights = None
            build_peak = held = 0
            for turn in range(world):
                if turn == rank:
                    if device == "cuda":
                        torch.cuda.reset_peak_memory_stats()
                    params = model.init_params(seed=0)
                    got = {n: fingerprint(torch, t)
                           for n, t in tree_leaves_with_names(params)}
                    check(got == fps, f"rank {rank}: {name}'s seed-0 "
                          f"weights' fingerprints equal the parent's")
                    weights = plan.place_params(params)
                    del params
                    gc.collect()
                    if device == "cuda":
                        torch.cuda.empty_cache()
                        build_peak = torch.cuda.max_memory_allocated()
                        held = torch.cuda.memory_allocated()
                dist.barrier()
            own.clear()
            C.reset_launches()
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            td = TrustDomain("tdx", device=device, **tp_keys())
            eng = Engine(model, weights, plan=plan, trust_domain=td,
                         device=device, **kw)
            del weights
            result[name] = paged_run_record(torch, eng, td, specs, gen,
                                            device)
            result[name].update(
                own=list(own), launches=C.launches, build_peak=build_peak,
                held=held,
                peak=(torch.cuda.max_memory_allocated()
                      if device == "cuda" else 0))
            del eng, plan, model
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        torch.save(result, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_paged_ranks(torch, np, device="cuda", smoke=False) -> dict:
    """The paged ranks path (PAGED_RANKS): for each model a logical tp=2
    paged-gather run in this process (every kernel count set to 0 just
    before it), then RANKS spawned processes on the card serving both
    models' waves on a paged tp=2 engine spanning the ranks. Every rank's
    tokens, page tables, sealed names and blob bytes equal the logical
    run's; each name is sealed by exactly one rank (rank 0: the rows' data
    shard's model coordinate 0, and the owner of content-named pages);
    rank 0 alone sends frames; B1 ran on the ranks' path."""
    import torch.multiprocessing as mp
    from repro_torch.core import TrustDomain
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.models import build_model
    from repro_torch.runtime import Engine, GenerationRequest

    def gen(spec):
        prompt, mnt, prio = spec
        return GenerationRequest(prompt=prompt.copy(), max_new_tokens=mnt,
                                 priority=prio)

    runs, want = [], {}
    for name, cut, kw, waves in PAGED_RANKS:
        cfg = paged_ranks_config(name, cut, smoke)
        model = build_model(cfg, device=device)
        params = model.init_params(seed=0)
        fps = {n: fingerprint(torch, t)
               for n, t in tree_leaves_with_names(params)}
        rng = np.random.default_rng(17)
        specs = [(rng.integers(1, cfg.vocab_size, n).astype(np.int32), mnt,
                  prio) for n, mnt, prio in waves]
        # ---- the logical tp=2 run: every kernel count starts at 0 here --
        reset_counts(C, P, Q, FA)
        td = TrustDomain("tdx", device=device, **tp_keys())
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        eng = Engine(model, params, trust_domain=td, mesh=TP_MESH,
                     device=device, **kw)
        rec = paged_run_record(torch, eng, td, specs, gen, device)
        rec["peak"] = (torch.cuda.max_memory_allocated()
                       if device == "cuda" else 0)
        rec["launches"] = path_launches()
        # ---- end of the logical run ---------------------------------------
        check(rec["finished"] and rec["preemptions"] > 0,
              f"paged ranks, {name} logical tp=2: every request finished, "
              f"after a preemption")
        check(sum(rec["launches"].values())
              == rec["launches"]["chacha20_xor_blocked"]
              + rec["launches"]["flash_attention"],
              f"paged ranks, {name} logical tp=2: no kernel but B1 and the "
              f"prefills' B2 ran")
        check(all(rec["frozen"]) and (bool(rec["frozen"])
                                       or not eng.kv._dense),
              f"paged ranks, {name} logical tp=2: a row paused, and every "
              f"paused row's recurrent state stayed frozen")
        want[name] = rec
        runs.append((name, cut, kw, specs, fps))
        del eng, params, model
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    work = Path(__file__).resolve().parent / "build" / "paged_ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    mp.spawn(paged_rank_worker, nprocs=RANKS, join=True, args=(
        RANKS, str(work / "init"), device, runs, smoke, str(work)))
    wall = time.perf_counter() - t0
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(RANKS)]
    shutil.rmtree(work, ignore_errors=True)
    for name, *_ in PAGED_RANKS:
        w = want[name]
        names = {n for s_ in w["seals"] for n in s_}
        for r, got in enumerate(ranks):
            g = got[name]
            check(g["tokens"] == w["tokens"], f"paged ranks, {name}: rank "
                  f"{r}'s tokens equal the logical tp=2 run's")
            check(len(g["tables"]) == len(w["tables"]) and all(
                np.array_equal(a, b) for a, b in zip(g["tables"],
                                                     w["tables"])),
                  f"paged ranks, {name}: rank {r}'s page table equals the "
                  f"logical run's after every step")
            check(g["seals"] == w["seals"], f"paged ranks, {name}: rank "
                  f"{r}'s sealed names and blob bytes equal the logical "
                  f"run's")
            check(g["preemptions"] > 0 and g["restore_events"] > 0,
                  f"paged ranks, {name}: a preemption and its restore")
            check(len(g["frozen"]) == len(w["frozen"]) and all(g["frozen"]),
                  f"paged ranks, {name}: rank {r} kept every paused row's "
                  f"block of recurrent state frozen")
        sealed_by = [n for got in ranks for n in got[name]["own"]]
        check(len(sealed_by) == len(set(sealed_by))
              and names <= set(sealed_by),
              f"paged ranks, {name}: every name sealed by exactly one rank")
        check(all(not got[name]["own"] for got in ranks[1:]),
              f"paged ranks, {name}: only rank 0 sealed")
        check(ranks[0][name]["frames"] > 0
              and all(got[name]["frames"] == 0 for got in ranks[1:]),
              f"paged ranks, {name}: rank 0 alone sent egress frames")
        check(sum(got[name]["launches"] for got in ranks) > 0,
              f"paged ranks, {name}: B1 ran under the page seals")
    launches = sum(got[name]["launches"] for got in ranks
                   for name, *_ in PAGED_RANKS)
    logical = {k: sum(w["launches"][k] for w in want.values())
               for k in want[PAGED_RANKS[0][0]]["launches"]}
    return dict(ranks=ranks, want=want, wall_s=wall, launches=launches,
                logical_launches=logical)


def reset_counts(*kernels) -> None:
    for K in kernels:
        K.reset_launches()


def serve_waves(engine, specs, gen):
    """The low wave, 3 steps, then the preempting high wave, to the end."""
    reqs = [engine.submit(gen(s)) for s in specs[:len(LOW_WAVE)]]
    for _ in range(3):
        engine.step()
    reqs += [engine.submit(gen(s)) for s in specs[len(LOW_WAVE):]]
    stats = engine.run(max_steps=10_000)
    return reqs, stats


def check_solo(Engine, TrustDomain, model, params, specs, gen, outputs, kw):
    """Each request alone on a fresh engine of the same path gives the
    same tokens (comparison only)."""
    for i, spec in enumerate(specs):
        solo = Engine(model, params, trust_domain=TrustDomain("tdx"), **kw)
        r = solo.submit(gen(spec))
        solo.run(max_steps=10_000)
        check(list(r.output) == outputs[i],
              f"request {i} tokens equal its solo run "
              f"({outputs[i]} vs {list(r.output)})")


def phase_serve(torch, np) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import SealingKey, TrustDomain
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
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

    path_s = {}
    t_path = time.perf_counter()
    # ---- the slot path: every kernel count starts at 0 here -------------
    torch.cuda.reset_peak_memory_stats()
    reset_counts(C, P, Q, FA)
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
    reqs, stats = serve_waves(engine, specs, gen)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = C.launches
    slot_b2 = FA.launches
    check(sum(P.launches.values()) + Q.launches == 0,
          "the slot path runs no paged or int8 kernel")
    check(FA.launches > 0, "the slot path prefilled through B2")
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the slot path ---------------------------------------------

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

    check_solo(Engine, TrustDomain, model, unsealed, specs, gen, outputs,
               ENGINE_KW)
    print(f"  slot path: {len(specs)} requests, tokens equal their solo runs")
    path_s["slot"] = time.perf_counter() - t_path
    t_path = time.perf_counter()

    # ---- the paged-kernel path: every kernel count starts at 0 here ------
    gc.collect()    # the peak starts from what is live, not from garbage
    torch.cuda.reset_peak_memory_stats()
    reset_counts(C, P, Q, FA)
    td2 = TrustDomain("tdx", sealing_key=SealingKey.generate(b"chip-smoke-2"),
                      io_key=SealingKey.generate(b"chip-smoke-io-2"))
    paged = Engine(model, unsealed, trust_domain=td2, **PAGED_KW)
    t0 = time.perf_counter()
    preqs, pstats = serve_waves(paged, specs, gen)
    torch.cuda.synchronize()
    paged_s = time.perf_counter() - t0
    paged_launches = {"chacha20_xor_blocked": C.launches, **P.launches,
                      "flash_attention": FA.launches}
    paged_peak = torch.cuda.max_memory_allocated()
    check(Q.launches == 0, "the paged path runs no int8 kernel")
    check(FA.launches > 0, "the paged path prefilled through B2")
    # ---- end of the paged-kernel path -------------------------------------
    check(all(r.finished for r in preqs), "paged: every request finished")
    check(pstats.preemptions > 0, "paged: the high wave forced a preemption")
    for name in ("paged_attention", "paged_attention_unseal"):
        check(paged_launches[name] > 0, f"paged: the path launched {name}")
    check(paged.kv.fused_restore_pages > 0,
          "paged: a restore admitted pages as ciphertext")
    poutputs = [list(r.output) for r in preqs]
    check_solo(Engine, TrustDomain, model, unsealed, specs, gen, poutputs,
               PAGED_KW)
    agree = sum(a == b for o, p in zip(outputs, poutputs)
                for a, b in zip(o, p))
    print(f"  paged-kernel path: {len(specs)} requests, tokens equal their "
          f"solo runs; {paged.kv.fused_restore_pages} pages restored as "
          f"ciphertext; {agree} of {sum(map(len, outputs))} tokens agree with "
          f"the slot path (not required: the slot sdpa rounds probabilities "
          f"to bf16 before p.v)")
    pch = td2.channel.stats
    del paged
    path_s["paged-kernel"] = time.perf_counter() - t_path

    t_path = time.perf_counter()
    sh = phase_share(torch, np, model, unsealed, cfg)
    path_s["sharing"] = time.perf_counter() - t_path
    print(f"  sharing path: {sh['n']} sampled requests ({sh['tokens']} "
          f"tokens), each equal to its solo run; {sh['shared']} shared-page "
          f"maps, {sh['cow']} CoW copies, {sh['written']} pages written "
          f"(unshared {sh['plain_written']}), {sh['fused']} pages restored "
          f"as ciphertext; pool invariants held after every step")

    gc.collect()
    torch.cuda.empty_cache()
    t_path = time.perf_counter()
    st = phase_store(torch, np, model, unsealed, cfg)
    path_s["store"] = time.perf_counter() - t_path
    print(f"  store path: {st['n']} sampled requests x 2 epochs on one "
          f"engine; warm tokens equal cold and every request its solo run; "
          f"pages written {st['cold']['written']} cold vs "
          f"{st['warm']['written']} warm, store hits {st['cold']['hits']} "
          f"cold vs {st['warm']['hits']} warm; a tampered entry failed "
          f"before any page moved; pool invariants held after every step")
    gc.collect()
    torch.cuda.empty_cache()
    t_path = time.perf_counter()
    tp = phase_two_phase(torch, np, model, unsealed, cfg)
    path_s["two-phase"] = time.perf_counter() - t_path
    print(f"  two-phase path: {tp['n']} sampled requests in "
          f"{len(tp['modes'])} modes; tokens equal within each backend and "
          f"every request its solo run; {tp['agree']} of {tp['tokens']} "
          f"tokens agree between the slot and paged-kernel backends (not "
          f"required)")
    gc.collect()
    torch.cuda.empty_cache()
    t_path = time.perf_counter()
    fl = phase_fleet(torch, np, model, unsealed, cfg)
    path_s["fleet"] = time.perf_counter() - t_path
    print(f"  fleet path: {fl['n']} sampled requests over 2 tenants on 2 "
          f"workers; killed {fl['victim']} after {FLEET_KILL_AT} steps, "
          f"respawned it, drained {fl['survivor']} onto it; every request "
          f"equals its solo run and the run without the kill; "
          f"{fl['migrated']} migrants; a cross-tenant restore failed MAC "
          f"and leaked nothing; every pool all free after the run")
    gc.collect()
    torch.cuda.empty_cache()
    t_path = time.perf_counter()
    rg = phase_rag(torch, np, model, unsealed, cfg)
    path_s["RAG"] = time.perf_counter() - t_path
    print(f"  RAG path: bm25+rerank over {len(rag_corpus())} documents; "
          f"encoder embeddings card vs CPU within {rg['emb_err']:.3g} "
          f"(limit {RAG_EMB_TOL}), the same ranking up to near ties; "
          f"determinism: each answer equals engine.generate on its trimmed "
          f"prompt (B3 at this table checked against plain above)")
    gc.collect()
    torch.cuda.empty_cache()
    t_path = time.perf_counter()
    ms = phase_mesh(torch, np, model, unsealed, specs, gen, outputs)
    path_s["mesh"] = time.perf_counter() - t_path
    print(f"  mesh path: {len(specs)} requests on a {MESH} mesh per backend "
          f"({', '.join(ms)}); tokens bit-equal to the single-device "
          f"engine's and to each request's solo run on the mesh engine; "
          f"every sealed name tagged /s0 or /s1; victims restored onto the "
          f"other shard: "
          + ", ".join(f"{label} {r['crossed']} of {r['seals']}"
                      for label, r in ms.items())
          + "; collective bytes a step equal the plan's half of the "
            "non-norm weights")

    gc.collect()
    torch.cuda.empty_cache()
    t_path = time.perf_counter()
    tpo = phase_tp(torch, np, model, unsealed, specs, gen, ms)
    path_s["tp"] = time.perf_counter() - t_path
    print(f"  TP path: {len(specs)} requests on a {TP_MESH} mesh of logical "
          f"shards per backend ({', '.join(MESH_BACKENDS)}); each request "
          f"equals its solo run on the tp=2 engine; tokens equal to one "
          f"device's (not required: the partials round in another order): "
          + ", ".join(f"{label} {tpo[label]['agree']} of "
                      f"{tpo[label]['tokens']}" for label in MESH_BACKENDS)
          + f"; one decode step's logits vs one device's: max |diff| "
            f"{tpo['logits']['err']:.4g}, max |logit| "
            f"{tpo['logits']['scale']:.4g} (tol {TP_LOGITS_REL_TOL} x max), "
            f"argmax equal: {tpo['logits']['argmax']}; collective bytes a "
            f"step equal the formula's {tpo['slot']['expect_b']} B")

    # one decode step's logits: paged-kernel path vs slot path, same cache
    from repro_torch.runtime.kvcache import make_backend
    prompt = torch.as_tensor(specs[2][0][None, :], device="cuda")
    with torch.inference_mode():
        _, dense = model.prefill(unsealed, {"tokens": prompt},
                                 model.init_cache(1, ENGINE_KW["max_len"]))
        kv = make_backend("paged", model, max_slots=1,
                          max_len=ENGINE_KW["max_len"], page_size=16,
                          decode="kernel")
        kv.insert_prefill(dense, [kv.acquire(0, 128)], prompt.shape[1])
        tok = np.array([5], np.int32)
        got = kv.decode_logits(unsealed, tok, [0])
        ref, _ = model.decode_step(unsealed, torch.as_tensor(
            tok[:, None], device="cuda"), dense)
        kv_decode_s = time_host(lambda: kv.decode_logits(unsealed, tok, []),
                                10)
        kv_positions = int(kv.pos[0]) + 1
    logit_err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    check(bool(torch.isfinite(got).all()), "paged-kernel logits finite")
    check(logit_err <= LOGITS_REL_TOL * scale,
          f"paged-kernel logits within {LOGITS_REL_TOL} x max |logit| of the "
          f"slot path's ({logit_err:.4g} vs max {scale:.4g})")
    print(f"  one decode step's logits, paged-kernel vs slot path: max |diff| "
          f"{logit_err:.4g}, max |logit| {scale:.4g} (tol "
          f"{LOGITS_REL_TOL} x max); argmax equal: "
          f"{int(got.argmax()) == int(ref.argmax())}")
    del kv, dense
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
    # a bucket group's prefill: one [rows, s] call, as before the plan
    # prefilled one row a call, against the plan's one row a call
    from repro_torch.runtime.plan import SingleDevicePlan
    one_row = SingleDevicePlan(model).compile_prefill()
    group_ms = {}
    for rows, width in PREFILL_GROUPS:
        toks = torch.as_tensor(np.random.default_rng(31).integers(
            1, cfg.vocab_size, (rows, width)), dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            batched = time_host(lambda t=toks, r=rows: model.prefill(
                unsealed, {"tokens": t}, model.init_cache(r, max_len)), 3)
        split = time_host(lambda t=toks, r=rows: one_row(
            unsealed, t, model.init_cache(r, max_len)), 3)
        group_ms[(rows, width)] = (batched * 1e3, split * 1e3)
    probe = TrustDomain("tdx")
    sid = probe.open_stream()
    frame_s = time_host(lambda: probe.egress_tokens(sid, [1]), 20)
    return dict(stats=stats, channel=ch, seal_s=seal_s, unseal_s=unseal_s,
                serve_s=serve_s, launches=launches, slot_b2=slot_b2,
                weight_launches=weight_launches, peak=peak,
                weight_bytes=n_weights, n_requests=len(specs),
                decode_s=decode_s, prefill_s=prefill_s, frame_s=frame_s,
                group_ms=group_ms,
                paged_stats=pstats, paged_channel=pch, paged_s=paged_s,
                paged_launches=paged_launches, paged_peak=paged_peak,
                logit_err=logit_err,
                kv_decode_s=kv_decode_s, kv_positions=kv_positions,
                share=sh, store=st, two_phase=tp, fleet=fl, rag=rg,
                mesh=ms, tp=tpo, specs=specs, path_s=path_s)


# the families path: one model of each family beyond dense, at its published
# widths (d_model, heads, kv heads, head dim, experts, top-k, expert d_ff,
# MLA ranks, SSM state, vocab), depth cut to the smallest unit that holds
# every layer kind of the family: (config, depth cut, engine). Each runs
# under tdx with 2 slots, max_len 256 and buckets 32/64/128; the load is
# seal, attest, unseal; the traffic the slot path's low wave (prompts of 20,
# 24, 100 and 40 tokens) at 16 new tokens each, then after 3 steps one
# preempting high-priority request of 100 tokens. On jamba the low with the
# lower rid is first partially evicted (one tail page); the high request
# then whole-seals its mate and reserves the last free pages of an
# 11-page pool (2 pages stay with the paused low, the high takes 9), so
# the paused low sits out decode steps until the high finishes.
FAMILY_GATHER = dict(PAGED_KW, kv_decode="gather")
FAMILIES = [
    ("rwkv6-3b", dict(num_layers=4), ENGINE_KW),
    ("chameleon-34b", dict(num_layers=2), PAGED_KW),
    ("dbrx-132b", dict(num_layers=1), FAMILY_GATHER),
    # one MLA + dense layer and one MLA + MoE layer (256 experts + 1 shared)
    ("deepseek-v3-671b", dict(num_layers=2, moe=dict(first_k_dense=1)),
     FAMILY_GATHER),
    # one whole group: 7 Mamba + 1 attention, MoE on the odd slots
    ("jamba-v0.1-52b", dict(num_layers=8),
     dict(FAMILY_GATHER, num_pages=JAMBA_PAGES)),
]
# whisper-small at full size (12 + 12 layers): no engine (the reference's
# server refuses the encoder-decoder); Model.prefill over WHISPER_FRAMES
# frame embeddings and a WHISPER_PROMPT-token prompt, then WHISPER_STEPS
# greedy decode_steps, each step's logits within WHISPER_LOGIT_TOL x
# max |logit| of the cache-free forward over the same tokens (bf16: the
# two run their products at other row counts, so cuBLAS rounds them apart)
WHISPER_FRAMES = 1500
WHISPER_PROMPT = 4
WHISPER_STEPS = 16
WHISPER_LOGIT_TOL = 0.05
# words of a tensor fingerprinted at a time on the card
FINGERPRINT_CHUNK = 1 << 24


def fingerprint(torch, t) -> int:
    """A 64-bit digest of a tensor's bytes, on its device: the bytes as
    int32 words (zero-padded to a whole word), each times an odd weight
    from its index, summed modulo 2**64. A flipped bit changes one word by
    +-2**k (k < 32), and so the sum by an odd multiple of 2**k: never 0
    modulo 2**64. The bit-equality check of an unseal keeps these, not a
    second copy of the weights."""
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if raw.numel() % 4:
        raw = torch.cat([raw, raw.new_zeros(4 - raw.numel() % 4)])
    words = raw.view(torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for i in range(0, words.numel(), FINGERPRINT_CHUNK):
        w = words[i:i + FINGERPRINT_CHUNK].to(torch.int64)
        idx = torch.arange(i, i + w.numel(), dtype=torch.int64,
                           device=t.device)
        total += (w * ((idx * 2654435761 + 12345) % (1 << 31) | 1)).sum()
    return int(total)


def family_config(name: str, cut: dict):
    """The registered config with its depth cut applied (a dict value
    replaces fields of that sub-config)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
        else v for k, v in cut.items()})


def load_family(torch, model, key: bytes):
    """Random weights from seed 0 on the card, sealed (ciphertext on the
    card), the plaintext freed, attested, unsealed; the unsealed leaves
    must fingerprint as the originals did. At most two copies of the
    weights are on the card at a time. Returns (TrustDomain, weights,
    load figures)."""
    from repro_torch.core import SealingKey, TrustDomain
    from repro_torch.core.sealing import tree_leaves_with_names, tree_map
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    prints = {n: fingerprint(torch, leaf)
              for n, leaf in tree_leaves_with_names(params)}
    skeleton = tree_map(lambda t: None, params)
    sizes = [leaf.numel() * leaf.element_size()
             for _, leaf in tree_leaves_with_names(params)]
    n_bytes = sum(sizes)
    check(max(sizes) <= FAMILY_LEAF_BLOCKS * 64,
          f"{model.cfg.name}: its largest leaf ({max(sizes)} B) is within "
          f"the size phase 3 checks B1 at ({FAMILY_LEAF_BLOCKS * 64} B)")
    td = TrustDomain("tdx", sealing_key=SealingKey.generate(key),
                     io_key=SealingKey.generate(key + b"-io"))
    t0 = time.perf_counter()
    sealed = td.seal_params(params)
    torch.cuda.synchronize()
    seal_s = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    verifier = td.make_verifier(model.cfg.name)
    verifier.verify(td.quote(verifier.challenge(), model.cfg.name))
    t0 = time.perf_counter()
    unsealed = td.load_sealed(sealed, skeleton)
    torch.cuda.synchronize()
    unseal_s = time.perf_counter() - t0
    del sealed
    gc.collect()
    torch.cuda.empty_cache()
    for n, leaf in tree_leaves_with_names(unsealed):
        check(fingerprint(torch, leaf) == prints[n],
              f"{model.cfg.name}: unsealed weight {n} bit-equal to the "
              f"original (fingerprint)")
    return td, unsealed, dict(seal_s=seal_s, unseal_s=unseal_s,
                              weight_bytes=n_bytes, n_leaves=len(prints))


def family_waves(eng, specs, gen):
    """FAMILY_WAVE, 3 steps, then FAMILY_HIGH, to the end. On a paged
    backend with recurrent state (slot-dense rows beside the pages) the
    lower-rid low is partially evicted (one tail page) just before the
    high request's step; its recurrent-state rows must come out of that
    step, which it sits out while the high request steps, bit for bit as
    they went in. Returns (requests, stats, rows frozen or None)."""
    import torch
    reqs = [eng.submit(gen(s)) for s in specs[:len(FAMILY_WAVE)]]
    for _ in range(3):
        eng.step()
    frozen = None
    reqs.append(eng.submit(gen(specs[-1])))
    dense = getattr(eng.kv, "_dense", None)
    if dense:
        running = eng.scheduler.running
        slot = min(running, key=lambda s: running[s].rid)
        eng.partial_preempt(slot, 1)
        before = {k: v[:, slot].clone() for k, v in dense.items()}
        eng.step()
        check(slot in eng._paused and len(eng.scheduler.running) == 2,
              "the partially evicted low sat out the step in which the "
              "high request stepped")
        frozen = all(torch.equal(v[:, slot], before[k])
                     for k, v in dense.items())
    stats = eng.run(max_steps=10_000)
    return reqs, stats, frozen


# one decode step's logits, tp=2 vs one device, bf16, 1 or 2 layers: each
# of the 3 or 5 reductions rounds two bf16 partials and their sum where one
# device rounds one product, about 2 x 2^-9 of the residual's scale each,
# so about sqrt(5) x 2 x 2^-9 = 0.9 % of max |logit| was expected. The H100
# (700 W) measured 0.99 % (chameleon-34b), 0.62 % (dbrx-132b) and 0.88 %
# (deepseek-v3-671b), every argmax equal: 3 % is 3x the largest gap (a MoE
# token whose top-k choice sits on a tie would route elsewhere on one side
# and move far more)
FAMILY_TP_LOGITS_REL_TOL = 0.03
# the families on a tp=2 mesh of logical shards, each on its one-device
# run's unsealed weights (no second load or seal): chameleon's GQA 64/8 with
# qk-norm and dbrx's 16 experts (8 a shard) on paged-gather (a mesh refuses
# kernel decode), deepseek-v3's MLA heads and 256 experts (128 a shard) on
# the slot backend; jamba's group of 8 (4,096 of 8,192 Mamba channels and 8
# of 16 experts a shard) on paged-gather with its 11-page pool and the
# paused row's freeze; rwkv6's 4 layers (20 of 40 heads a shard) on the
# slot backend, as the reference serves it. Each: the engine's kwargs and
# the limit on one decode step's logits, tp=2 vs one device, relative to
# max |logit|; None holds them by tp_f32_witness instead (jamba's 8 bf16
# layers: each bf16 run drifts about 2.5 % from exact, so the two bf16
# runs part by up to the sum, and a fixed limit would only restate it)
FAMILY_TP = {"chameleon-34b": (FAMILY_GATHER, FAMILY_TP_LOGITS_REL_TOL),
             "dbrx-132b": (FAMILY_GATHER, FAMILY_TP_LOGITS_REL_TOL),
             "deepseek-v3-671b": (ENGINE_KW, FAMILY_TP_LOGITS_REL_TOL),
             "jamba-v0.1-52b": (dict(FAMILY_GATHER, num_pages=JAMBA_PAGES),
                                None),
             "rwkv6-3b": (ENGINE_KW, FAMILY_TP_LOGITS_REL_TOL)}
# tp_f32_witness, on the served weights upcast to f32 after the bf16 runs:
# f32 tp=2 logits within TP_F32_TOL x max |logit| of f32 one device's with
# the same argmax (the tp=2 compute is the one-device compute up to f32
# rounding), and the bf16 tp=2 logits no further from the f32 one device's
# than TP_BF16_RATIO x the bf16 one device's are: tp=2's extra roundings
# (two bf16 partials and their sum where one device rounds one product)
# may at most double the error bf16 makes on one device
TP_F32_TOL = 1e-4
TP_BF16_RATIO = 2.0


def family_tp(torch, np, name, model, params, specs, gen, one, key) -> dict:
    """A family's TP path: the waves on a tp=2 engine of logical shards
    over the one-device run's weights, every kernel count set to 0 just
    before; each request equal to its solo run on the tp=2 engine (a MoE
    family: a rerun on a fresh tp=2 engine, as its one-device check), the
    collective bytes a step equal to tp_step_bytes, one decode step's
    logits within FAMILY_TP's limit of one device's (or, without one,
    kept for tp_f32_witness)."""
    from repro_torch.core import SealingKey, TrustDomain
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.runtime import Engine

    cfg, (kw, tol) = model.cfg, FAMILY_TP[name]
    expect_b = tp_step_bytes(cfg, kw["max_slots"], 2)

    def tp_engine():
        return Engine(model, params, mesh=TP_MESH, **kw,
                      trust_domain=TrustDomain(
                          "tdx", sealing_key=SealingKey.generate(key + b"-tp"),
                          io_key=SealingKey.generate(key + b"-tp-io")))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # ---- the family's TP path: every kernel count starts at 0 here -------
    reset_counts(C, P, Q, FA)
    eng = tp_engine()
    t0 = time.perf_counter()
    reqs, stats, frozen = family_waves(eng, specs, gen)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = path_launches()
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the family's TP path --------------------------------------
    check(eng.plan.tp == 2, f"{name} tp: the engine spans a tp=2 plan")
    check(all(r.finished for r in reqs) and stats.preemptions > 0,
          f"{name} tp: every request finished, after a preemption")
    if frozen is not None:
        check(frozen, f"{name} tp: the paused row's recurrent-state rows "
                      f"are bit-equal before and after the step it sat out")
    check(launches["chacha20_xor_blocked"] > 0
          and sum(launches.values()) == launches["chacha20_xor_blocked"]
          + launches["flash_attention"],
          f"{name} tp: B1 ran under the seals, and no other kernel but the "
          f"prefills' B2 ({launches})")
    outputs = [list(r.output) for r in reqs]
    ch = eng.td.channel.stats
    steps = ch.collective_steps
    per_step = ch.collective_bytes // max(steps, 1)
    check(per_step == eng.plan.collective_bytes_per_step == expect_b
          and ch.collective_bytes == steps * expect_b,
          f"{name} tp: {per_step} collective B/step == the formula's "
          f"{expect_b} B")
    coll_ms = ch.collective_s / max(steps, 1) * 1e3
    if model.rows_coupled:
        del eng
        rerun, _, _ = family_waves(tp_engine(), specs, gen)
        check([list(r.output) for r in rerun] == outputs,
              f"{name} tp: a rerun on a fresh tp=2 engine repeats every "
              f"token")
        same = "a rerun on a fresh tp=2 engine repeats every token"
    else:
        for i, spec in enumerate(specs):
            r = eng.submit(gen(spec))
            eng.run(max_steps=10_000)
            check(list(r.output) == outputs[i], f"{name} tp: request {i} "
                  f"equals its solo run on the tp=2 engine")
        same = "every request equals its solo run on the tp=2 engine"
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    prompts = torch.as_tensor(np.stack([specs[0][0][:20], specs[1][0][:20]]),
                              device="cuda")
    toks = torch.tensor([[5], [9]], dtype=torch.int32, device="cuda")
    ref = step_logits(torch, Engine, model, params, None, prompts, toks)
    got = step_logits(torch, Engine, model, params, TP_MESH, prompts, toks)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(bool(torch.isfinite(got).all()), f"{name} tp logits finite")
    if tol is not None:
        check(err <= tol * scale,
              f"{name}: tp=2 logits within {tol} x max |logit| of one "
              f"device's ({err:.4g} vs max {scale:.4g})")
    return dict(stats=stats, one=one, wall_s=wall_s, launches=launches,
                peak=peak, steps=steps, per_step=per_step, expect_b=expect_b,
                coll_ms=coll_ms, same=same, err=err, scale=scale, tol=tol,
                frozen=frozen, logits=(prompts, toks, ref, got),
                argmax=bool(torch.equal(got.argmax(-1), ref.argmax(-1))),
                backend=kw["kv_backend"] + ("-gather" if kw["kv_backend"]
                                            == "paged" else ""),
                agree=sum(a == b for o, p in zip(outputs, one["outputs"])
                          for a, b in zip(o, p)),
                tokens=sum(map(len, outputs)))


def phase_family(torch, np, name, cut, kw) -> dict:
    """One decoder family: load, the waves with every kernel count set to
    0 just before the load, then the checks (finite logits, tokens in the
    vocabulary, solo runs or a rerun, the pause freeze on jamba) and the
    prefill and decode_step times."""
    from repro_torch.core import SealingKey, TrustDomain
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.models import build_model
    from repro_torch.runtime import Engine, GenerationRequest

    cfg = family_config(name, cut)
    model = build_model(cfg)            # the card
    rng = np.random.default_rng(13)
    specs = [(rng.integers(1, cfg.vocab_size, n).astype(np.int32), mnt, prio)
             for n, mnt, prio in FAMILY_WAVE + [FAMILY_HIGH]]

    def gen(spec):
        prompt, mnt, prio = spec
        return GenerationRequest(prompt=prompt.copy(), max_new_tokens=mnt,
                                 priority=prio)

    key = f"chip-family-{name}".encode()
    # ---- the family's path: every kernel count starts at 0 here ----------
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(C, P, Q, FA)
    td, params, load = load_family(torch, model, key)
    eng = Engine(model, params, trust_domain=td, **kw)
    t0 = time.perf_counter()
    reqs, stats, frozen = family_waves(eng, specs, gen)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = path_launches()
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the family's path -----------------------------------------
    check(launches["qmatmul"] == 0, f"{name}: the path runs no int8 kernel")
    attends = any(m == "attn" for _, _, slots in model._impl.blocks
                  for m, _ in slots)
    check((launches["flash_attention"] > 0) == attends,
          f"{name}: B2 prefilled the attention layers, and only those")
    check(launches["chacha20_xor_blocked"] > 0,
          f"{name}: the path launched chacha20_xor_blocked")
    if kw.get("kv_decode") == "kernel":
        for k in ("paged_attention", "paged_attention_unseal"):
            check(launches[k] > 0, f"{name}: the path launched {k}")
        check(eng.kv.fused_restore_pages > 0,
              f"{name}: a restore admitted pages as ciphertext")
    else:
        check(sum(P.launches.values()) == 0,
              f"{name}: gather decode runs no paged kernel")
    check(all(r.finished for r in reqs), f"{name}: every request finished")
    check(stats.preemptions > 0, f"{name}: the high request preempted")
    outputs = [list(r.output) for r in reqs]
    for spec, out in zip(specs, outputs):
        check(len(out) == spec[1] and all(0 <= t < cfg.vocab_size
                                          for t in out),
              f"{name}: request produced {spec[1]} tokens in the vocabulary")
    if frozen is not None:
        check(frozen, f"{name}: the paused row's recurrent-state rows are "
                      f"bit-equal before and after the step it sat out")
    if model.rows_coupled:
        # MoE capacity couples a row's tokens to its batch-mates (in the
        # reference too): a rerun on a fresh engine must repeat them
        again = Engine(model, params, **kw, trust_domain=TrustDomain(
            "tdx", sealing_key=SealingKey.generate(key),
            io_key=SealingKey.generate(key + b"-io")))
        rerun, _, _ = family_waves(again, specs, gen)
        check([list(r.output) for r in rerun] == outputs,
              f"{name}: a rerun on a fresh engine repeats every token")
        del again
        same = "a rerun on a fresh engine repeats every token"
    else:
        check_solo(Engine, TrustDomain, model, params, specs, gen, outputs,
                   kw)
        same = "every request equals its solo run"
    tp = (family_tp(torch, np, name, model, params, specs, gen,
                    dict(stats=stats, outputs=outputs), key)
          if name in FAMILY_TP else None)
    # logits finite on a real prompt, and the model's own step times
    b, max_len = ENGINE_KW["max_slots"], ENGINE_KW["max_len"]
    with torch.inference_mode():
        logits, cache = model.prefill(
            params, {"tokens": torch.as_tensor(specs[2][0][None, :],
                                               device="cuda")},
            model.init_cache(1, max_len))
        step, _ = model.decode_step(params, torch.ones(
            (1, 1), dtype=torch.int32, device="cuda"), cache)
        check(bool(torch.isfinite(logits).all())
              and bool(torch.isfinite(step).all())
              and tuple(logits.shape) == (1, cfg.vocab_size),
              f"{name}: prefill and decode logits finite")
        cache = model.init_cache(b, max_len)
        cache["pos"].fill_(128)
        tok = torch.ones((b, 1), dtype=torch.int32, device="cuda")
        prompt = torch.ones((1, 128), dtype=torch.int32, device="cuda")
        decode_s = time_host(lambda: model.decode_step(params, tok, cache), 5)
        prefill_s = time_host(lambda: model.prefill(
            params, {"tokens": prompt}, model.init_cache(1, max_len)), 3)
    out = dict(name=name, cut=cut, layers=cfg.num_layers, stats=stats,
               wall_s=wall_s, launches=launches, peak=peak, same=same,
               decode_s=decode_s, prefill_s=prefill_s,
               fused=getattr(eng.kv, "fused_restore_pages", 0), tp=tp,
               **load)
    del eng, cache, logits, step
    if tp is not None:
        bf16 = tp.pop("logits")
        if tp["tol"] is None:
            t0 = time.perf_counter()
            tp["witness"] = tp_f32_witness(torch, model, params, *bf16)
            tp["witness"]["s"] = time.perf_counter() - t0
        del bf16
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_whisper(torch, np) -> dict:
    """whisper-small at full size: load as the families do, then prefill
    over WHISPER_FRAMES frames and WHISPER_STEPS greedy decode steps, each
    held to the cache-free forward over the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.models import build_model

    cfg = get_config("whisper-small")
    model = build_model(cfg)
    g = torch.Generator(device="cuda").manual_seed(17)
    frames = torch.randn((1, WHISPER_FRAMES, cfg.d_model), generator=g,
                         device="cuda").to(cfg.torch_dtype)
    toks = torch.as_tensor(np.random.default_rng(17).integers(
        1, cfg.vocab_size, (1, WHISPER_PROMPT)), dtype=torch.int32,
        device="cuda")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(C, P, Q, FA)
    td, params, load = load_family(torch, model, b"chip-family-whisper")
    worst, step_s = 0.0, []
    with torch.inference_mode():
        cache = model.init_cache(1, WHISPER_FRAMES)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"frames": frames,
                                               "tokens": toks}, cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        for i in range(WHISPER_STEPS + 1):
            ref = model.forward(params, {"frames": frames,
                                         "tokens": toks})[0][:, -1]
            err = float((logits - ref).abs().max())
            scale = float(ref.abs().max())
            check(bool(torch.isfinite(logits).all()),
                  "whisper: logits finite")
            check(err <= WHISPER_LOGIT_TOL * scale,
                  f"whisper: step {i}'s logits within {WHISPER_LOGIT_TOL} x "
                  f"max |logit| of the cache-free forward ({err:.4g} vs max "
                  f"{scale:.4g})")
            worst = max(worst, err / scale)
            if i == WHISPER_STEPS:
                break
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            toks = torch.cat([toks, nxt], dim=1)
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, nxt, cache)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    launches = path_launches()
    peak = torch.cuda.max_memory_allocated()
    check(launches["chacha20_xor_blocked"] > 0
          and launches["flash_attention"] == cfg.decoder_layers
          and sum(v for k, v in launches.items() if k not in (
              "chacha20_xor_blocked", "flash_attention")) == 0,
          "whisper: the path launched chacha20_xor_blocked and the "
          "decoder prefill's B2 only")
    out = dict(launches=launches, peak=peak, prefill_s=prefill_s,
               step_ms=float(np.median(step_s)) * 1e3, worst=worst,
               tokens=toks.shape[1] - WHISPER_PROMPT, **load)
    del params, cache, frames
    gc.collect()
    torch.cuda.empty_cache()
    return out


def upcast_in_place(tree) -> None:
    """Every floating leaf of a tree of dicts to f32, one leaf at a time in
    place: each bf16 leaf is freed as its f32 copy is made, so the card
    never holds both trees."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            upcast_in_place(tree[k])
        elif tree[k].is_floating_point():
            tree[k] = tree[k].float()


def tp_f32_witness(torch, model, params, prompts, toks, one16,
                   tp16) -> dict:
    """The f32 witness of a family's tp=2 compute at the served width, on
    the served weights: ``params`` (the caller's only copy) upcast to f32
    in place, then one decode step's logits after ``prompts`` on one
    device and on tp=2 logical shards. The f32 tp=2 logits must be within
    TP_F32_TOL x max |logit| of the f32 one device's with the same argmax,
    and the bf16 tp=2 logits ``tp16`` no further from the f32 one device's
    than TP_BF16_RATIO x the bf16 one device's ``one16`` are."""
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.runtime import Engine

    name = model.cfg.name
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    upcast_in_place(params)
    model = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    ref = step_logits(torch, Engine, model, params, None, prompts, toks)
    f32 = step_logits(torch, Engine, model, params, TP_MESH, prompts, toks)
    scale = float(ref.abs().max())

    def rel(a):
        return float((a.float() - ref).abs().max()) / scale
    out = dict(f32=rel(f32), one16=rel(one16), tp16=rel(tp16),
               argmax=bool(torch.equal(f32.argmax(-1), ref.argmax(-1))),
               peak=torch.cuda.max_memory_allocated())
    check(ref.dtype == f32.dtype == torch.float32
          and bool(torch.isfinite(f32).all()),
          f"{name}: the witness's logits are f32 and finite")
    check(out["f32"] <= TP_F32_TOL and out["argmax"],
          f"{name}: f32 tp=2 logits within {TP_F32_TOL} x max |logit| of "
          f"f32 one device's ({out['f32']:.3e}), argmax equal")
    check(out["tp16"] <= TP_BF16_RATIO * out["one16"],
          f"{name}: bf16 tp=2 logits {out['tp16']:.3e} of max |logit| from "
          f"f32 one device's, within {TP_BF16_RATIO} x bf16 one device's "
          f"{out['one16']:.3e}")
    return out


def phase_families(torch, np) -> dict:
    """Every family of FAMILIES, then whisper, one model on the card at a
    time."""
    print(f"  device memory in use before the families (Llama2-7B freed): "
          f"{torch.cuda.memory_allocated()} B")
    out = {}
    for name, cut, kw in FAMILIES:
        t0 = time.perf_counter()
        out[name] = phase_family(torch, np, name, cut, kw)
        out[name]["path_s"] = time.perf_counter() - t0
        print_family(out[name])
    t0 = time.perf_counter()
    out["whisper-small"] = phase_whisper(torch, np)
    out["whisper-small"]["path_s"] = time.perf_counter() - t0
    print_whisper(out["whisper-small"])
    return out


def print_family(r) -> None:
    st = r["stats"]
    print(f"  {r['name']} (depth cut {r['cut']}): "
          f"{r['weight_bytes']} B of weights in {r['n_leaves']} leaves, seal "
          f"{r['seal_s']:.2f}s + unseal {r['unseal_s']:.2f}s, unsealed "
          f"bit-equal; {st.total_requests} requests / {st.total_tokens} "
          f"tokens in {r['wall_s']:.2f}s wall, {st.preemptions} "
          f"preemptions, {r['fused']} pages restored as ciphertext; "
          f"next-token p50 {st.p50_latency_s * 1e3:.2f} ms, TTFT p50 "
          f"{st.p50_ttft_s * 1e3:.2f} ms; prefill (1 x 128) "
          f"{r['prefill_s'] * 1e3:.2f} ms, decode_step (2 rows) "
          f"{r['decode_s'] * 1e3:.2f} ms; peak device memory {r['peak']} B; "
          f"{r['same']}; launches {r['launches']}; {r['path_s']:.1f}s with "
          f"its checks")
    t = r["tp"]
    if t:
        ts, one = t["stats"], t["one"]["stats"]
        print(f"    {r['name']} on tp=2 logical shards ({t['backend']}): "
              f"{ts.total_requests} requests / {ts.total_tokens} tokens in "
              f"{t['wall_s']:.2f}s wall; next-token p50 "
              f"{ts.p50_latency_s * 1e3:.2f} ms (one device "
              f"{one.p50_latency_s * 1e3:.2f} ms); {ts.preemptions} "
              f"preemptions; collectives {t['per_step']} B/step (formula "
              f"{t['expect_b']} B), {t['coll_ms']:.4f} ms a step (CUDA "
              f"events: sums and copies in device memory, one card, no "
              f"link); one decode step's logits within {t['err']:.4g} of "
              f"max |logit| {t['scale']:.4g} ({t['err'] / t['scale']:.3e}; "
              f"limit {t['tol'] or 'none: the f32 witness'}), argmax "
              f"{'equal' if t['argmax'] else 'differs'}; {t['agree']} of "
              f"{t['tokens']} tokens as one device's; {t['same']}; paused "
              f"row frozen: {t['frozen']}; peak device memory {t['peak']} "
              f"B; launches {t['launches']}")
        w = t.get("witness")
        if w:
            print(f"    {r['name']}'s f32 witness (the served weights upcast "
                  f"in place): f32 tp=2 logits {w['f32']:.3e} of max "
                  f"|logit| from f32 one device's (limit {TP_F32_TOL}), "
                  f"argmax {'equal' if w['argmax'] else 'differs'}; bf16 "
                  f"one device {w['one16']:.3e} and bf16 tp=2 "
                  f"{w['tp16']:.3e} from f32 one device's (ratio "
                  f"{w['tp16'] / w['one16']:.3f}, limit {TP_BF16_RATIO}); "
                  f"peak device memory {w['peak']} B; {w['s']:.1f}s")


def print_train(r, smi) -> None:
    card = f"[{smi}]"
    print(f"  losses {', '.join(f'{x:.4f}' for x in r['losses'])}; the "
          f"chunked loss {r['chunked']:.6f} vs unchunked {r['plain']:.6f}; "
          f"first step at 1 microbatch {r['loss_mb1']:.6f}")
    print(f"  step (CUDA events, median of steps 2-{TRAIN_STEPS}) "
          f"{r['med_ms']:.2f} ms ({', '.join(f'{x:.2f}' for x in r['step_ms'])}"
          f" ms), {r['tokens'] / (r['med_ms'] / 1e3):.0f} tokens/s {card}")
    print(f"  model FLOPs a step (6 N D, N = {r['n_params']}, D = "
          f"{r['tokens']}): {r['model_flops']:.4e}; FlopCounterMode counted "
          f"{r['counted_flops']:.4e} (remat's recompute included); the "
          f"median step at {r['share'] * 100:.2f} % of PEAK_FLOPS "
          f"(989 TFLOP/s bf16) {card}")
    seal_gbs = r["sealed_bytes"] / min(r["saves"]) / 1e9
    unseal_gbs = r["sealed_bytes"] / min(r["resumes"]) / 1e9
    print(f"  sealed checkpoint: {r['sealed_bytes']} B; saves "
          f"{', '.join(f'{x:.2f}' for x in r['saves'])} s (seal, MAC, "
          f"write; {seal_gbs:.3f} GB/s), restore "
          f"{', '.join(f'{x:.2f}' for x in r['resumes'])} s (read, MAC, "
          f"unseal; {unseal_gbs:.3f} GB/s); B1 launches {r['b1']} {card}")
    print(f"  clean run {r['clean_s']:.2f} s, restarted run "
          f"{r['restart_s']:.2f} s, launcher subprocess {r['launch_s']:.2f} "
          f"s ({'; '.join(r['launcher'])}); peak device memory of the clean "
          f"run {r['peak']} B; the path {r['path_s']:.2f} s; launches "
          f"{r['launches']} {card}")


def print_whisper(r) -> None:
    print(f"  whisper-small (full, 12 + 12 layers): {r['weight_bytes']} B of "
          f"weights in {r['n_leaves']} leaves, seal {r['seal_s']:.2f}s + "
          f"unseal {r['unseal_s']:.2f}s, unsealed bit-equal; prefill over "
          f"{WHISPER_FRAMES} frames + {WHISPER_PROMPT} tokens "
          f"{r['prefill_s'] * 1e3:.2f} ms, decode_step p50 "
          f"{r['step_ms']:.2f} ms over {r['tokens']} greedy steps, each "
          f"within {r['worst']:.3g} x max |logit| of the cache-free forward "
          f"(limit {WHISPER_LOGIT_TOL}); peak device memory {r['peak']} B; "
          f"launches {r['launches']}; {r['path_s']:.1f}s with its checks")


# the training path (the reference's `train` variant, launch/dryrun.py's
# VARIANTS, on Llama2-7B at published width, depth cut to 2 of 32 layers:
# the full depth's train state, bf16 params and grads plus an f32
# accumulator and f32 moments, would not fit the card's 80 GB)
TRAIN_LAYERS = 2
TRAIN_PARALLEL = dict(attention_chunk=512, loss_chunk=512, microbatches=8,
                      remat="full")
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_STEPS = 6
# the launcher's schedule for 6 steps (warmup_steps = max(1, steps // 10))
# at a tenth of its default lr: AdamW's first update moves every weight by
# about lr in its gradient's sign, so a 4096-wide matrix's output moves by
# about lr x 4096; at 3e-4 that is the signal's own scale, and on the card
# the loss ended 6 steps above where it started (PERF.md §6), while at
# 3e-5 it falls every step
TRAIN_OPT = dict(lr=3e-5, warmup_steps=1, total_steps=TRAIN_STEPS)
TRAIN_CKPT_EVERY = 3
TRAIN_FAIL_AT = 4
# first-step loss, 8 microbatches vs 1 (tests/test_train.py's bound)
TRAIN_MB_TOL = 5e-2
# loss with attention and loss chunks of 512 vs unchunked, on one batch:
# the chunks only change f32 summation order (bf16 rounding can follow)
TRAIN_CHUNK_TOL = 1e-2
TRAIN_LAUNCHER = ["--arch", "deepseek-7b", "--smoke", "--steps", "4",
                  "--tee", "tdx", "--fail-at", "2"]


def train_config(**parallel):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("llama2-7b")
    return dataclasses.replace(cfg, num_layers=TRAIN_LAYERS,
                               parallel=dataclasses.replace(
                                   cfg.parallel, **dict(TRAIN_PARALLEL,
                                                        **parallel)))


def phase_train(torch, np) -> dict:
    """Llama2-7B (2 layers at full width, bf16) trained on the card: the
    chunked loss against the unchunked one, the first step at 1 vs 8
    microbatches, a clean train_loop of TRAIN_STEPS steps (CUDA events a
    step, every gradient finite), one step under FlopCounterMode, then
    run_with_restarts over the same data with sealed checkpoints
    (keep_n=1) and an injected failure: its losses and final state equal
    the clean run's. Last, the port's launcher in a subprocess (smoke
    deepseek-7b on the card, a failure drill). Every kernel count is set
    to 0 just before and read just after: B1 (the checkpoints' seals and
    unseals) must be the only kernel launched."""
    import shutil
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import TrustDomain
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.data.pipeline import PackedLMDataset
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                         run_with_restarts)
    from repro_torch.models import build_model
    from repro_torch.roofline.analysis import PEAK_FLOPS, model_flops_for
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import (init_train_state,
                                              make_train_step, train_loop)

    reset_counts(C, P, Q, FA)
    t_path = time.perf_counter()
    cfg = train_config()
    model = build_model(cfg)            # the card
    opt = AdamWConfig(**TRAIN_OPT, moment_dtype=cfg.parallel.optimizer_dtype)
    state0 = init_train_state(model, opt, seed=0)
    n_params = sum(leaf.numel() for _, leaf in
                   tree_leaves_with_names(state0.params))

    def data_factory(cursor):
        it = iter(PackedLMDataset(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                  seed=0))
        for _ in range(cursor):
            next(it)
        return it
    batch = next(data_factory(0))
    tbatch = {k: torch.as_tensor(v, device=model.device)
              for k, v in batch.items()}

    # chunked (512, 512) vs unchunked loss on one batch, no gradients
    with torch.no_grad():
        chunked = float(model.loss(state0.params, tbatch)[0])
        plain = float(build_model(train_config(
            attention_chunk=0, loss_chunk=0)).loss(state0.params, tbatch)[0])
    check(np.isfinite(chunked) and abs(chunked - plain) <= TRAIN_CHUNK_TOL,
          f"the chunked loss {chunked:.6f} is within {TRAIN_CHUNK_TOL} of "
          f"the unchunked {plain:.6f}")

    # the first step at one microbatch (its loss against the clean run's)
    _, m1 = make_train_step(model, opt, microbatches=1)(state0, batch)
    loss_mb1 = float(m1["loss"])
    del m1
    gc.collect()
    torch.cuda.empty_cache()

    finite = []

    def grads_finite(grads):
        finite.append(torch.stack([torch.isfinite(g).all() for _, g in
                                   tree_leaves_with_names(grads)]).all())
        return grads
    step = make_train_step(model, opt,
                           microbatches=cfg.parallel.microbatches,
                           grad_transform=grads_finite)
    events = []

    def timed_step(state, b):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step(state, b)
        e1.record()
        events.append((e0, e1))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    clean, hist = train_loop(model, state0, timed_step, data_factory(0),
                             num_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    clean_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    step_ms = [a.elapsed_time(b) for a, b in events]
    med_ms = float(np.median(step_ms[1:]))
    check(all(bool(f) for f in finite) and len(finite) == TRAIN_STEPS,
          "every gradient of the clean run is finite")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"the loss falls over {TRAIN_STEPS} steps ({losses[0]:.4f} -> "
          f"{losses[-1]:.4f})")
    check(abs(losses[0] - loss_mb1) <= TRAIN_MB_TOL,
          f"the first step's loss at 8 microbatches ({losses[0]:.6f}) is "
          f"within {TRAIN_MB_TOL} of one microbatch's ({loss_mb1:.6f})")
    prints = {n: fingerprint(torch, leaf)
              for n, leaf in tree_leaves_with_names(clean)}
    del clean
    gc.collect()
    torch.cuda.empty_cache()

    # one step counted by FlopCounterMode (remat's recompute included)
    with FlopCounterMode(display=False) as fc:
        out = step(state0, batch)
        float(out[1]["loss"])
    counted = fc.get_total_flops()
    del out
    gc.collect()
    torch.cuda.empty_cache()
    mflops = model_flops_for(cfg, ShapeConfig(
        "train", TRAIN_SEQ, TRAIN_BATCH, "train"))

    # the same run through sealed checkpoints and a failure
    ckpt_dir = Path(__file__).resolve().parent / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    times = {"save": [], "resume": []}

    class TimedManager(CheckpointManager):
        def save(self, s, tree):
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = super().save(s, tree)
            times["save"].append(time.perf_counter() - t)
            return path

        def resume(self, like, device=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = super().resume(like, device)
            torch.cuda.synchronize()
            times["resume"].append(time.perf_counter() - t)
            return out

    b1_before = C.launches
    mgr = TimedManager(ckpt_dir, keep_n=1, trust_domain=TrustDomain("tdx"))
    t0 = time.perf_counter()
    final, rlosses, restarts = run_with_restarts(
        state=state0, train_step=step, data_factory=data_factory,
        num_steps=TRAIN_STEPS, manager=mgr,
        checkpoint_every=TRAIN_CKPT_EVERY,
        injector=FailureInjector({TRAIN_FAIL_AT}))
    torch.cuda.synchronize()
    restart_s = time.perf_counter() - t0
    b1 = C.launches - b1_before
    kept = sorted(p.name for p in ckpt_dir.glob("step_*"))
    sealed_bytes = sum(e["n_bytes"] for e in json.loads(
        (ckpt_dir / kept[-1] / "manifest.json").read_text())["leaves"].values())
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(restarts == 1 and len(times["save"]) == 2
          and len(times["resume"]) == 1 and kept == [f"step_{TRAIN_STEPS}"],
          f"one restart, two sealed saves, one sealed restore, keep_n=1 "
          f"(restarts {restarts}, saves {len(times['save'])}, restores "
          f"{len(times['resume'])}, kept {kept})")
    check(rlosses == losses,
          f"the resumed run's losses equal the clean run's ({rlosses} vs "
          f"{losses})")
    for n, leaf in tree_leaves_with_names(final):
        check(fingerprint(torch, leaf) == prints[n],
              f"the resumed run's final {n} equals the clean run's "
              f"(fingerprint)")
    check(b1 > 0, "the sealed checkpoints launched the ChaCha20 kernel")
    del final, state0
    gc.collect()
    torch.cuda.empty_cache()

    # the launcher in a subprocess, on the card
    launch_dir = Path(__file__).resolve().parent / "build" / "train_launch"
    shutil.rmtree(launch_dir, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_LAUNCHER,
         "--ckpt-dir", str(launch_dir)], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(
            Path(__file__).resolve().parent / "src")))
    launch_s = time.perf_counter() - t0
    shutil.rmtree(launch_dir, ignore_errors=True)
    lines = proc.stdout.splitlines()
    check(proc.returncode == 0 and "restarts: 1" in lines,
          f"the launcher ran its failure drill on the card (rc "
          f"{proc.returncode}): {proc.stdout[-400:]} {proc.stderr[-800:]}")
    loss_line = [ln for ln in lines if ln.startswith("loss: ")]
    first, last = map(float, loss_line[0].removeprefix("loss: ").split(" -> "))
    check(np.isfinite(first) and last < first,
          f"the launcher's loss falls ({loss_line[0]})")
    launches = path_launches()
    check(launches["chacha20_xor_blocked"] == b1 and sum(
        launches.values()) == b1, f"B1 is the only kernel the training "
        f"path launched, all of it in the checkpoints: {launches}")
    return dict(launches=launches, losses=losses, step_ms=step_ms, med_ms=med_ms,
                tokens=TRAIN_BATCH * TRAIN_SEQ, n_params=n_params,
                model_flops=mflops, counted_flops=counted,
                share=mflops / (med_ms / 1e3) / PEAK_FLOPS,
                chunked=chunked, plain=plain, loss_mb1=loss_mb1,
                peak=peak, clean_s=clean_s, restart_s=restart_s,
                saves=times["save"], resumes=times["resume"],
                sealed_bytes=sealed_bytes, b1=b1, launch_s=launch_s,
                launcher=lines, path_s=time.perf_counter() - t_path)


# the sharded training path: the training path's Llama2-7B cut (2 of 32
# layers at full width, TRAIN_PARALLEL) with FSDP over data, as Llama2-70B's
# config sets it, on a dp=2 mesh of logical shards on the card; 16 x 1,024
# tokens a step in 8 microbatches of 2 rows, one row a shard
SHARD_MESH = (2, 1)
SHARD_BATCH, SHARD_SEQ = 16, 1024
SHARD_STEPS = 3
# a sealed checkpoint after step 2, and the run killed as step 2 starts;
# restored onto data=1, model=2 and resumed at step 2
SHARD_CKPT_AT = 2
ELASTIC_MESH = (1, 2)
# the mesh against one device on the same global batches, every step, and
# the resumed run against the uninterrupted one: the same rows in GEMMs of
# other row counts (1 row a shard against 2 a call), so bf16 rounding
# moves. Limits from the gaps measured on the H100 (PERF.md §6): a loss on
# the same state (the first step's, the resumed one) 9.5e-7 apart (one f32
# ulp at 11.76), limit 100x; a later step's loss, after updates whose bf16
# rounding differs, 6.9e-4 apart, limit 10x; each leaf's update over the
# run (params after the last step minus before the first) as |sharded -
# one device| / |one device's update| (Frobenius norms) at most 0.026,
# limit 10x. A step that drops the gradient all-reduce moves that gap to
# 0.85 and one that trains on half the batch the later losses by 1e-2
# (smoke llama2-7b in bf16 on the CPU)
SHARD_LOSS_TOL = 1e-4
SHARD_STEP_TOL = 7e-3
SHARD_UPDATE_TOL = 0.25
# the tensor-parallel training path: the same cut, batches and one-device
# run on model=2 and on data=2, model=2 logical shards, SHARD_STEPS steps
# each from the sharded path's initial state; the 2 x 2 state sealed and
# restored onto data=2, model=1. Limits set from the roundings before the
# first run (PERF.md §6): each half's bf16 partials are summed in bf16, so
# the forward is not one device's bits even at the first step: a logit
# moves by about 1 % of max |logit| (the bf16 tp=2 serving paths measured
# 0.62-0.99 %), which over 16,384 tokens moves the mean loss by about 5e-4
# (random and unbiased); after an update the bf16 rounding of the updates
# adds the dp path's 6.9e-4. So every loss is held within the dp path's
# later-step limit, 7e-3, the first too; each leaf's update within the dp
# path's 0.25 (its gap 0.026 came from bf16 gradients' sign noise, which
# the partial sums of the cotangents add to). The resumed step on data=1,
# model=2 below is tensor-parallel now and held to the same loss limit.
TP_TRAIN_MESHES = [(1, 2), (2, 2)]
TP_CKPT_MESH = (2, 1)
TP_LOSS_TOL = 7e-3
TP_UPDATE_TOL = SHARD_UPDATE_TOL
# two gloo ranks on the card: 1 of 32 layers at full width, 4 x 1,024
# tokens in 2 microbatches (one row a shard), 2 steps, on dp=2 and on tp=2
RANKS_TRAIN_SHAPES = [(2, 1), (1, 2)]
RANKS_TRAIN_LAYERS = 1
RANKS_TRAIN_BATCH = 4
RANKS_TRAIN_MICRO = 2
RANKS_TRAIN_STEPS = 2
# GPipe over a LocalGroup(4): one Llama2-7B block at full width a stage,
# f32, 6 microbatches of [1, 256] positions; output and gradient against
# the sequential stages run microbatch by microbatch, within the reference
# test's 1e-4 and 1e-3 (tests/test_distributed.py), relative to the
# largest entry here (widths of 4096, not 16)
GPIPE_STAGES, GPIPE_MICRO, GPIPE_SEQ = 4, 6, 256
GPIPE_TOL = (1e-4, 1e-3)
SHARD_LAUNCHER = ["--arch", "deepseek-7b", "--smoke", "--steps", "4",
                  "--tee", "tdx", "--fail-at", "2", "--ckpt-every", "2",
                  "--data-mesh", "2", "--model-mesh", "2"]


def train_step_bytes(cfg, dp: int, tp: int = 1, tokens: int = 0) -> int:
    """What one sharded step's collectives move into a shard on a dp x tp
    FSDP mesh, written down before the run: the gather over data of every
    weight matrix sharded over data (the tied embedding table and each
    layer's 4 attention and 3 FFN matrices; the norms stay whole), (dp - 1)
    / dp of the shard's model block of it, 1 / tp of the matrix (bf16
    here); the all-reduce over data of the f32 gradients of the shard's
    blocks, (dp - 1) x 4 B an element; and the loss with its two metrics,
    (dp - 1) x 12 B. On tp > 1, per a data shard's ``tokens`` a step (its
    rows x seq over the microbatches), (tp - 1) x: the embedding's
    reduction, each layer's two forward reductions, their rerun in remat's
    recompute and the two all-reduces of the normed rows' cotangents (bf16
    [tokens, d] each); the final rows' f32 cotangents ([tokens, d]) and the
    f32 logits' vocabulary gather ([tokens, vocab / tp]); and the norm's
    partial sums, 4 B for each of the 8 split leaves."""
    d, layers, vocab, ff = cfg.d_model, cfg.num_layers, cfg.vocab_size, \
        cfg.d_ff
    attn = 2 * d * cfg.head_dim_ * (cfg.num_heads + cfg.num_kv_heads)
    matrices = vocab * d + layers * (attn + 3 * d * ff)
    norms = layers * 2 * d + d
    width = {"bfloat16": 2, "float32": 4}[cfg.dtype]
    return (matrices // tp * width * (dp - 1) // dp
            + (dp - 1) * 4 * (matrices // tp + norms) + (dp - 1) * 12
            + (tp - 1) * (tokens * d * (width * (1 + 6 * layers) + 4)
                          + tokens * (vocab // tp) * 4 + 4 * 8))


def shard_data(cursor, batch, seq):
    """The packed batches from ``cursor`` on."""
    from repro_torch.data.pipeline import PackedLMDataset
    it = iter(PackedLMDataset(batch_size=batch, seq_len=seq, seed=0))
    for _ in range(cursor):
        next(it)
    return it


def timed_steps(torch, step, state, data, n: int, flops: bool = False):
    """``n`` steps of ``step`` from ``state`` on batches drawn from
    ``data``, CUDA events around each: (state, {"losses", "nbytes",
    "coll_s", "step_ms", "peak"}), the collectives' bytes and seconds (0
    for a one-device step) and the peak device memory since the first
    step; with ``flops`` also "flops", the first step's FlopCounterMode
    count (its time then holds the counter's host work: medians skip the
    first step). A caller that passes its only reference to ``state`` lets
    each step's old state go once the next exists."""
    from torch.utils.flop_counter import FlopCounterMode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, rec = [], {"losses": [], "nbytes": [], "coll_s": []}
    for i in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        counter = (FlopCounterMode(display=False) if flops and i == 0
                   else contextlib.nullcontext())
        e0.record()
        with counter:
            state, m = step(state, next(data))
        if flops and i == 0:
            rec["flops"] = counter.get_total_flops()
        e1.record()
        events.append((e0, e1))
        rec["losses"].append(float(m["loss"]))
        rec["nbytes"].append(m.get("collective_bytes", 0))
        rec["coll_s"].append(m.get("collective_s", 0.0))
    torch.cuda.synchronize()
    rec["peak"] = torch.cuda.max_memory_allocated()
    rec["step_ms"] = [a.elapsed_time(b) for a, b in events]
    return state, rec


GAP_CHUNK = 1 << 26


def update_gaps(torch, placed, after, before) -> dict:
    """{leaf: |placed - after| / |after - before|} (Frobenius norms), the
    placed params' update against one device's (``after`` and ``before``,
    on the card or the host): each leaf gathered whole, the norms summed in
    f32 a chunk of GAP_CHUNK elements at a time on the card."""
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.distributed import sharding
    gaps = {}
    for (n, p), (_, a), (_, b) in zip(tree_leaves_with_names(placed),
                                      tree_leaves_with_names(after),
                                      tree_leaves_with_names(before)):
        got = sharding.gather_leaf(p).reshape(-1)
        a, b = a.reshape(-1), b.reshape(-1)
        num = den = 0.0
        for i in range(0, got.numel(), GAP_CHUNK):
            g = got[i:i + GAP_CHUNK].float()
            w = a[i:i + GAP_CHUNK].to(g.device).float()
            w0 = b[i:i + GAP_CHUNK].to(g.device).float()
            num += float((g - w).square().sum())
            den += float((w - w0).square().sum())
        gaps[n] = (num / max(den, 1e-60)) ** 0.5
        del got
    return gaps


def tp_llama(torch, np, model, cfg, opt, batch, placed0, params0,
             params_one, losses_one) -> dict:
    """The tensor-parallel training path: Llama2-7B's training cut on each
    of TP_TRAIN_MESHES (logical shards), SHARD_STEPS steps from the sharded
    path's initial state on its global batches: every loss and each leaf's
    update against the one-device run's, CUDA events a step, the
    collective bytes a step against train_step_bytes with tp; then the
    last mesh's state sealed, restored onto TP_CKPT_MESH and every leaf
    checked bit-equal to the saved one. Returns {shape: record} and the
    checkpoint's record under "ckpt"."""
    from repro_torch.core import TrustDomain
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.distributed import sharding
    from repro_torch.kernels import chacha20 as C
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.train_loop import (abstract_train_state,
                                              make_sharded_train_step)

    def named_for(shape):
        mesh = make_host_mesh(*shape)
        sspecs = sharding.state_specs(cfg, abstract_train_state(model, opt),
                                      mesh)
        return mesh, sspecs, sharding.to_named(mesh, sspecs)

    out = {}
    for shape in TP_TRAIN_MESHES:
        mesh, sspecs, named = named_for(shape)
        step = make_sharded_train_step(
            model, opt, mesh, sspecs, sharding.batch_specs(cfg, batch, mesh),
            microbatches=cfg.parallel.microbatches)
        state, rec = timed_steps(torch, step, sharding.place(placed0, named),
                                 shard_data(0, SHARD_BATCH, SHARD_SEQ),
                                 SHARD_STEPS, flops=True)
        gaps = update_gaps(torch, state.params, params_one, params0)
        rec["worst"] = max(gaps, key=gaps.get)
        rec["update_gap"] = gaps[rec["worst"]]
        rec["loss_gaps"] = [abs(a - b) for a, b in zip(rec["losses"],
                                                       losses_one)]
        rec["expect_b"] = train_step_bytes(
            cfg, shape[0], shape[1], SHARD_BATCH * SHARD_SEQ // shape[0])
        rec["state_bytes"] = sharding.shard_nbytes(state, (0, 0))
        rec["med_ms"] = float(np.median(rec["step_ms"][1:]))
        label = f"data={shape[0]}, model={shape[1]}"
        check(all(np.isfinite(rec["losses"]))
              and max(rec["loss_gaps"]) <= TP_LOSS_TOL,
              f"the {label} losses {rec['losses']} are within "
              f"{TP_LOSS_TOL} of one device's {losses_one}")
        check(rec["update_gap"] <= TP_UPDATE_TOL,
              f"every leaf's update over {SHARD_STEPS} steps on {label} is "
              f"within {TP_UPDATE_TOL} of one device's, relative to its "
              f"norm (worst {rec['worst']}: {rec['update_gap']:.3g})")
        check(all(b == rec["expect_b"] for b in rec["nbytes"]),
              f"{rec['nbytes']} collective B a step on {label} == "
              f"train_step_bytes' {rec['expect_b']}")
        out[shape] = rec
        del step
        if shape != TP_TRAIN_MESHES[-1]:
            del state
        gc.collect()
        torch.cuda.empty_cache()

    # the last mesh's state sealed and restored onto TP_CKPT_MESH
    ckpt_dir = Path(__file__).resolve().parent / "build" / "tp_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(ckpt_dir, keep_n=1,
                            trust_domain=TrustDomain("tdx"))
    saved = {n: fingerprint(torch, sharding.gather_leaf(x))
             for n, x in tree_leaves_with_names(state)}
    b1_before = C.launches
    torch.cuda.synchronize()
    t = time.perf_counter()
    mgr.save(SHARD_STEPS, state)
    save_s = time.perf_counter() - t
    del state
    gc.collect()
    torch.cuda.empty_cache()
    _, _, named_b = named_for(TP_CKPT_MESH)
    torch.cuda.synchronize()
    t = time.perf_counter()
    at, restored = mgr.resume(abstract_train_state(model, opt),
                              shardings=named_b)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    b1 = C.launches - b1_before
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(at == SHARD_STEPS and sharding.placement(restored) == named_b,
          f"the tensor-parallel state restored at step {at} onto "
          f"data={TP_CKPT_MESH[0]}, model={TP_CKPT_MESH[1]}")
    for n, x in tree_leaves_with_names(restored):
        check(fingerprint(torch, sharding.gather_leaf(x)) == saved[n],
              f"the restored {n} equals the tensor-parallel state's "
              f"(fingerprint)")
    check(b1 > 0, "the tensor-parallel checkpoint launched the ChaCha20 "
          "kernel")
    del restored
    gc.collect()
    torch.cuda.empty_cache()
    out["ckpt"] = dict(save_s=save_s, resume_s=resume_s, b1=b1)
    return out


def block_prints(torch, tree, coords) -> dict:
    """{name: fingerprint} of the blocks the shard at ``coords`` holds."""
    from repro_torch.core.sealing import tree_leaves_with_names
    return {n: fingerprint(torch, leaf.shard(coords))
            for n, leaf in tree_leaves_with_names(tree)}


def ranks_train_config():
    import dataclasses
    return dataclasses.replace(train_config(
        fsdp=True, microbatches=RANKS_TRAIN_MICRO),
        num_layers=RANKS_TRAIN_LAYERS)


def ranks_train(torch, mesh, device):
    """RANKS_TRAIN_STEPS sharded steps of the ranks' cut over ``mesh``
    (logical shards, or the ranks of the world) under deterministic
    algorithms; (losses, gloo or device seconds a step, bytes a step,
    {coords: block fingerprints})."""
    from repro_torch.distributed import sharding
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import (abstract_train_state,
                                              init_train_state,
                                              make_sharded_train_step)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg = ranks_train_config()
        model = build_model(cfg, device=device)
        opt = AdamWConfig(**TRAIN_OPT,
                          moment_dtype=cfg.parallel.optimizer_dtype)
        sspecs = sharding.state_specs(cfg, abstract_train_state(model, opt),
                                      mesh)
        state = sharding.place(init_train_state(model, opt, seed=0),
                               sharding.to_named(mesh, sspecs))
        data = shard_data(0, RANKS_TRAIN_BATCH, TRAIN_SEQ)
        batch = next(data)
        step = make_sharded_train_step(
            model, opt, mesh, sspecs, sharding.batch_specs(cfg, batch, mesh),
            microbatches=cfg.parallel.microbatches)
        losses, secs, nbytes = [], [], []
        for i in range(RANKS_TRAIN_STEPS):
            state, m = step(state, batch if i == 0 else next(data))
            losses.append(float(m["loss"]))
            secs.append(m["collective_s"])
            nbytes.append(m["collective_bytes"])
        prints = {c: block_prints(torch, state, c)
                  for c in sharding.local_coords(mesh)}
        return losses, secs, nbytes, prints
    finally:
        torch.use_deterministic_algorithms(False)


def train_rank_worker(rank, world, init_file, out_dir):
    """One rank of the sharded training ranks path (spawned): join the
    gloo world, train the ranks' cut over each of RANKS_TRAIN_SHAPES
    spanning the ranks, and save each run's losses, gloo's seconds a step
    and the fingerprints of this rank's blocks."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=RANKS_TIMEOUT_S))
    try:
        from repro_torch.launch.mesh import make_host_mesh
        runs = {}
        for shape in RANKS_TRAIN_SHAPES:
            mesh = make_host_mesh(*shape, device="cuda")
            losses, secs, nbytes, prints = ranks_train(torch, mesh, "cuda")
            runs[shape] = dict(losses=losses, secs=secs, bytes=nbytes,
                               prints=prints, describe=mesh.describe())
        torch.save(dict(runs=runs, peak=torch.cuda.max_memory_allocated()),
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def gpipe_stage(torch, model):
    """One Llama2-7B block's training forward, (layer params, x) -> x."""
    impl = model._impl

    def stage(lp, x):
        pos = torch.arange(x.shape[1], device=x.device)[None, :].expand(
            x.shape[0], x.shape[1])
        y, _ = impl._layer_fwd("attn", "swiglu", lp["slot_0"], x, pos,
                               "train", None)
        return y

    return stage


def phase_gpipe(torch, np) -> dict:
    """make_gpipe over a LocalGroup(GPIPE_STAGES) on the card, one
    Llama2-7B block at full width a stage (f32), against the same stages
    run one after another on each microbatch alone: output and the
    gradient of mean(out ** 2) over every stage's params."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.sealing import tree_leaves_with_names, tree_map
    from repro_torch.distributed.collectives import LocalGroup
    from repro_torch.distributed.pipeline import make_gpipe
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("llama2-7b"),
                              num_layers=GPIPE_STAGES, dtype="float32")
    model = build_model(cfg)
    stacked = tree_map(lambda t: t.requires_grad_(),
                       model.init_params(seed=1)["layers"])
    leaves = [t for _, t in tree_leaves_with_names(stacked)]
    gen = torch.Generator(device="cuda").manual_seed(7)
    mb = torch.randn(GPIPE_MICRO, 1, GPIPE_SEQ, cfg.d_model, device="cuda",
                     generator=gen)
    stage = gpipe_stage(torch, model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = make_gpipe(LocalGroup(GPIPE_STAGES, "cuda"), stage)(stacked, mb)
    got = torch.autograd.grad((out ** 2).mean(), leaves)
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    refs = []
    for j in range(GPIPE_MICRO):
        x = mb[j]
        for i in range(GPIPE_STAGES):
            x = stage(tree_map(lambda t, i=i: t[i], stacked), x)
        refs.append(x)
    ref = torch.stack(refs)
    want = torch.autograd.grad((ref ** 2).mean(), leaves)
    out, ref = out.detach(), ref.detach()
    out_err = float((out - ref).abs().max()) / float(ref.abs().max())
    grad_err = max(float((g - w).abs().max()) / max(float(w.abs().max()),
                                                    1e-30)
                   for g, w in zip(got, want))
    check(bool(torch.isfinite(out).all()) and out_err <= GPIPE_TOL[0],
          f"GPipe's output within {GPIPE_TOL[0]} of the sequential stages' "
          f"(relative to the largest, {out_err:.3g})")
    check(grad_err <= GPIPE_TOL[1], f"GPipe's gradient within "
          f"{GPIPE_TOL[1]} of the sequential stages' ({grad_err:.3g})")
    return dict(out_err=out_err, grad_err=grad_err, pipe_s=pipe_s,
                bitwise=bool(torch.equal(out, ref)))


def phase_sharded_train(torch, np) -> dict:
    """The sharded training path, every kernel count set to 0 just before
    and read just after: Llama2-7B's training cut with FSDP on a dp=2 mesh
    of logical shards (every step's loss and each leaf's update against
    one device's on the same global batches, CUDA events a step, the collective bytes a step
    against train_step_bytes, each shard's state bytes); the same run
    through a sealed checkpoint and a FailureInjector kill, restored onto
    data=1, model=2 (each leaf bit-equal to the saved one) and resumed; two
    gloo ranks on the card against a logical dp=2 run of a 1-layer cut,
    block for block; GPipe over a LocalGroup(4); the launcher with a
    2 x 2 mesh in a subprocess."""
    import torch.multiprocessing as mp
    from repro_torch.core import TrustDomain
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.distributed import sharding
    from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                         SimulatedFailure,
                                                         run_with_restarts)
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import (abstract_train_state,
                                              init_train_state,
                                              make_sharded_train_step,
                                              make_train_step)

    reset_counts(C, P, Q, FA)
    t_path = time.perf_counter()
    cfg = train_config(fsdp=True)
    model = build_model(cfg)            # the card
    opt = AdamWConfig(**TRAIN_OPT, moment_dtype=cfg.parallel.optimizer_dtype)
    mb = cfg.parallel.microbatches
    batch = next(shard_data(0, SHARD_BATCH, SHARD_SEQ))

    # one device on the same global batches (comparison only): each step's
    # loss, and its params after the last step; the first step's FLOPs
    from torch.utils.flop_counter import FlopCounterMode
    state0 = init_train_state(model, opt, seed=0)
    one_step = make_train_step(model, opt, microbatches=mb)
    one, losses_one = state0, []
    data = shard_data(0, SHARD_BATCH, SHARD_SEQ)
    for i in range(SHARD_STEPS):
        with FlopCounterMode(display=False) if i == 0 else \
                contextlib.nullcontext() as fc:
            one, m1 = one_step(one, next(data))
        losses_one.append(float(m1["loss"]))
        if i == 0:
            one_flops = fc.get_total_flops()
    params0, params_one = state0.params, one.params
    del one, m1, one_step

    def build(shape):
        mesh = make_host_mesh(*shape)
        sspecs = sharding.state_specs(cfg, abstract_train_state(model, opt),
                                      mesh)
        step = make_sharded_train_step(
            model, opt, mesh, sspecs, sharding.batch_specs(cfg, batch, mesh),
            microbatches=mb)
        return mesh, sspecs, sharding.to_named(mesh, sspecs), step

    # the dry run's 1 x 1 cell (comparison only): one sharded step on a
    # 1 x 1 mesh, its FLOPs and its peak device memory with its state
    _, _, named_1, step_1 = build((1, 1))
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    placed_1 = sharding.place(state0, named_1)
    with FlopCounterMode(display=False) as fc:
        out_1 = step_1(placed_1, batch)
        float(out_1[1]["loss"])
    flops_1 = fc.get_total_flops()
    torch.cuda.synchronize()
    peak_1 = torch.cuda.max_memory_allocated() - before
    del placed_1, out_1, step_1
    gc.collect()
    torch.cuda.empty_cache()

    mesh_a, _, named_a, step_a = build(SHARD_MESH)
    placed0 = sharding.place(state0, named_a)
    del state0
    gc.collect()
    torch.cuda.empty_cache()
    state_bytes = [sharding.shard_nbytes(placed0, (d, 0))
                   for d in range(SHARD_MESH[0])]
    expect_b = train_step_bytes(cfg, SHARD_MESH[0])

    # the uninterrupted run
    state, rec = timed_steps(torch, step_a, placed0,
                             shard_data(0, SHARD_BATCH, SHARD_SEQ),
                             SHARD_STEPS)
    losses, nbytes, coll_s = rec["losses"], rec["nbytes"], rec["coll_s"]
    peak, step_ms = rec["peak"], rec["step_ms"]
    gaps = update_gaps(torch, state.params, params_one, params0)
    worst = max(gaps, key=gaps.get)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # the tensor-parallel training path on the same batches
    tp = tp_llama(torch, np, model, cfg, opt, batch, placed0, params0,
                  params_one, losses_one)
    del params0, params_one
    gc.collect()
    torch.cuda.empty_cache()
    loss_gaps = [abs(a - b) for a, b in zip(losses, losses_one)]
    check(all(np.isfinite(losses)), f"the sharded losses are finite "
          f"({losses})")
    check(loss_gaps[0] <= SHARD_LOSS_TOL
          and max(loss_gaps[1:]) <= SHARD_STEP_TOL,
          f"the dp=2 losses {losses} are within {SHARD_LOSS_TOL} of one "
          f"device's {losses_one} at the first step and {SHARD_STEP_TOL} "
          f"after it")
    check(gaps[worst] <= SHARD_UPDATE_TOL,
          f"every leaf's update over {SHARD_STEPS} steps is within "
          f"{SHARD_UPDATE_TOL} of one device's, relative to its norm "
          f"(worst {worst}: {gaps[worst]:.3g})")
    check(all(b == expect_b for b in nbytes),
          f"{nbytes} collective B a step == train_step_bytes' {expect_b}")

    # the same run through a sealed checkpoint and a kill, resumed on
    # data=1, model=2
    ckpt_dir = Path(__file__).resolve().parent / "build" / "shard_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    saved, times = {}, {"save": [], "resume": []}

    class TimedManager(CheckpointManager):
        def save(self, s, tree):
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = super().save(s, tree)
            times["save"].append(time.perf_counter() - t)
            saved.update({n: fingerprint(torch, sharding.gather_leaf(x))
                          for n, x in tree_leaves_with_names(tree)})
            return path

    mgr = TimedManager(ckpt_dir, keep_n=1, trust_domain=TrustDomain("tdx"))
    b1_before = C.launches
    killed = False
    try:
        run_with_restarts(state=placed0, train_step=step_a,
                          data_factory=lambda c: shard_data(
                              c, SHARD_BATCH, SHARD_SEQ),
                          num_steps=SHARD_STEPS, manager=mgr,
                          checkpoint_every=SHARD_CKPT_AT,
                          injector=FailureInjector({SHARD_CKPT_AT}),
                          max_restarts=0)
    except SimulatedFailure:
        killed = True
    check(killed and len(times["save"]) == 1,
          "the run was killed at step 2 after one sealed save")
    del placed0
    gc.collect()
    torch.cuda.empty_cache()
    mesh_b, _, named_b, step_b = build(ELASTIC_MESH)
    torch.cuda.synchronize()
    t = time.perf_counter()
    at, restored = mgr.resume(abstract_train_state(model, opt),
                              shardings=named_b)
    torch.cuda.synchronize()
    times["resume"].append(time.perf_counter() - t)
    b1 = C.launches - b1_before
    sealed_bytes = sum(e["n_bytes"] for e in json.loads(
        (ckpt_dir / f"step_{at}" / "manifest.json").read_text()
    )["leaves"].values())
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(at == SHARD_CKPT_AT and sharding.placement(restored) == named_b,
          f"restored step {at} onto the data=1, model=2 shards")
    for n, x in tree_leaves_with_names(restored):
        check(fingerprint(torch, sharding.gather_leaf(x)) == saved[n],
              f"the restored {n} equals the saved one (fingerprint)")
    _, m = step_b(restored, next(shard_data(at, SHARD_BATCH, SHARD_SEQ)))
    resumed_loss = float(m["loss"])
    check(abs(resumed_loss - losses[at]) <= TP_LOSS_TOL,
          f"the resumed (tensor-parallel) loss at step {at} on data=1, "
          f"model=2 ({resumed_loss:.6f}) is within {TP_LOSS_TOL} of the "
          f"uninterrupted run's ({losses[at]:.6f})")
    check(b1 > 0, "the sealed save and restore launched the ChaCha20 kernel")
    del restored, m, step_a, step_b
    gc.collect()
    torch.cuda.empty_cache()
    launches = path_launches()

    # two gloo ranks on the card against logical shards
    t0 = time.perf_counter()
    want = {}
    for shape in RANKS_TRAIN_SHAPES:
        want[shape] = ranks_train(torch, make_host_mesh(*shape), "cuda")
        gc.collect()
        torch.cuda.empty_cache()
    work = Path(__file__).resolve().parent / "build" / "train_ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    mp.spawn(train_rank_worker, nprocs=RANKS, join=True,
             args=(RANKS, str(work / "init"), str(work)))
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(RANKS)]
    shutil.rmtree(work, ignore_errors=True)
    ranks_s = time.perf_counter() - t0
    for r, got in enumerate(ranks):
        for shape, w in want.items():
            g, label = got["runs"][shape], f"data={shape[0]}, model={shape[1]}"
            coords = (r // shape[1], r % shape[1])
            check(g["losses"] == w[0], f"rank {r}'s losses on {label} equal "
                  f"the logical run's ({g['losses']} vs {w[0]})")
            check(g["prints"][coords] == w[3][coords],
                  f"rank {r}'s updated state blocks on {label} equal the "
                  f"logical run's")
            check(g["bytes"] == w[2], f"rank {r}'s collective bytes on "
                  f"{label} equal the logical run's")

    gp = phase_gpipe(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    launches_after = path_launches()
    check(launches_after == launches,
          f"no kernel ran on the ranks and GPipe (in this process): "
          f"{launches_after}")

    # the launcher on a 2 x 2 mesh of logical shards, on the card
    launch_dir = Path(__file__).resolve().parent / "build" / "shard_launch"
    shutil.rmtree(launch_dir, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *SHARD_LAUNCHER,
         "--ckpt-dir", str(launch_dir)], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(
            Path(__file__).resolve().parent / "src")))
    launch_s = time.perf_counter() - t0
    shutil.rmtree(launch_dir, ignore_errors=True)
    lines = proc.stdout.splitlines()
    check(proc.returncode == 0 and lines[:1] == [
        "mesh: {'data': 2, 'model': 2}"] and "restarts: 1" in lines,
        f"the launcher ran its failure drill on a 2 x 2 mesh (rc "
        f"{proc.returncode}): {proc.stdout[-400:]} {proc.stderr[-800:]}")
    ckpt_b1 = b1 + tp["ckpt"]["b1"]
    check(launches["chacha20_xor_blocked"] == ckpt_b1 and sum(
        launches.values()) == ckpt_b1, f"B1 is the only kernel the sharded "
        f"training path launched, all of it in the checkpoints: {launches}")
    med_ms = float(np.median(step_ms[1:]))
    return dict(launches=launches, losses=losses, losses_one=losses_one,
                loss_gaps=loss_gaps, update_gap=gaps[worst],
                update_worst=worst,
                step_ms=step_ms, med_ms=med_ms,
                tokens=SHARD_BATCH * SHARD_SEQ, nbytes=nbytes,
                expect_b=expect_b, coll_ms=[s * 1e3 for s in coll_s],
                state_bytes=state_bytes, peak=peak, save_s=times["save"],
                resume_s=times["resume"], sealed_bytes=sealed_bytes, b1=b1,
                resumed_loss=resumed_loss, at=at, ranks=ranks,
                ranks_want=want, ranks_s=ranks_s, gpipe=gp, tp=tp,
                launch_s=launch_s, launcher=lines, one_flops=one_flops,
                flops_1=flops_1, peak_1=peak_1,
                path_s=time.perf_counter() - t_path)


def print_sharded(r, smi) -> None:
    card = f"[{smi}]"
    print(f"  sharded path, dp={SHARD_MESH[0]} logical shards (FSDP): "
          f"losses {', '.join(f'{x:.6f}' for x in r['losses'])} vs one "
          f"device's {', '.join(f'{x:.6f}' for x in r['losses_one'])} "
          f"(gaps {', '.join(f'{x:.3g}' for x in r['loss_gaps'])}, limits "
          f"{SHARD_LOSS_TOL} at the first step, {SHARD_STEP_TOL} after); "
          f"each leaf's update over {SHARD_STEPS} steps "
          f"within {r['update_gap']:.3g} of one device's, relative to its "
          f"norm (worst {r['update_worst']}, limit {SHARD_UPDATE_TOL})")
    print(f"    step (CUDA events, median of steps 2-{SHARD_STEPS}) "
          f"{r['med_ms']:.2f} ms ({', '.join(f'{x:.2f}' for x in r['step_ms'])}"
          f" ms), {r['tokens'] / (r['med_ms'] / 1e3):.0f} tokens/s; "
          f"collectives {r['nbytes'][-1]} B a step (train_step_bytes "
          f"{r['expect_b']} B), "
          + ", ".join(f"{x:.2f}" for x in r["coll_ms"])
          + f" ms a step (CUDA events: copies and sums in HBM, one card, no "
            f"link); state bytes a shard {r['state_bytes']}; peak device "
            f"memory {r['peak']} B {card}")
    print(f"    elastic resume: sealed checkpoint {r['sealed_bytes']} B "
          f"saved on data=2, model=1 in "
          f"{', '.join(f'{x:.2f}' for x in r['save_s'])} s, killed at step "
          f"{r['at']}, restored onto data=1, model=2 in "
          f"{', '.join(f'{x:.2f}' for x in r['resume_s'])} s (every leaf "
          f"bit-equal); B1 launches {r['b1']}; the resumed loss "
          f"{r['resumed_loss']:.6f} vs the uninterrupted "
          f"{r['losses'][r['at']]:.6f} {card}")
    for shape in TP_TRAIN_MESHES:
        t = r["tp"][shape]
        med = t["med_ms"]
        print(f"    tensor-parallel training, data={shape[0]}, "
              f"model={shape[1]} logical shards: losses "
              f"{', '.join(f'{x:.6f}' for x in t['losses'])} (gaps "
              f"{', '.join(f'{x:.3g}' for x in t['loss_gaps'])} to one "
              f"device's, limit {TP_LOSS_TOL}); each leaf's update within "
              f"{t['update_gap']:.3g} of one device's (worst {t['worst']}, "
              f"limit {TP_UPDATE_TOL}); step (CUDA events, median of steps "
              f"2-{SHARD_STEPS}) {med:.2f} ms ("
              + ", ".join(f"{x:.2f}" for x in t["step_ms"])
              + f" ms), {r['tokens'] / (med / 1e3):.0f} tokens/s; "
                f"collectives {t['nbytes'][-1]} B a step (train_step_bytes "
                f"{t['expect_b']} B), "
              + ", ".join(f"{x * 1e3:.2f}" for x in t["coll_s"])
              + f" ms a step (CUDA events: copies and sums in HBM, one "
                f"card, no link); state bytes of shard (0, 0) "
                f"{t['state_bytes']}; peak device memory {t['peak']} B "
                f"{card}")
    ck = r["tp"]["ckpt"]
    print(f"    the data={TP_TRAIN_MESHES[-1][0]}, "
          f"model={TP_TRAIN_MESHES[-1][1]} state sealed in "
          f"{ck['save_s']:.2f} s and restored onto data={TP_CKPT_MESH[0]}, "
          f"model={TP_CKPT_MESH[1]} in {ck['resume_s']:.2f} s, every leaf "
          f"bit-equal; B1 launches {ck['b1']} {card}")
    for shape in RANKS_TRAIN_SHAPES:
        g0, w = r["ranks"][0]["runs"][shape], r["ranks_want"][shape]
        print(f"    ranks on data={shape[0]}, model={shape[1]}: {RANKS} "
              f"gloo processes on the card ({g0['describe']}), "
              f"{RANKS_TRAIN_LAYERS} layer at full width, "
              f"{RANKS_TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
              f"{RANKS_TRAIN_STEPS} steps: losses {w[0]} and every block "
              f"equal to the logical run's; {g0['bytes'][-1]} collective B "
              f"a step; gloo seconds a step (host clock, through host "
              f"memory) "
              + "; ".join(f"rank {i} " + ", ".join(
                  f"{x:.3f}" for x in got["runs"][shape]["secs"])
                  for i, got in enumerate(r["ranks"]))
              + f"; logical run's device seconds "
              + ", ".join(f"{x:.3f}" for x in w[1]) + f" {card}")
    print(f"    ranks: {r['ranks_s']:.1f} s with the spawn {card}")
    gp = r["gpipe"]
    print(f"    GPipe over a LocalGroup({GPIPE_STAGES}), one Llama2-7B block "
          f"a stage (f32), {GPIPE_MICRO} microbatches of [1, {GPIPE_SEQ}]: "
          f"output within {gp['out_err']:.3g} (bit-equal: {gp['bitwise']}), "
          f"gradient within {gp['grad_err']:.3g} of the sequential stages "
          f"(relative to the largest); forward and backward "
          f"{gp['pipe_s']:.2f} s {card}")
    print(f"    launcher subprocess {r['launch_s']:.2f} s "
          f"({'; '.join(r['launcher'])}); the path {r['path_s']:.2f} s; "
          f"launches {r['launches']} {card}")


# the tensor-parallel training of the other families, each against one
# device on the same batches from the same seed-0 state, the one device's
# params before and after kept on the host. dbrx at published width, 1 of
# 40 layers: 3.88 G params, so bf16 params (7.75 GB), their bf16 gradients
# and the functional update's new params and moments beside the old fit
# the card only with bf16 moments (the config's optimizer_dtype knob; f32
# moments would take 31 GB a copy); on data=2, model=2 with the batch split
# over data at capacity factor 1.0, 4 x 512 tokens a step (2 rows a data
# shard), so an expert's queue overflows and each MoE layer routes the
# global batch. whisper-small at full size (12 + 12 layers) on model=2, 2
# rows of 1,500 frames and 448 target tokens, in bf16 and, as a witness,
# in f32 (where the two runs differ only by the f32 sums' order).
TP_DBRX_LAYERS = 1
TP_DBRX_MESH = (2, 2)
TP_DBRX_BATCH, TP_DBRX_SEQ = 4, 512
TP_DBRX_CAPACITY = 1.0
TP_WHISPER_MESH = (1, 2)
TP_WHISPER_BATCH = 2
TP_FAMILY_STEPS = 2
TP_FAMILY_OPT = dict(lr=3e-5, warmup_steps=1, total_steps=TP_FAMILY_STEPS)
# Limits set from the roundings before the first run (PERF.md §6). dbrx:
# besides the bf16 partial sums (the Llama path's 7e-3), the router's f32
# logits come from rows that differ in bf16 rounding, so a few of 2,048
# tokens whose 4th and 5th expert scores lie within that rounding pick
# another expert; each moves its expert's queue by one at the capacity
# edge, changing about 1-3 tokens' kept pairs and their CE by about 0.2:
# ~30 tokens move the mean loss by ~3e-3. Limit 2e-2 for the loss, 0.5 for
# each leaf's update (an expert's gradient loses or gains a few of its 512
# kept tokens). whisper in bf16: 24 layers of bf16 partial sums, so the
# Llama loss limit x about 3, 2e-2; a leaf's update gap is 2 x the square
# root of the share of its elements whose bf16 gradient changes sign, and
# a small leaf whose gradient sits near bf16 noise (a smoke rehearsal on
# the CPU measured 0.236 on enc_final_norm's bias) can take much of 0.5,
# so 1.0 (a third of the elements flipped), the f32 witness carrying the
# tight check. whisper in f32: the sums' order alone (the CPU tests' 1e-4
# and 1e-2).
TP_DBRX_LOSS_TOL, TP_DBRX_UPDATE_TOL = 2e-2, 0.5
TP_WHISPER_LOSS_TOL, TP_WHISPER_UPDATE_TOL = 2e-2, 1.0
TP_F32_LOSS_TOL, TP_F32_UPDATE_TOL = 1e-4, 1e-2


def tp_against_one(torch, np, cfg, shape, batches) -> dict:
    """``cfg``'s model trained on the card for len(``batches``) steps on
    one device and on a logical ``shape`` mesh from the same seed-0 state,
    the one device's params before and after kept on the host: the
    losses, each leaf's update gap (:func:`update_gaps`), CUDA events a
    step, the collective bytes and the peak device memory of each run."""
    from repro_torch.core.sealing import tree_map
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import (abstract_train_state,
                                              init_train_state,
                                              make_sharded_train_step,
                                              make_train_step)
    model = build_model(cfg)
    opt = AdamWConfig(**TP_FAMILY_OPT,
                      moment_dtype=cfg.parallel.optimizer_dtype)
    # timed_steps gets the only reference to a state, so a step's old
    # state is freed once the next one exists (three bf16 dbrx states do
    # not fit the card)
    held = [init_train_state(model, opt, seed=0)]
    params0 = tree_map(lambda t: t.cpu(), held[0].params)
    state, one = timed_steps(torch, make_train_step(model, opt), held.pop(),
                             iter(batches), len(batches))
    params_one = tree_map(lambda t: t.cpu(), state.params)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_host_mesh(*shape)
    sspecs = sharding.state_specs(cfg, abstract_train_state(model, opt), mesh)
    step = make_sharded_train_step(model, opt, mesh, sspecs,
                                   sharding.batch_specs(cfg, batches[0], mesh))
    placed, rec = timed_steps(
        torch, step, sharding.place(init_train_state(model, opt, seed=0),
                                    sharding.to_named(mesh, sspecs)),
        iter(batches), len(batches))
    gaps = update_gaps(torch, placed.params, params_one, params0)
    del placed, step, params0, params_one
    gc.collect()
    torch.cuda.empty_cache()
    rec["worst"] = max(gaps, key=gaps.get)
    rec.update(update_gap=gaps[rec["worst"]], one=one,
               loss_gaps=[abs(a - b) for a, b in zip(rec["losses"],
                                                      one["losses"])])
    return rec


def phase_tp_train(torch, np) -> dict:
    """The other families' tensor-parallel training, every kernel count set
    to 0 just before and read just after: dbrx's cut on data=2, model=2
    with the split batch at capacity factor 1.0, and whisper-small on
    model=2 in bf16 and in f32, each against one device on the same
    batches (:func:`tp_against_one`), within the limits above. No kernel
    runs here (nothing is sealed)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q

    reset_counts(C, P, Q, FA)
    t_path = time.perf_counter()
    out = {}
    cfg = get_config("dbrx-132b")
    cfg = dataclasses.replace(
        cfg, num_layers=TP_DBRX_LAYERS,
        moe=dataclasses.replace(cfg.moe, capacity_factor=TP_DBRX_CAPACITY),
        parallel=dataclasses.replace(cfg.parallel,
                                     optimizer_dtype="bfloat16"))
    gen = torch.Generator(device="cuda").manual_seed(11)
    batches = [{k: torch.randint(lo, cfg.vocab_size,
                                 (TP_DBRX_BATCH, TP_DBRX_SEQ), device="cuda",
                                 generator=gen, dtype=torch.int32)
                for k, lo in (("tokens", 0), ("labels", -1))}
               for _ in range(TP_FAMILY_STEPS)]
    runs = [("dbrx-132b", cfg, TP_DBRX_MESH, batches, TP_DBRX_LOSS_TOL,
             TP_DBRX_UPDATE_TOL)]
    wcfg = get_config("whisper-small")
    for dtype, tols in (("bfloat16", (TP_WHISPER_LOSS_TOL,
                                      TP_WHISPER_UPDATE_TOL)),
                        ("float32", (TP_F32_LOSS_TOL, TP_F32_UPDATE_TOL))):
        c = dataclasses.replace(wcfg, dtype=dtype)
        wb = [{"frames": torch.randn(
                   TP_WHISPER_BATCH, WHISPER_FRAMES, c.d_model,
                   device="cuda", generator=gen).to(c.torch_dtype),
               **{k: torch.randint(lo, c.vocab_size,
                                   (TP_WHISPER_BATCH, c.max_target_len),
                                   device="cuda", generator=gen,
                                   dtype=torch.int32)
                  for k, lo in (("tokens", 0), ("labels", -1))}}
              for _ in range(TP_FAMILY_STEPS)]
        runs.append((f"whisper-small {dtype}", c, TP_WHISPER_MESH, wb,
                     *tols))
    for name, c, shape, b, loss_tol, update_tol in runs:
        r = tp_against_one(torch, np, c, shape, b)
        label = f"{name} on data={shape[0]}, model={shape[1]}"
        check(all(np.isfinite(r["losses"]))
              and max(r["loss_gaps"]) <= loss_tol,
              f"the {label} losses {r['losses']} are within {loss_tol} of "
              f"one device's {r['one']['losses']}")
        check(r["update_gap"] <= update_tol,
              f"every leaf's update on {label} is within {update_tol} of "
              f"one device's, relative to its norm (worst {r['worst']}: "
              f"{r['update_gap']:.3g})")
        check(all(x > 0 for x in r["nbytes"]), f"the {label} step's "
              f"collectives moved bytes ({r['nbytes']})")
        r.update(shape=shape, loss_tol=loss_tol, update_tol=update_tol,
                 params=c.params_count()[0])
        out[name] = r
    launches = path_launches()
    check(sum(launches.values()) == 0,
          f"no kernel ran on the families' tensor-parallel training: "
          f"{launches}")
    return dict(runs=out, launches=launches,
                path_s=time.perf_counter() - t_path)


def print_tp_train(r, smi) -> None:
    card = f"[{smi}]"
    for name, t in r["runs"].items():
        one = t["one"]
        print(f"  tensor-parallel training, {name} ({t['params']} params) on "
              f"data={t['shape'][0]}, model={t['shape'][1]} logical shards: "
              f"losses {', '.join(f'{x:.6f}' for x in t['losses'])} vs one "
              f"device's {', '.join(f'{x:.6f}' for x in one['losses'])} "
              f"(gaps {', '.join(f'{x:.3g}' for x in t['loss_gaps'])}, limit "
              f"{t['loss_tol']}); each leaf's update within "
              f"{t['update_gap']:.3g} of one device's (worst {t['worst']}, "
              f"limit {t['update_tol']}); step (CUDA events) "
              + ", ".join(f"{x:.2f}" for x in t["step_ms"])
              + " ms vs one device's "
              + ", ".join(f"{x:.2f}" for x in one["step_ms"])
              + f" ms; collectives {t['nbytes'][-1]} B a step, "
              + ", ".join(f"{x * 1e3:.2f}" for x in t["coll_s"])
              + f" ms a step; peak device memory {t['peak']} B (one device "
                f"{one['peak']} B) {card}")
    print(f"    the path {r['path_s']:.2f} s; launches {r['launches']} "
          f"{card}")


# the dry run (launch/dryrun.py) held to runs the card makes. Its
# lowerings run in a subprocess started before the training phases, on the
# card's own torch, while those phases use the card: fake tensors name
# cuda and nothing is allocated (indexing a fake CUDA tensor takes a device
# guard, so the subprocess holds a CUDA context and no tensor). The
# training cut
# of phase_sharded_train (FSDP, SHARD_BATCH x SHARD_SEQ tokens, 8
# microbatches) on each of DRY_TRAIN_MESHES, the TP path's tp=2 slot
# decode step (ENGINE_KW's rows and cache), and DRY_CELLS at production
# size. Written down before the first run (PERF.md §6): the collective
# bytes equal train_step_bytes / tp_step_bytes and the bytes the real runs
# counted, exactly; the FLOPs x n_chips equal the real logical-shard
# step's FlopCounterMode count (on 1 x 1 the sharded step on a 1 x 1 mesh),
# exactly, and on 1 x 1 also the one-device step's plus the one op the two
# programs differ by (the sharded loss runs remat's recompute with early
# stop off, so each layer's FFN down projection is recomputed, 2 x tokens
# x d_ff x d a layer); the 1 x 1 footprint (argument + temporary + output
# bytes) within DRY_MEM_TOL of that 1 x 1 step's max_memory_allocated with
# its placed state, less what was allocated before it (the same program;
# the card adds the allocator's 512 B rounding and cuBLAS's workspace)
DRY_TRAIN_MESHES = [(1, 1), (1, 2), (2, 2)]
DRY_MEM_TOL = 0.05
DRY_CELLS = [("deepseek-7b", "train_4k", False),
             ("deepseek-7b", "prefill_32k", False),
             ("deepseek-7b", "decode_32k", False),
             ("deepseek-7b", "decode_32k", True)]
DRY_TIMEOUT_S = 900


def dryrun_worker(out_path: str) -> int:
    """The dry lowerings phase_dryrun checks (run as ``chip_smoke.py
    --dryrun-worker OUT``; fake tensors, nothing on the card): a JSON
    record of each, with its host seconds."""
    import dataclasses
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_dry_mesh

    t0 = time.perf_counter()
    out = {"torch": torch.__version__, "train": {}, "cells": []}
    cfg = train_config(fsdp=True)
    shape = ShapeConfig("train", SHARD_SEQ, SHARD_BATCH, "train")
    for dp, tp in DRY_TRAIN_MESHES:
        low = D.lower_step(cfg, shape, make_dry_mesh({"data": dp,
                                                      "model": tp}))
        out["train"][f"{dp}x{tp}"] = dataclasses.asdict(low)
    serve = ShapeConfig("decode", ENGINE_KW["max_len"],
                        ENGINE_KW["max_slots"], "decode")
    low = D.lower_step(get_config("llama2-7b"), serve,
                       make_dry_mesh({"data": 1, "model": 2}))
    out["serve"] = dataclasses.asdict(low)
    for arch, shape_name, multi_pod in DRY_CELLS:
        t = time.perf_counter()
        rec = D.lower_cell(arch, shape_name, multi_pod=multi_pod,
                           verbose=False).to_dict()
        rec["compile_s"] = time.perf_counter() - t
        out["cells"].append(rec)
    out["seconds"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(out))
    return 0


def start_dryrun():
    """The dry run's subprocess and its output path."""
    out = Path(__file__).resolve().parent / "build" / "dryrun_phase.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--dryrun-worker", str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, out, time.perf_counter()


def phase_dryrun(torch, proc, out_path, started, sh_tr, sv) -> dict:
    """Wait for the dry run's subprocess and hold its records to the runs
    the card made: the training cut on DRY_TRAIN_MESHES (bytes, FLOPs, the
    1 x 1 footprint), the tp=2 decode step's bytes, the production
    cells' terms."""
    try:
        stdout, stderr = proc.communicate(timeout=DRY_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"the dry run took over {DRY_TIMEOUT_S}s")
    waited = time.perf_counter()
    check(proc.returncode == 0 and out_path.exists(),
          f"the dry run's subprocess ran (rc {proc.returncode}): "
          f"{stdout[-400:]} {stderr[-1600:]}")
    rec = json.loads(out_path.read_text())
    cfg = train_config(fsdp=True)
    tokens = SHARD_BATCH * SHARD_SEQ
    measured = {(1, 1): dict(nbytes=0, flops=sh_tr["flops_1"])}
    recompute = 2 * tokens * cfg.d_ff * cfg.d_model * cfg.num_layers
    check(sh_tr["flops_1"] == sh_tr["one_flops"] + recompute,
          f"the 1 x 1 sharded step's FLOPs ({sh_tr['flops_1']:.6g}) are the "
          f"one-device step's ({sh_tr['one_flops']:.6g}) plus the FFN down "
          f"projections remat recomputes with early stop off "
          f"({recompute:.6g})")
    for shape in TP_TRAIN_MESHES:
        t = sh_tr["tp"][shape]
        measured[shape] = dict(nbytes=t["nbytes"][0], flops=t["flops"])
    train = {}
    for (dp, tp), want in measured.items():
        low = rec["train"][f"{dp}x{tp}"]
        coll = sum(low["collectives"].values())
        expect = train_step_bytes(cfg, dp, tp, tokens // dp)
        check(coll == expect == want["nbytes"],
              f"the dry run's {coll:.0f} collective B a step on {dp} x {tp} "
              f"== train_step_bytes' {expect} == the real run's "
              f"{want['nbytes']}")
        check(low["flops"] * dp * tp == want["flops"],
              f"the dry run's FLOPs x {dp * tp} on {dp} x {tp} "
              f"({low['flops'] * dp * tp:.6g}) == the real step's "
              f"FlopCounterMode count ({want['flops']:.6g})")
        train[dp, tp] = dict(low, coll=coll, expect=expect,
                             measured_b=want["nbytes"],
                             measured_f=want["flops"])
    one = rec["train"]["1x1"]
    hbm = one["arg_bytes"] + one["temp_bytes"] + one["out_bytes"]
    gap = abs(hbm - sh_tr["peak_1"]) / sh_tr["peak_1"]
    check(gap <= DRY_MEM_TOL,
          f"the dry run's 1 x 1 footprint {hbm} B is within {DRY_MEM_TOL} "
          f"of the 1 x 1 step's peak with its state {sh_tr['peak_1']} B "
          f"({gap:.4f})")
    serve = rec["serve"]
    coll = sum(serve["collectives"].values())
    from repro_torch.configs import get_config
    want = sv["tp"]["slot"]["per_step"]
    expect = tp_step_bytes(get_config("llama2-7b"), ENGINE_KW["max_slots"], 2)
    check(coll == expect == want,
          f"the dry run's tp=2 decode step moves {coll:.0f} B == "
          f"tp_step_bytes' {expect} == the TP path's {want}")
    for c in rec["cells"]:
        check(c["n_chips"] == (512 if c["mesh"] == "2x16x16" else 256)
              and c["compute_s"] > 0 and c["memory_s"] > 0
              and c["collective_s"] > 0,
              f"the production cell {c['arch']} x {c['shape']} x "
              f"{c['mesh']} lowered with every term positive")
    return dict(rec=rec, train=train, hbm=hbm, mem_gap=gap, serve_b=coll,
                peak_1=sh_tr["peak_1"], one_flops=sh_tr["one_flops"],
                serve_expect=expect, waited=waited - started,
                wait_s=time.perf_counter() - waited)


def print_dryrun(r, smi) -> None:
    card = f"[{smi}]"
    rec = r["rec"]
    for (dp, tp), t in r["train"].items():
        print(f"  dry run, training cut on {dp} x {tp} (one fake rank, "
              f"torch {rec['torch']}, {t['seconds']:.1f}s host): "
              f"{t['coll']:.0f} collective B == train_step_bytes "
              f"{t['expect']} == measured {t['measured_b']}; FLOPs x "
              f"{dp * tp} {t['flops'] * dp * tp:.6g} == measured "
              f"{t['measured_f']:.6g}"
              + (f" (a 1 x 1 sharded step; the one-device step's "
                 f"{r['one_flops']:.6g} plus the FFN down projections "
                 f"remat recomputes)" if (dp, tp) == (1, 1) else "")
              + f"; footprint args {t['arg_bytes']} + temp "
                f"{t['temp_bytes']} + out {t['out_bytes']} B")
    print(f"  dry run, 1 x 1 footprint {r['hbm']} B vs the 1 x 1 step's "
          f"peak device memory with its state {r['peak_1']} B: "
          f"{r['mem_gap']:.4f} apart (limit {DRY_MEM_TOL}) {card}")
    print(f"  dry run, tp=2 slot decode step: {r['serve_b']:.0f} collective "
          f"B == tp_step_bytes {r['serve_expect']} == the TP path's")
    results = Path(__file__).resolve().parent / "results"
    for c in rec["cells"]:
        print("  dry run cell " + json.dumps(c))
        name = ("torch_dryrun_multi_pod.json" if c["mesh"] == "2x16x16"
                else "torch_dryrun_single_pod.json")
        swept = ([r for r in json.loads((results / name).read_text())
                  if (r["arch"], r["shape"]) == (c["arch"], c["shape"])]
                 if (results / name).exists() else [])
        if swept:
            w = swept[0]
            print(f"    against the committed CPU sweep ({name}): "
                  + ", ".join(f"{k} {c[k] / w[k]:.6f}x" for k in (
                      "flops_per_dev", "bytes_per_dev",
                      "collective_bytes_per_dev", "hbm_bytes_per_dev")))
    print(f"  dry run: subprocess {rec['seconds']:.1f}s host (beside the "
          f"other phases), waited {r['wait_s']:.1f}s for it at the end")


def phase_quant(torch, np) -> dict:
    """The int8 weight path at full width, QUANT_LAYERS deep: quantize
    Llama2-7B's weights on the card, seal, attest, unseal (bit-exact), then
    ops.qmm on layer 0's FFN weights and ops.mha_flash on layer 0's q, k,
    v."""
    import dataclasses

    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core import SealingKey, TrustDomain
    from repro_torch.core.sealing import tree_leaves_with_names
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    from repro_torch.models import build_model, layers
    from repro_torch.quant import QTensor, quantize_params, quantized_bytes

    cfg = dataclasses.replace(get_config("llama2-7b"),
                              num_layers=QUANT_LAYERS)
    model = build_model(cfg)            # the card
    params = model.init_params(seed=0)
    blk = params["layers"]["slot_0"]
    # layer 0's original bf16 weights, kept for the comparisons
    attn0 = {n: blk["attn"][n][0].clone() for n in ("wq", "wk", "wv")}
    ffn0 = {n: blk["ffn"][n][0].clone() for n in ("w_gate", "w_up", "w_down")}
    norm0 = {"scale": blk["pre_norm"]["scale"][0].clone()}
    table = params["embedding"]["table"].clone()
    bf16_bytes = quantized_bytes(params)
    torch.cuda.synchronize()

    # ---- the int8 path: every kernel count starts at 0 here --------------
    torch.cuda.reset_peak_memory_stats()
    reset_counts(C, P, Q, FA)
    t0 = time.perf_counter()
    qparams = quantize_params(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    del params, blk
    gc.collect()
    torch.cuda.empty_cache()
    td = TrustDomain("tdx", sealing_key=SealingKey.generate(b"chip-smoke-q"),
                     io_key=SealingKey.generate(b"chip-smoke-q-io"))
    t0 = time.perf_counter()
    sealed = td.seal_params(qparams)
    torch.cuda.synchronize()
    seal_s = time.perf_counter() - t0
    verifier = td.make_verifier(cfg.name)
    verifier.verify(td.quote(verifier.challenge(), cfg.name))
    t0 = time.perf_counter()
    unsealed = td.load_sealed(sealed, qparams)
    torch.cuda.synchronize()
    unseal_s = time.perf_counter() - t0
    weight_launches = C.launches

    acfg = layers.AttentionConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)
    prompt = torch.as_tensor(np.random.default_rng(11).integers(
        1, cfg.vocab_size, (1, QUANT_PROMPT)), device="cuda")
    positions = torch.arange(QUANT_PROMPT, device="cuda")[None, :]
    ffn = unsealed["layers"]["slot_0"]["ffn"]
    wq0 = {n: QTensor(ffn[n].values[0], ffn[n].scale[0]) for n in ffn0}
    with torch.inference_mode():
        x = layers.embed({"table": table}, prompt)
        h = layers.rmsnorm(norm0, x, cfg.norm_eps)
        q, k, v = layers._qkv(attn0, acfg, h, positions)
        t0 = time.perf_counter()
        flash = ops.mha_flash(q, k, v)                          # B2
        h2 = h[0]
        gate = ops.qmm(h2, wq0["w_gate"])                       # B5
        gate1 = ops.qmm(h2[-1:], wq0["w_gate"])   # decode-shaped: small M
        up = ops.qmm(h2, wq0["w_up"])
        act = F.silu(gate) * up
        down = ops.qmm(act, wq0["w_down"])
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
    launches = {"chacha20_xor_blocked": C.launches, **P.launches,
                "qmatmul": Q.launches, "flash_attention": FA.launches}
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the int8 path ----------------------------------------------

    n_leaves = 0
    for (name, a), (name2, b) in zip(tree_leaves_with_names(unsealed),
                                     tree_leaves_with_names(qparams)):
        check(name == name2 and a.dtype == b.dtype and torch.equal(a, b),
              f"unsealed quantized leaf {name} equals the original")
        n_leaves += 1
    n_q = sum(name.endswith(".values") for name in sealed)
    check(n_q > 0 and len(sealed) == n_leaves, "every quantized leaf sealed")
    q_bytes = quantized_bytes(qparams)
    sealed_bytes = sum(st.n_bytes for st in sealed.values())
    print(f"  quantized {n_q} leaves in {quant_s:.2f}s ({bf16_bytes} B bf16 "
          f"-> {q_bytes} B); sealed + attested + unsealed {len(sealed)} "
          f"tensors / {sealed_bytes} B: every .values and .scale bit-equal")
    del sealed, qparams

    qmm_err = {}
    with torch.inference_mode():
        for label, name, xin, out in (
                ("w_gate", "w_gate", h2, gate), ("w_up", "w_up", h2, up),
                ("w_down", "w_down", act, down),
                ("w_gate M=1", "w_gate", h2[-1:], gate1)):
            w = wq0[name]
            plain = ops.qmm(xin.cpu(), QTensor(w.values.cpu(), w.scale.cpu()))
            check(torch.equal(out.cpu(), plain),
                  f"ops.qmm({label}) on the card == its plain version")
            ref = (xin @ ffn0[name]).float()
            diff = out.float() - ref
            rel = float(diff.norm() / ref.norm())
            limit = qmm_err_limit(xin, ffn0[name])
            qmm_err[label] = (rel, limit, float(diff.abs().max()
                                                / ref.abs().max()))
            check(rel <= limit, f"ops.qmm({label}) within {limit:.4g} of the "
                  f"bf16 product (||diff|| / ||product|| {rel:.4g})")
        ref = layers.sdpa(q, k, v, causal=True)
    flash_err = float((flash.float() - ref.float()).abs().max())
    check(bool(torch.isfinite(flash).all()) and flash.shape == ref.shape,
          "mha_flash finite, of sdpa's shape")
    try:
        torch.testing.assert_close(flash, ref, rtol=FLASH_SDPA_TOL[0],
                                   atol=FLASH_SDPA_TOL[1])
    except AssertionError as e:
        check(False, f"ops.mha_flash vs layers.sdpa: {e}")
    print(f"  ops.qmm on layer 0 (x [{QUANT_PROMPT}, d], and [1, d] on w_gate: "
          f"{qmm_plan_text(Q, 1, *wq0['w_gate'].values.shape[::-1])}): "
          f"bit-equal to the "
          f"plain version; ||diff|| / ||bf16 product|| (limit; max |diff| / "
          f"max |product|) "
          + ", ".join(f"{n} {e:.4g} ({lim:.4g}; {mx:.4g})"
                      for n, (e, lim, mx) in qmm_err.items())
          + f"; ops.mha_flash on layer 0's q, k, v: max |diff| vs sdpa {flash_err:.4g} (rtol, atol {FLASH_SDPA_TOL})")
    for name, n in launches.items():
        want = n > 0 if name in ("chacha20_xor_blocked", "qmatmul",
                                 "flash_attention") else n == 0
        check(want, f"int8 path launches of {name}: {n}")
    return dict(launches=launches, weight_launches=weight_launches,
                quant_s=quant_s, seal_s=seal_s, unseal_s=unseal_s,
                path_s=path_s, peak=peak, q_bytes=q_bytes,
                bf16_bytes=bf16_bytes, n_leaves=n_leaves)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch.core.overheads import store_restore_savings
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import chacha20 as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as P
    from repro_torch.kernels import qmatmul as Q
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[1/9] device: {name} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels = (C, P, Q, FA)
    sources = ("chacha20.cu", "paged_attention.cu", "qmatmul.cu",
               "flash_attention.cu")
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per source
        list(pool.map(lambda K: K._kernel_fn(), kernels))
    print(f"[2/9] build: {', '.join(sources)} with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.2f}s")
    for src in sources:
        log = build.BUILD_LOG[src]
        print(f"  {src}: {log['seconds']:.2f}s (cached={log['cached']})")
        for line in log["ptxas"].splitlines():   # nvcc -Xptxas -v, per kernel
            if any(w in line for w in ("entry function", "registers", "spill")):
                print(f"  {line.strip()}")
    for src, tag in (("paged_attention.cu", "B3/B4"), ("qmatmul.cu", "B5")):
        print(f"  {tag} registers and spills (-Xptxas -v): " + "; ".join(
            f"{n} {r} regs, {sp} B spilled"
            for n, r, sp in ptxas_summary(build.BUILD_LOG[src]["ptxas"])))

    phase_t = {"device and build": time.perf_counter() - t_start}
    t_phase = time.perf_counter()
    print("[3/9] kernel check: chacha20_xor_blocked vs plain, bit for bit; "
          "paged_attention (B3) and paged_attention_unseal (B4) vs plain; "
          "qmatmul (B5) vs plain, bit for bit; flash_attention (B2) vs plain")
    max_err = phase_kernel_check(C, ops, torch, np)
    paged_err = phase_paged_check(P, torch, np)
    phase_paged_batch_check(P, torch, np)
    qmm_err = phase_qmm_check(Q, torch)
    flash_err = phase_flash_check(FA, torch)

    phase_t["kernel check"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    tm = phase_kernel_timing(C, torch, np)
    print(f"[4/9] kernel timing at N={W_GATE_BLOCKS} blocks "
          f"({W_GATE_BLOCKS * 64} B): kernel {tm['ms']:.4f} ms, bound "
          f"{tm['bound_ms']:.4f} ms (bytes {tm['bytes_ms']:.4f} ms, integer "
          f"ops {tm['ops_ms']:.4f} ms -> {tm['bound_by']}), plain version "
          f"{tm['plain_ms']:.2f} ms")
    pt = phase_paged_timing(P, torch, np, F)
    lg = pt["large"]
    print(f"  paged attention at {PAGED_LARGE['b']} slots x "
          f"{PAGED_LARGE['valid'][0]} positions (one llama2-7b layer, bf16, "
          f"every page live for B4): B3 {lg['ms3']:.4f} ms, B4 "
          f"{lg['ms4']:.4f} ms, bound {lg['b3'][0]:.4f} / {lg['b4'][0]:.4f} "
          f"ms ({lg['bytes']} B; ops {lg['ops_ms']:.4f} ms), gather + sdpa "
          f"{lg['lib3']:.4f} ms")
    print("  B4 at both timed shapes: " + paged_keystream_text(
        P, PAGED_LARGE["hk"], PAGED_LARGE["hd"], PAGED_LARGE["ps"], 2))
    b1_rate = W_GATE_BLOCKS / tm["ms"]      # ChaCha20 blocks a ms, B1
    for tag, geo in (("large", PAGED_LARGE), ("main", PAGED_MAIN)):
        r = pt[tag]
        print(f"  B4 split at {geo['b']} x {geo['valid'][0]}: every page live "
              f"{r['ms4']:.4f} ms; every page dead (the walk and the hand-over, "
              f"no keystream) {r['ms4_dead']:.4f} ms; its {r['ks_blocks']:.0f} "
              f"keystream blocks alone at B1's rate ({b1_rate:.0f} blocks/ms) "
              f"{r['ks_blocks'] / b1_rate:.4f} ms")
    mn = pt["main"]
    print(f"  paged attention at the main path's call ({PAGED_MAIN['b']} "
          f"slots x {PAGED_MAIN['valid'][0]} positions, one layer; 8 layer "
          f"copies in turn): B3 {mn['ms3']:.4f} ms (bound {mn['b3'][0]:.4f} "
          f"ms, bytes; plain {mn['plain3']:.3f} ms; gather + sdpa "
          f"{mn['lib3']:.4f} ms); B4 {mn['ms4']:.4f} ms (bound "
          f"{mn['b4'][0]:.4f} ms, {mn['b4'][1]}: bytes {mn['bytes_ms']:.4f} "
          f"ms, ops {mn['ops_ms']:.4f} ms; plain {mn['plain4']:.3f} ms)")

    cm = pt["chameleon"]
    print(f"  paged attention at the families path's chameleon-34b call "
          f"({PAGED_CHAMELEON['b']} slots x {PAGED_CHAMELEON['valid'][0]} "
          f"positions, h {PAGED_CHAMELEON['h']} / hk {PAGED_CHAMELEON['hk']}, "
          f"one layer; 32 layer copies in turn): B3 {cm['ms3']:.4f} ms "
          f"(bound {cm['b3'][0]:.4f} ms, bytes; gather + sdpa "
          f"{cm['lib3']:.4f} ms); B4 {cm['ms4']:.4f} ms, every page dead "
          f"{cm['ms4_dead']:.4f} ms (bound {cm['b4'][0]:.4f} ms, "
          f"{cm['b4'][1]}: bytes {cm['bytes_ms']:.4f} ms, ops "
          f"{cm['ops_ms']:.4f} ms)")
    print("  B4 at chameleon-34b's call: " + paged_keystream_text(
        P, PAGED_CHAMELEON["hk"], PAGED_CHAMELEON["hd"],
        PAGED_CHAMELEON["ps"], 2))
    qt = phase_qmm_timing(Q, torch)
    for (label, m), r in qt.items():
        lib = f"{r['lib_ms']:.4f} ms" if r["lib_ms"] is not None else "n/a"
        print(f"  qmatmul {label} M={m} ({r['plan']}): kernel "
              f"{r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms (bytes {r['bytes_ms']:.4f}, int8 ops "
              f"{r['ops_ms']:.4f} -> {r['bound_by']}), plain "
              f"{r['plain_ms']:.3f} ms, _int_mm + scale {lib}")
    ft = phase_flash_timing(FA, torch, F)
    for s_, r in ft.items():
        print(f"  flash_attention [1, {s_}, 32, 128] bf16: kernel "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes "
              f"{r['bytes_ms']:.4f}, flops {r['flops_ms']:.4f} -> "
              f"{r['bound_by']}), plain {r['plain_ms']:.3f} ms, sdpa "
              f"{r['lib_ms']:.4f} ms")

    phase_t["kernel timing"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    print("[5/9] serve: llama2-7b (32 layers, d_model 4096, bf16) under tdx")
    sp = phase_sampler(torch, np)
    print(f"  sampler on the card vs the CPU: keys, raw bits and uniforms "
          f"bit-equal over {sp['draws']} draws; Gumbel noise within "
          f"{sp['gumbel_ulps']:.2f} ulp of max(|g|, 1) (limit {GUMBEL_ULPS}); "
          f"sample() at vocab 32000, 2 rows, top-k 16: {sp['ms']:.4f} ms on "
          f"the device (CUDA events), {sp['host_ms']:.4f} ms a call with "
          f"its host issue")
    sv = phase_serve(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    phase_t["serve"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    rk = phase_ranks(torch, np, "llama2-7b", sv["specs"], sv["tp"])
    phase_t["ranks"] = time.perf_counter() - t_phase
    print(f"  ranks path: {RANKS} processes on the one card over gloo, each "
          f"holding its tp=2 half of the weights (built in turn, "
          f"fingerprints equal to the parent's): tokens, {rk['seals']} "
          f"sealed names and their blob bytes equal the TP path's logical "
          f"run bit for bit, every name sealed by rank 0 alone, egress "
          f"frames from rank 0 alone; dp={RANKS} over the same ranks on "
          f"{RANKS_DP_LAYERS} of 32 layers: tokens equal the logical dp="
          f"{RANKS} run of the cut ({rk['wall_s']:.1f}s with the spawn)")
    t_phase = time.perf_counter()
    rkp = phase_paged_ranks(torch, np)
    phase_t["paged ranks"] = time.perf_counter() - t_phase
    print(f"  paged ranks path: "
          f"{', '.join(f'{n} {c}' for n, c, *_ in PAGED_RANKS)}"
          f" at published width on tp=2, kv_backend='paged' with gather "
          f"decode, over {RANKS} gloo processes on the one card: tokens, "
          f"page tables after every step, sealed names and blob bytes equal "
          f"a logical tp=2 run's bit for bit, every name sealed by rank 0 "
          f"alone ({rkp['wall_s']:.1f}s with the spawn)")
    t_phase = time.perf_counter()
    print("[6/9] families: " + ", ".join(
        f"{n} {cut}" for n, cut, _ in FAMILIES)
        + " at published width, one at a time under tdx; whisper-small at "
          "full size")
    fam = phase_families(torch, np)
    phase_t["families"] = time.perf_counter() - t_phase
    dry = start_dryrun()     # fake tensors in a subprocess, beside the card
    t_phase = time.perf_counter()
    print(f"[7/9] training: llama2-7b at full width, {TRAIN_LAYERS} of 32 "
          f"layers, bf16, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, "
          f"{TRAIN_PARALLEL}; sealed checkpoints under tdx")
    tr = phase_train(torch, np)
    phase_t["training"] = time.perf_counter() - t_phase
    print_train(tr, smi)
    t_phase = time.perf_counter()
    print(f"  sharded training: llama2-7b at full width, {TRAIN_LAYERS} of 32 "
          f"layers, FSDP on dp={SHARD_MESH[0]} logical shards, "
          f"{SHARD_BATCH} x {SHARD_SEQ} tokens a step; an elastic resume "
          f"onto data={ELASTIC_MESH[0]}, model={ELASTIC_MESH[1]}; {RANKS} "
          f"gloo ranks; GPipe over {GPIPE_STAGES} stages; the launcher on a "
          f"2 x 2 mesh")
    sh_tr = phase_sharded_train(torch, np)
    phase_t["sharded training"] = time.perf_counter() - t_phase
    print_sharded(sh_tr, smi)
    t_phase = time.perf_counter()
    print(f"  tensor-parallel training of the other families: dbrx-132b, "
          f"{TP_DBRX_LAYERS} of 40 layers at published width, on data="
          f"{TP_DBRX_MESH[0]}, model={TP_DBRX_MESH[1]} at capacity factor "
          f"{TP_DBRX_CAPACITY}; whisper-small at full size on model="
          f"{TP_WHISPER_MESH[1]}, bf16 and f32")
    tp_tr = phase_tp_train(torch, np)
    phase_t["tensor-parallel training"] = time.perf_counter() - t_phase
    print_tp_train(tp_tr, smi)
    t_phase = time.perf_counter()
    print(f"[8/9] int8 weight path: llama2-7b at full width, {QUANT_LAYERS} "
          f"of 32 layers deep, quantized, sealed, unsealed; "
          "ops.qmm and ops.mha_flash on layer 0")
    qp = phase_quant(torch, np)
    phase_t["int8"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    print("  dry run (launch/dryrun.py): the training cut on "
          + ", ".join(f"{d} x {m}" for d, m in DRY_TRAIN_MESHES)
          + ", the tp=2 decode step and " + ", ".join(
              f"{a} {s} on {'2x16x16' if mp else '16x16'}"
              for a, s, mp in DRY_CELLS) + " under fake tensors")
    dr = phase_dryrun(torch, *dry, sh_tr, sv)
    phase_t["dry run (wait)"] = time.perf_counter() - t_phase
    print_dryrun(dr, smi)

    st, ch = sv["stats"], sv["channel"]
    per_req = (sv["launches"] - sv["weight_launches"]) / sv["n_requests"]
    print(f"[9/9] served {st.total_requests} requests / {st.total_tokens} "
          f"tokens in {sv['serve_s']:.2f}s wall; {st.preemptions} preemptions")
    print(f"  sealed KV: {ch.seal_events} seals / {ch.seal_bytes} B out, "
          f"{ch.restore_events} restores / {ch.restore_bytes} B back; egress "
          f"{ch.messages_out} frames / {ch.tokens_out} tokens")
    print(f"  weights: seal {sv['seal_s']:.2f}s + unseal {sv['unseal_s']:.2f}s "
          f"for {sv['weight_bytes']} B")
    print(f"  next-token latency p50 {st.p50_latency_s * 1e3:.2f} ms, mean "
          f"{st.mean_latency_s * 1e3:.2f} ms; TTFT p50 "
          f"{st.p50_ttft_s * 1e3:.2f} ms, mean {st.mean_ttft_s * 1e3:.2f} ms")
    weight_read_ms = sv["weight_bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"  breakdown: decode_step (2 rows) {sv['decode_s'] * 1e3:.2f} ms vs "
          f"{weight_read_ms:.2f} ms to read the weights once; prefill (1 x 128) "
          f"{sv['prefill_s'] * 1e3:.2f} ms; one egress frame (seal + MAC + "
          f"unseal + MAC) {sv['frame_s'] * 1e3:.3f} ms")
    print("  prefill of a bucket group, one [rows, s] call vs one row a call "
          "(the plan's): " + "; ".join(
              f"[{r} x {n}] {a:.2f} ms vs {b:.2f} ms"
              for (r, n), (a, b) in sv["group_ms"].items()))
    print(f"  peak device memory on the main path: {sv['peak']} B")
    print(f"  chacha20_xor_blocked launches on the slot path: {sv['launches']} "
          f"({sv['weight_launches']} for the weights, {per_req:.1f} per served "
          f"request)")
    check(sv["launches"] > 0, "the slot path launched the ChaCha20 kernel")
    ps_, pc = sv["paged_stats"], sv["paged_channel"]
    print(f"  paged-kernel path: {ps_.total_requests} requests / "
          f"{ps_.total_tokens} tokens in {sv['paged_s']:.2f}s wall; "
          f"{ps_.preemptions} preemptions; sealed KV {pc.seal_events} seals / "
          f"{pc.seal_bytes} B out, {pc.restore_events} restores / "
          f"{pc.restore_bytes} B back; next-token latency p50 "
          f"{ps_.p50_latency_s * 1e3:.2f} ms; TTFT p50 "
          f"{ps_.p50_ttft_s * 1e3:.2f} ms; one decode step (1 row at "
          f"{sv['kv_positions']} positions) {sv['kv_decode_s'] * 1e3:.2f} ms; "
          f"peak device memory {sv['paged_peak']} B")
    print(f"  launches on the paged-kernel path: {sv['paged_launches']}")
    sh = sv["share"]
    ss = sh["stats"]
    print(f"  sharing path: {ss.total_requests} sampled requests / "
          f"{ss.total_tokens} tokens in {sh['wall_s']:.2f}s wall (pool "
          f"invariants checked every step); {ss.preemptions} preemptions; "
          f"next-token latency p50 {ss.p50_latency_s * 1e3:.2f} ms, mean "
          f"{ss.mean_latency_s * 1e3:.2f} ms; TTFT p50 "
          f"{ss.p50_ttft_s * 1e3:.2f} ms; shared-page maps {sh['shared']}, "
          f"CoW copies {sh['cow']}, pages written {sh['written']} (unshared "
          f"{sh['plain_written']}), sealed KV {sh['seal_bytes']} B (unshared "
          f"{sh['plain_seal_bytes']} B); {sh['fused']} pages restored as "
          f"ciphertext; peak device memory {sh['peak']} B; the unshared run's "
          f"tokens equal in {sh['plain_same']} of {sh['n']} requests")
    print(f"  launches on the sharing path: {sh['launches']}")
    st_ = sv["store"]
    for tag in ("cold", "warm"):
        e = st_[tag]
        print(f"  store path, {tag} epoch: {e['stats'].total_requests} "
              f"requests / {e['stats'].total_tokens} tokens in "
              f"{e['wall_s']:.2f}s wall; TTFT p50 "
              f"{e['stats'].p50_ttft_s * 1e3:.2f} ms, p99 "
              f"{e['stats'].p99_ttft_s * 1e3:.2f} ms; next-token p50 "
              f"{e['stats'].p50_latency_s * 1e3:.2f} ms; pages written "
              f"{e['written']}, store hits {e['hits']} ({e['restored']} B "
              f"restored); {e['stats'].preemptions} preemptions")
    # the restore-vs-recompute price of what the store restored, with the
    # prefill's measured time a token (1 x 128 prefill above)
    _, _, priced = store_restore_savings(
        st_["restored_pages"], st_["restored_bytes"],
        st_["restored_pages"] * st_["page_size"], "tdx",
        prefill_token_s=sv["prefill_s"] / 128)
    print(f"  store path: {st_['publishes']} publishes, {st_['evictions']} "
          f"evictions, {st_['resident']} resident pages (budget "
          f"{STORE_BUDGET}, cost policy); {st_['fused']} pages restored as "
          f"ciphertext; peak device memory {st_['peak']} B; {priced}")
    print(f"  launches on the store path: {st_['launches']}")
    for label, r in sv["two_phase"]["modes"].items():
        ts = r["stats"]
        print(f"  two-phase path, {label}: {ts.total_requests} requests / "
              f"{ts.total_tokens} tokens in {r['wall_s']:.2f}s wall, "
              f"{r['steps']} steps; TTFT p50 {ts.p50_ttft_s * 1e3:.2f} ms, "
              f"p99 {ts.p99_ttft_s * 1e3:.2f} ms; next-token p50 "
              f"{ts.p50_latency_s * 1e3:.2f} ms; backfills {r['backfills']}; "
              f"handoffs {ts.handoffs} / {ts.handoff_bytes} B in "
              f"{r['crossings']} crossings; {ts.preemptions} preemptions, "
              f"{r['fused']} pages restored as ciphertext; peak "
              f"{r['peak']} B")
        print(f"    launches: {r['launches']}")
    fl = sv["fleet"]
    gs, fs, ch_ = fl["gateway"], fl["fleet"], fl["channel"]
    print(f"  fleet path: gateway {gs.attested_workers} workers attested / "
          f"{gs.rejected_quotes} quote rejections / {gs.keys_released} "
          f"tenant keys released / {gs.envelopes} prompt envelopes "
          f"({gs.envelope_bytes} B); fleet {fs.submitted} submitted, "
          f"{fs.migrations} migrations / {fs.migrated_bytes} B, "
          f"{fs.requeued} requeued, {fs.kills} kills, {fs.drains} drains, "
          f"{fs.respawns} respawns; boundary {ch_}")
    print(f"  fleet path: kill to resume {fl['resume_s'] * 1e3:.2f} ms "
          f"(the kill's export {fl['seal_s'] * 1e3:.2f} ms, then "
          f"{fl['resume_steps']} fleet steps until a migrant's next token); "
          f"{fl['moved']} B migrated; the survivor restored "
          f"{fl['survivor_fused']} migrated pages as ciphertext and "
          f"launched B4 {fl['survivor_b4']} times before the drain; "
          f"{fl['shared']} shared-page maps; peak device memory "
          f"{fl['peak']} B")
    for tag, fst, fw in (("kill", fl["stats"], fl["wall_s"]),
                         ("no kill", fl["calm_stats"], fl["calm_s"])):
        print(f"  fleet path, {tag}: {fst.total_requests} requests / "
              f"{fst.total_tokens} tokens in {fw:.2f}s wall; TTFT p50 "
              f"{fst.p50_ttft_s * 1e3:.2f} ms; next-token p50 "
              f"{fst.p50_latency_s * 1e3:.2f} ms")
    print(f"  launches on the fleet path: {fl['launches']}")
    rg = sv["rag"]
    print(f"  RAG path: index build {rg['build_s'] * 1e3:.2f} ms (corpus "
          f"ingress, BM25, dense encoding on the card); per query retrieval "
          + ", ".join(f"{x:.2f}" for x in rg["retrieval_ms"])
          + " ms, generation " + ", ".join(f"{x:.2f}"
                                          for x in rg["generation_ms"])
          + f" ms ({RAG_NEW} tokens over prompts of "
          + ", ".join(str(n) for n in rg["prompt_len"])
          + f" tokens); hits {rg['hits']}")
    print(f"  launches on the RAG path: {rg['launches']}")
    card = f"[{smi}]"
    for label, r in sv["mesh"].items():
        ms_ = r["stats"]
        one, one_s = r["single"]["stats"], r["single"]["wall_s"]
        print(f"  mesh path, {label} ({r['describe']}): "
              f"{ms_.total_requests} requests / {ms_.total_tokens} tokens in "
              f"{r['wall_s']:.2f}s wall (one device {one_s:.2f}s); "
              f"next-token p50 {ms_.p50_latency_s * 1e3:.2f} ms (one device "
              f"{one.p50_latency_s * 1e3:.2f} ms); TTFT p50 "
              f"{ms_.p50_ttft_s * 1e3:.2f} ms (one device "
              f"{one.p50_ttft_s * 1e3:.2f} ms); {r['steps']} decode steps, "
              f"{ms_.preemptions} preemptions {card}")
        print(f"    gather of {r['moved']} B a step: {r['gather_ms']:.4f} ms "
              f"(CUDA events on every decode step's gather, mean) vs a "
              f"{r['gather_bound_ms']:.4f} ms bound (2 x bytes / HBM); "
              f"{r['per_step']} collective B/step {card}")
        print(f"    link-tax [{MESH}, tdx]: {r['link']} [measured: the "
              f"gather's copy in device memory, one card, no link] {card}")
        print(f"    peak device memory {r['peak']} B (the caller's unsealed "
              f"weights, the chunks, the gather buffers); launches "
              f"{r['launches']} {card}")
    for label in MESH_BACKENDS:
        r = sv["tp"][label]
        ts, one = r["stats"], r["single"]["stats"]
        print(f"  TP path, {label} ({r['describe']}): {ts.total_requests} "
              f"requests / {ts.total_tokens} tokens in {r['wall_s']:.2f}s "
              f"wall (one device {r['single']['wall_s']:.2f}s); next-token "
              f"p50 {ts.p50_latency_s * 1e3:.2f} ms (one device "
              f"{one.p50_latency_s * 1e3:.2f} ms); TTFT p50 "
              f"{ts.p50_ttft_s * 1e3:.2f} ms (one device "
              f"{one.p50_ttft_s * 1e3:.2f} ms); {r['steps']} decode steps, "
              f"{ts.preemptions} preemptions {card}")
        print(f"    collectives: {r['per_step']} B/step (formula "
              f"{r['expect_b']} B: 65 bf16 reductions of [2, 1, 4096] and "
              f"the f32 logits' vocabulary gather), {r['coll_ms']:.4f} ms a "
              f"step (CUDA events on every reduction and gather: sums and "
              f"copies in device memory, one card, no link); peak device "
              f"memory {r['peak']} B; launches {r['launches']} {card}")
        print(f"    link-tax [{TP_MESH}, tdx]: {r['link']} {card}")
    for case in ("tp", "dp"):
        r0 = rk["ranks"][0][case]
        print(f"  ranks path, {case}=2 ({r0['describe']}): "
              f"{sum(map(len, r0['tokens']))} tokens in {r0['wall_s']:.2f}s "
              f"wall; next-token p50 {r0['p50'] * 1e3:.2f} ms, TTFT p50 "
              f"{r0['ttft'] * 1e3:.2f} ms; {r0['steps']} decode steps; "
              f"collectives {r0['per_step']} B/step, "
              + ", ".join(f"rank {i} {got[case]['coll_ms']:.3f} ms"
                          for i, got in enumerate(rk["ranks"]))
              + f" a step (host clock: gloo through host memory on one "
                f"card, not NVLink) {card}")
    print(f"    ranks path, tp=2: peak device memory of rank 0 "
          f"{rk['ranks'][0]['tp']['peak']} B (its whole seed-0 copy while it "
          f"built its half); B1 launches {rk['launches']} {card}")
    for arch, *_ in PAGED_RANKS:
        w, r0 = rkp["want"][arch], rkp["ranks"][0][arch]
        build_on_card = [got[arch]["build_peak"] + sum(
            g[arch]["held"] for g in rkp["ranks"][:i])
            for i, got in enumerate(rkp["ranks"])]
        print(f"  paged ranks path, {arch} ({r0['describe']}): "
              f"{sum(map(len, r0['tokens']))} tokens in {r0['wall_s']:.2f}s "
              f"wall (logical tp=2 {w['wall_s']:.2f}s); next-token p50 "
              f"{r0['p50'] * 1e3:.2f} ms (logical {w['p50'] * 1e3:.2f} ms); "
              f"{r0['steps']} decode steps, {r0['preemptions']} preemptions, "
              f"{r0['seal_events']} seals / {r0['restore_events']} restores; "
              f"collectives {r0['per_step']} B/step, gloo "
              + ", ".join(f"rank {i} {got[arch]['coll_ms']:.3f} ms"
                          for i, got in enumerate(rkp["ranks"]))
              + f" a step (host clock: gloo through host memory on one "
                f"card, not NVLink; logical {w['coll_ms']:.4f} ms); B1 "
                f"launches on the ranks " + ", ".join(
                    f"rank {i} {got[arch]['launches']}"
                    for i, got in enumerate(rkp["ranks"]))
              + f"; {len(r0['frozen'])} paused-row steps frozen; peak "
                f"device memory serving " + ", ".join(
                    f"rank {i} {got[arch]['peak']} B"
                    for i, got in enumerate(rkp["ranks"]))
              + ", building in turn " + ", ".join(
                  f"rank {i} {got[arch]['build_peak']} B (the card "
                  f"{on_card} B with the ranks before it holding their "
                  f"halves)" for i, (got, on_card) in enumerate(zip(
                      rkp["ranks"], build_on_card)))
              + f" (logical run {w['peak']} B, freed first) {card}")
    print(f"  sampler vs the decode step: sample() {sp['ms']:.4f} ms device "
          f"/ {sp['host_ms']:.4f} ms with host issue, beside a 2-row "
          f"decode_step of {sv['decode_s'] * 1e3:.2f} ms (host clock)")
    print(f"  int8 path: quantize {qp['quant_s']:.2f}s ({qp['bf16_bytes']} B "
          f"-> {qp['q_bytes']} B), seal {qp['seal_s']:.2f}s + unseal "
          f"{qp['unseal_s']:.2f}s for {qp['n_leaves']} leaves, layer 0's "
          f"mha_flash + 4 qmm {qp['path_s'] * 1e3:.2f} ms (host clock); peak "
          f"device memory {qp['peak']} B")
    print(f"  launches on the int8 path: {qp['launches']} "
          f"({qp['weight_launches']} chacha20 for the weights)")
    print(f"  total {time.perf_counter() - t_start:.1f}s: " + ", ".join(
        f"{k} {v:.1f}s" for k, v in phase_t.items())
        + "; serve paths with their checks: " + ", ".join(
            f"{k} {v:.1f}s" for k, v in sv["path_s"].items()))
    fam_launches = {k: sum(r["launches"][k] for r in fam.values())
                    for k in ("chacha20_xor_blocked", "paged_attention",
                              "paged_attention_unseal", "flash_attention")}
    print(f"  launches on the families path: " + "; ".join(
        f"{n} {r['launches']}" for n, r in fam.items())
        + f"; summed {fam_launches}")
    fam_tp = [r["tp"]["launches"] for r in fam.values() if r.get("tp")]
    later = [sh["launches"], st_["launches"], fl["launches"],
             rg["launches"], fam_launches, rkp["logical_launches"]] + fam_tp + [
        r["launches"] for r in sv["mesh"].values()] + [
        sv["tp"][label]["launches"] for label in MESH_BACKENDS] + [
        r["launches"] for r in sv["two_phase"]["modes"].values()]
    pl = {k: v + sum(x[k] for x in later)
          for k, v in sv["paged_launches"].items()}
    b1_launches = (sv["launches"] + pl["chacha20_xor_blocked"]
                   + tr["launches"]["chacha20_xor_blocked"]
                   + sh_tr["launches"]["chacha20_xor_blocked"]
                   + tp_tr["launches"]["chacha20_xor_blocked"]
                   + qp["launches"]["chacha20_xor_blocked"]
                   + rk["launches"] + rkp["launches"])
    b2_launches = (sv["slot_b2"] + pl["flash_attention"]
                   + qp["launches"]["flash_attention"])
    print(f"  launches summed over the paths each kernel runs on: B1 "
          f"{b1_launches} (slot, paged, sharing, store, two-phase, fleet, "
          f"RAG, mesh, TP, ranks, paged ranks, families, families on tp=2, "
          f"training, sharded and tensor-parallel training, int8), B2 "
          f"{b2_launches} (the prefills of slot, paged, sharing, store, "
          f"two-phase, fleet, RAG, mesh, TP, paged ranks' logical run, the "
          f"attention families, whisper, and int8), B3 {pl['paged_attention']} "
          f"(paged, sharing, store, two-phase, fleet, RAG, chameleon) and B4 "
          f"{pl['paged_attention_unseal']} (paged, sharing, store, "
          f"two-phase, fleet, chameleon)")
    fm, qm = ft[128], qt[QMM_MAIN]
    print(json.dumps({"kernels": [{
        "name": "chacha20_xor_blocked", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chacha20.cu",
        "replaces": "src/repro/kernels/chacha20.py:98",
        "launches": b1_launches, "max_abs_err": float(max_err),
        "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": None}, {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:269",
        "launches": pl["paged_attention"],
        "max_abs_err": paged_err["paged_attention"], "ms": mn["ms3"],
        "plain_ms": mn["plain3"], "bound_ms": mn["b3"][0],
        "bound_by": mn["b3"][1], "library_ms": mn["lib3"]}, {
        "name": "paged_attention_unseal", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:334",
        "launches": pl["paged_attention_unseal"],
        "max_abs_err": paged_err["paged_attention_unseal"], "ms": mn["ms4"],
        "plain_ms": mn["plain4"], "bound_ms": mn["b4"][0],
        "bound_by": mn["b4"][1], "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": b2_launches,
        "max_abs_err": flash_err, "ms": fm["ms"], "plain_ms": fm["plain_ms"],
        "bound_ms": fm["bound_ms"], "bound_by": fm["bound_by"],
        "library_ms": fm["lib_ms"]}, {
        "name": "qmatmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/qmatmul.cu",
        "replaces": "src/repro/kernels/qmatmul.py:54",
        "launches": qp["launches"]["qmatmul"],
        "max_abs_err": qmm_err, "ms": qm["ms"], "plain_ms": qm["plain_ms"],
        "bound_ms": qm["bound_ms"], "bound_by": qm["bound_by"],
        "library_ms": qm["lib_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-worker"]:
        sys.exit(dryrun_worker(sys.argv[2]))
    sys.exit(main())
