"""ChaCha20 keystream XOR: the seal/unseal kernel, and its plain version.

Port of ``repro.kernels.chacha20`` (the Pallas kernel ``chacha20_xor_blocked``)
and of the ChaCha20 oracles in ``repro.kernels.ref``. Data layout is the
reference's: a sealed buffer is uint32 ``[16, N]``, word w of 64-byte block b
at ``[w, b]``, N a multiple of :data:`BLOCKS_PER_TILE`; block b is encrypted
under counter ``(counter_base + b) mod 2**32``. Applying the XOR twice returns
the input.

Torch keeps the uint32 words as int32 tensors holding the same bits (a
uint32 tensor is accepted too). On the card the work is the hand-written
CUDA kernel ``csrc/chacha20.cu``; a tensor on the CPU goes to the plain
version, which computes in int64 masked to 32 bits because torch has no
uint32 add or shift on the CPU. ``chip_smoke.py`` also runs the plain version
on the card, as the reference the kernel is held to.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

# 64 KiB of keystream per tile: the reference's Pallas tile width, kept as the
# padding unit of the blocked layout so ciphertext bytes match it exactly.
BLOCKS_PER_TILE = 1024

CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)

_MASK = 0xFFFFFFFF

# Launches of the CUDA kernel since the last reset (the plain version never
# counts): a run reads it to show the main path went through the kernel.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _words(x, n: int) -> list:
    """Key or nonce words (a numpy array or a sequence) as Python ints."""
    arr = np.asarray(x).astype(np.uint64).reshape(-1)
    if arr.size != n:
        raise ValueError(f"want {n} words, got {arr.size}")
    return [int(v) & _MASK for v in arr]


# ---------------------------------------------------------------------------
# plain version (int64 masked to 32 bits)
# ---------------------------------------------------------------------------

def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) & _MASK) | (x >> (32 - n))


def _quarter(s, a, b, c, d):
    sa, sb, sc, sd = s[a], s[b], s[c], s[d]
    sa = (sa + sb) & _MASK
    sd = _rotl(sd ^ sa, 16)
    sc = (sc + sd) & _MASK
    sb = _rotl(sb ^ sc, 12)
    sa = (sa + sb) & _MASK
    sd = _rotl(sd ^ sa, 8)
    sc = (sc + sd) & _MASK
    sb = _rotl(sb ^ sc, 7)
    s[a], s[b], s[c], s[d] = sa, sb, sc, sd


def chacha_block_words(key_words: Sequence[int], nonce_words: Sequence[int],
                       counters: torch.Tensor) -> list:
    """ChaCha20 block function over int64 ``counters`` (values in [0, 2**32)).
    Nonce words are ints, or int64 tensors that broadcast against
    ``counters`` (one nonce per row of pages). Returns the 16 keystream
    words, each an int64 tensor shaped like ``counters`` holding a uint32
    value."""
    init = ([torch.full_like(counters, c) for c in CONSTANTS]
            + [torch.full_like(counters, w) for w in key_words]
            + [counters & _MASK]
            + [torch.zeros_like(counters) + w for w in nonce_words])
    state = list(init)
    for _ in range(10):  # 10 double rounds = 20 rounds
        _quarter(state, 0, 4, 8, 12)
        _quarter(state, 1, 5, 9, 13)
        _quarter(state, 2, 6, 10, 14)
        _quarter(state, 3, 7, 11, 15)
        _quarter(state, 0, 5, 10, 15)
        _quarter(state, 1, 6, 11, 12)
        _quarter(state, 2, 7, 8, 13)
        _quarter(state, 3, 4, 9, 14)
    return [(s + i) & _MASK for s, i in zip(state, init)]


def chacha20_keystream(key_words, nonce_words, n_blocks: int,
                       counter_base: int = 0, device="cpu") -> torch.Tensor:
    """Keystream as int64 ``[16, n_blocks]`` of uint32 values (word w of
    block b at ``[w, b]``); counters wrap mod 2**32."""
    counters = (torch.arange(n_blocks, dtype=torch.int64, device=device)
                + (int(counter_base) & _MASK)) & _MASK
    words = chacha_block_words(_words(key_words, 8), _words(nonce_words, 3),
                               counters)
    return torch.stack(words, dim=0)


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def chacha20_xor_plain(key_words, nonce_words, data: torch.Tensor,
                       counter_base: int = 0) -> torch.Tensor:
    """The plain version of :func:`chacha20_xor_blocked`: ``data`` int32 (or
    uint32) ``[16, N]`` XOR the keystream, on whatever device ``data`` is."""
    ks = chacha20_keystream(key_words, nonce_words, data.shape[1],
                            counter_base, device=data.device)
    out = data.view(torch.int32) ^ _to_i32_bits(ks)
    return out.view(data.dtype)


def chacha20_keystream_bytes(key: bytes, nonce: bytes, n_bytes: int,
                             counter_base: int = 0) -> bytes:
    """Byte-level RFC 8439 keystream (little-endian words), for checking
    against published test vectors."""
    kw = np.frombuffer(key, np.uint32)
    nw = np.frombuffer(nonce, np.uint32)
    ks = chacha20_keystream(kw, nw, (n_bytes + 63) // 64, counter_base)
    return ks.T.numpy().astype("<u4").tobytes()[:n_bytes]


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

@functools.cache
def _kernel_fn():
    from repro_torch.kernels import build
    fn = build.load("chacha20.cu").repro_chacha20_xor
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chacha20_xor_blocked(key_words, nonce_words, data: torch.Tensor,
                         counter_base: int = 0,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """XOR ``data`` (int32 or uint32 ``[16, N]``, N a multiple of
    :data:`BLOCKS_PER_TILE`, contiguous) with the ChaCha20 keystream.

    A CUDA tensor launches the kernel (building it on first use) and raises
    if it cannot; a CPU tensor goes to the plain version. ``out`` (same
    shape, dtype and device; may be ``data`` itself) receives the result in
    place of a fresh tensor."""
    global launches
    if data.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"data must be int32 or uint32 words, got {data.dtype}")
    if data.dim() != 2 or data.shape[0] != 16:
        raise ValueError(f"data must be [16, N], got {tuple(data.shape)}")
    n = data.shape[1]
    if n % BLOCKS_PER_TILE:
        raise ValueError(f"N={n} is not a multiple of {BLOCKS_PER_TILE}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if out is not None and (out.shape != data.shape or out.dtype != data.dtype
                            or out.device != data.device
                            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like data")
    kn = _words(key_words, 8) + _words(nonce_words, 3)
    if data.device.type == "cpu":
        res = chacha20_xor_plain(kn[:8], kn[8:], data, counter_base)
        if out is None:
            return res
        out.copy_(res)
        return out
    if data.device.type != "cuda":
        raise ValueError(f"no ChaCha20 kernel for device {data.device}")
    if out is None:
        out = torch.empty_like(data)
    fn = _kernel_fn()
    words = (ctypes.c_uint32 * 11)(*kn)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = fn(data.data_ptr(), out.data_ptr(), n, words,
                int(counter_base) & _MASK, stream)
    if rc != 0:
        raise RuntimeError(f"ChaCha20 kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
