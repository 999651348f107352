"""Packing around the ChaCha20 kernel: arbitrary bytes <-> blocked layout.

Port of the sealing half of ``repro.kernels.ops``. The layout and padding
are the reference's, byte for byte: bytes are zero-padded to a multiple of
64 KiB (one :data:`BLOCKS_PER_TILE` tile), read as little-endian uint32
words in blocks of 16, and stored word-major as ``[16, N]``. The port packs
and unpacks on the tensor's own device (the reference did it on the host).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.chacha20 import BLOCKS_PER_TILE, chacha20_xor_blocked

TILE_BYTES = 64 * BLOCKS_PER_TILE


def pack_u32(raw: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """uint8 bytes -> (int32 ``[16, N]`` blocked layout on raw's device,
    original byte length)."""
    n_bytes = raw.numel()
    padded = n_bytes + (-n_bytes) % TILE_BYTES
    buf = torch.zeros(padded, dtype=torch.uint8, device=raw.device)
    buf[:n_bytes] = raw.reshape(-1)
    # little-endian words (the card and x86 hosts are little-endian)
    words = buf.view(torch.int32).view(-1, 16).t().contiguous()
    return words, n_bytes


def unpack_u32(words: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """Inverse of :func:`pack_u32` -> uint8 ``[n_bytes]`` on words' device."""
    return words.t().contiguous().view(-1).view(torch.uint8)[:n_bytes]


def seal_u32(key_words, nonce_words, blocked: torch.Tensor,
             counter_base: int = 0,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """XOR blocked data with the keystream (seal == unseal: involution)."""
    return chacha20_xor_blocked(key_words, nonce_words, blocked,
                                counter_base=counter_base, out=out)


unseal_u32 = seal_u32  # stream-cipher involution
