"""repro_torch's ChaCha20 kernel module against the reference's Pallas kernel
(interpret mode) and its jnp oracles, on the same numpy inputs. The CUDA
kernel itself is checked on the card by tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.chacha20 import chacha20_xor_blocked as jax_xor
from repro_torch.kernels import chacha20 as C
from repro_torch.kernels import ops

RFC_CIPHER = bytes.fromhex(
    "6e2e359a2568f98041ba0728dd0d6981e97e7aec1d4360c20a27afccfd9fae0b"
    "f91b65c5524733ab8f593dabcd62b3571639d624e65152ab8f530c359f0861d8"
    "07ca0dbf500d6a6156a38e088a22b65e52bc514d16ccf806818ce91ab7793736"
    "5af90bbf74a35be6b40b8eedf2785e42874d")


def _words(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint32)


def _data(rng, n_blocks):
    return rng.integers(0, 2**32, (16, n_blocks), dtype=np.uint32)


def _t(u32: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> the port's int32 word tensor (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(u32).view(np.int32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def test_rfc8439_keystream_vector():
    """RFC 8439 section 2.4.2, counter 1 (as tests/test_kernels.py)."""
    key = bytes(range(32))
    nonce = bytes([0, 0, 0, 0, 0, 0, 0, 0x4A, 0, 0, 0, 0])
    plaintext = (b"Ladies and Gentlemen of the class of '99: If I could "
                 b"offer you only one tip for the future, sunscreen would be it.")
    ks = C.chacha20_keystream_bytes(key, nonce, 114, counter_base=1)
    assert bytes(a ^ b for a, b in zip(plaintext, ks)) == RFC_CIPHER
    assert ks == jref.chacha20_keystream_bytes_ref(key, nonce, 114, 1)
    # and through the wrapper on the blocked layout
    raw = torch.frombuffer(bytearray(plaintext), dtype=torch.uint8)
    blocked, n = ops.pack_u32(raw)
    out = C.chacha20_xor_blocked(np.frombuffer(key, np.uint32),
                                 np.frombuffer(nonce, np.uint32), blocked, 1)
    assert ops.unpack_u32(out, n).numpy().tobytes() == RFC_CIPHER


@pytest.mark.parametrize("counter_base", [0, 7, 2**32 - 2])
def test_keystream_matches_reference_oracle(counter_base):
    rng = np.random.default_rng(counter_base % 97)
    kw, nw = _words(rng, 8), _words(rng, 3)
    ks = C.chacha20_keystream(kw, nw, 40, counter_base)
    expect = jref.chacha20_keystream_ref(jnp.asarray(kw), jnp.asarray(nw), 40,
                                         counter_base)
    assert np.array_equal(ks.numpy().astype(np.uint32), np.asarray(expect))


@pytest.mark.parametrize("n_tiles,counter_base", [(1, 0), (2, 7),
                                                  (1, 2**32 - 2)])
def test_xor_matches_pallas_kernel(n_tiles, counter_base):
    """The wrapper (plain version on CPU tensors) equals the reference's
    Pallas kernel in interpret mode, including across the u32 wrap."""
    rng = np.random.default_rng(n_tiles)
    n = n_tiles * C.BLOCKS_PER_TILE
    data, kw, nw = _data(rng, n), _words(rng, 8), _words(rng, 3)
    out = C.chacha20_xor_blocked(kw, nw, _t(data), counter_base=counter_base)
    expect = jax_xor(jnp.asarray(kw), jnp.asarray(nw), jnp.asarray(data),
                     counter_base=counter_base)
    assert np.array_equal(_np(out), np.asarray(expect))


def test_counter_wraps_uint32():
    kw, nw = np.arange(8, dtype=np.uint32), np.arange(3, dtype=np.uint32)
    wrapped = C.chacha20_keystream(kw, nw, 4, counter_base=2**32 - 2)
    lo = C.chacha20_keystream(kw, nw, 2, counter_base=0)
    assert torch.equal(wrapped[:, 2:], lo)
    assert not torch.equal(wrapped[:, :2], lo)


def test_counter_continuation_across_calls():
    """Two calls entering the stream at 0 and N reproduce one call."""
    rng = np.random.default_rng(5)
    n = 2 * C.BLOCKS_PER_TILE
    data, kw, nw = _t(_data(rng, n)), _words(rng, 8), _words(rng, 3)
    whole = C.chacha20_xor_blocked(kw, nw, data)
    lo = C.chacha20_xor_blocked(kw, nw, data[:, :C.BLOCKS_PER_TILE].contiguous())
    hi = C.chacha20_xor_blocked(kw, nw, data[:, C.BLOCKS_PER_TILE:].contiguous(),
                                counter_base=C.BLOCKS_PER_TILE)
    assert torch.equal(whole, torch.cat([lo, hi], dim=1))
    # involution, in place through ``out``
    buf = whole.clone()
    assert C.chacha20_xor_blocked(kw, nw, buf, out=buf) is buf
    assert torch.equal(buf, data)


def test_uint32_words_accepted():
    rng = np.random.default_rng(3)
    data, kw, nw = _data(rng, C.BLOCKS_PER_TILE), _words(rng, 8), _words(rng, 3)
    as_i32 = C.chacha20_xor_blocked(kw, nw, _t(data))
    as_u32 = C.chacha20_xor_blocked(kw, nw, _t(data).view(torch.uint32))
    assert as_u32.dtype == torch.uint32
    assert torch.equal(as_u32.view(torch.int32), as_i32)


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(16, 1024, dtype=torch.float32), TypeError),
    (torch.zeros(8, 1024, dtype=torch.int32), ValueError),
    (torch.zeros(16, 1000, dtype=torch.int32), ValueError),
    (torch.zeros(1024, 16, dtype=torch.int32).t(), ValueError),
])
def test_wrapper_rejects_bad_data(bad, err):
    with pytest.raises(err):
        C.chacha20_xor_blocked(np.zeros(8, np.uint32), np.zeros(3, np.uint32),
                               bad)


@pytest.mark.parametrize("nbytes", [1, 100, 64 * 1024, 64 * 1024 + 5, 200_001])
def test_pack_u32_layout_and_padding(nbytes):
    """Same [16, N] word-major layout and 64 KiB padding as ops.pack_u32."""
    raw = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8)
    words, n = ops.pack_u32(torch.from_numpy(raw))
    jwords, jn = jops.pack_u32(raw)
    assert n == jn == nbytes
    assert words.dtype == torch.int32 and tuple(words.shape) == jwords.shape
    assert np.array_equal(_np(words), np.asarray(jwords))
    assert np.array_equal(ops.unpack_u32(words, n).numpy(),
                          jops.unpack_u32(jwords, jn))


def test_plain_version_never_counts_launches():
    before = C.launches
    C.chacha20_xor_blocked(np.zeros(8, np.uint32), np.zeros(3, np.uint32),
                           torch.zeros(16, 1024, dtype=torch.int32))
    assert C.launches == before

