"""Sealed tensors: encrypt-then-MAC at rest, ChaCha20 kernel decrypt on device.

Port of ``repro.core.sealing``; blobs cross between the two packages. Model
weights and KV are stored and moved as ChaCha20 ciphertext in the blocked
``[16, N]`` layout and XOR-decrypted on the way into compute by
``kernels/chacha20.py``. Integrity is encrypt-then-MAC with HMAC-SHA256 over
(header || ciphertext): a flipped ciphertext bit fails verification before
any plaintext is produced.

The wire format is the reference's byte for byte: the nonce is
``sha256(key_id|name)[:12]``, the header is ``name|shape|dtype|n_bytes``
with the shape as a Python tuple and the dtype in numpy's spelling, the MAC
covers the whole padded ciphertext in row-major order, and tree names are
``prefix + keystr(path) + suffix`` over sorted dict keys (``['a']['b']``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

Params = Any

# numpy's dtype spelling (the header's) for each torch dtype a sealed tensor
# may carry, and back
_DTYPE_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.uint16: "uint16",
    torch.uint32: "uint32", torch.bool: "bool",
}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}

# ciphertext streams device-to-host into the MAC in chunks of this many words
_MAC_CHUNK_WORDS = 1 << 24


class IntegrityError(Exception):
    """MAC verification failed — ciphertext or header was tampered with."""


@dataclasses.dataclass(frozen=True)
class SealingKey:
    key: bytes          # 32-byte ChaCha20 key
    mac_key: bytes      # 32-byte HMAC key (independent)

    @classmethod
    def generate(cls, seed: bytes | None = None) -> "SealingKey":
        if seed is not None:
            k = hashlib.sha256(b"seal" + seed).digest()
            m = hashlib.sha256(b"mac" + seed).digest()
            return cls(k, m)
        return cls(os.urandom(32), os.urandom(32))

    def derive(self, label: str) -> "SealingKey":
        """HKDF-style labeled subkey (a key domain carved out of this key);
        both halves derive independently, so the MAC domain separates too."""
        lb = label.encode()
        return SealingKey(
            hashlib.sha256(b"derive/key|" + lb + b"|" + self.key).digest(),
            hashlib.sha256(b"derive/mac|" + lb + b"|" + self.mac_key).digest())

    @property
    def key_words(self) -> np.ndarray:
        return np.frombuffer(self.key, np.uint32)

    def key_id(self) -> str:
        return hashlib.sha256(self.key).hexdigest()[:16]


def _nonce_for(key: SealingKey, name: str) -> bytes:
    return hashlib.sha256(key.key_id().encode() + b"|" + name.encode()).digest()[:12]


def nonce_words_for(key: SealingKey, name: str) -> np.ndarray:
    """The blob's ChaCha20 nonce as uint32[3]."""
    return np.frombuffer(_nonce_for(key, name), np.uint32)


def shared_page_name(content_key: bytes, kpath: str) -> str:
    """The canonical sealed-tensor name for content-addressed KV pages."""
    return f"kvshared/{content_key.hex()}{kpath}"


@dataclasses.dataclass
class SealedTensor:
    name: str
    ciphertext: torch.Tensor    # int32 [16, N] blocked layout (uint32 bits)
    mac: bytes
    shape: Tuple[int, ...]
    dtype: str                  # numpy spelling: "bfloat16", "float32", ...
    n_bytes: int

    def header(self) -> bytes:
        return f"{self.name}|{self.shape}|{self.dtype}|{self.n_bytes}".encode()


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype in the header's numpy spelling."""
    return _DTYPE_NAMES[dtype]


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a header's numpy spelling."""
    return _DTYPES[name]


def _mac(key: SealingKey, sealed_header: bytes, ciphertext: torch.Tensor) -> bytes:
    h = hmac.new(key.mac_key, sealed_header, hashlib.sha256)
    flat = ciphertext.reshape(-1)
    for i in range(0, flat.numel(), _MAC_CHUNK_WORDS):
        h.update(flat[i:i + _MAC_CHUNK_WORDS].cpu().numpy())
    return h.digest()


def _raw_bytes(array, device) -> Tuple[torch.Tensor, Tuple[int, ...], str]:
    """(uint8 bytes on the target device, shape, numpy dtype name)."""
    if isinstance(array, torch.Tensor):
        if array.dtype not in _DTYPE_NAMES:
            raise TypeError(f"cannot seal a {array.dtype} tensor")
        t = array if device is None else array.to(device)
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        return raw, tuple(int(s) for s in t.shape), _DTYPE_NAMES[t.dtype]
    arr = np.ascontiguousarray(np.asarray(array))
    raw = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    if device is not None:
        raw = raw.to(device)
    return raw, tuple(arr.shape), str(arr.dtype)


def seal_tensor(key: SealingKey, name: str, array,
                device=None) -> SealedTensor:
    """Seal a torch tensor (on its own device, or moved to ``device``) or a
    numpy array (sealed on ``device``, the CPU by default)."""
    raw, shape, dtype = _raw_bytes(array, device)
    blocked, n_bytes = ops.pack_u32(raw)
    del raw
    ciphertext = ops.seal_u32(key.key_words, nonce_words_for(key, name),
                              blocked, out=blocked)
    st = SealedTensor(name=name, ciphertext=ciphertext, mac=b"",
                      shape=shape, dtype=dtype, n_bytes=n_bytes)
    st.mac = _mac(key, st.header(), ciphertext)
    return st


def verify_mac(key: SealingKey, sealed: SealedTensor) -> None:
    """MAC-check a sealed tensor without decrypting it; raises
    :class:`IntegrityError` on mismatch, like :func:`unseal_tensor`."""
    expect = _mac(key, sealed.header(), sealed.ciphertext)
    if not hmac.compare_digest(expect, sealed.mac):
        raise IntegrityError(f"MAC mismatch for tensor '{sealed.name}'")


def ciphertext_page_bytes(sealed: SealedTensor) -> bytes:
    """Serialize blocked ciphertext to the linear RFC 8439 byte stream."""
    lin = ops.unpack_u32(sealed.ciphertext, sealed.n_bytes)
    return lin.cpu().numpy().tobytes()


def unseal_tensor(key: SealingKey, sealed: SealedTensor) -> torch.Tensor:
    """Verify, decrypt and unpack on the ciphertext's device. The reference
    unpacked through the host (its plaintext crossed to numpy and back); the
    port unpacks on the device, to the same bytes, so plaintext weights and
    KV never leave the card."""
    verify_mac(key, sealed)
    if sealed.dtype not in _DTYPES:
        raise TypeError(f"sealed tensor '{sealed.name}' has unknown dtype "
                        f"{sealed.dtype!r}")
    blocked = ops.unseal_u32(key.key_words, nonce_words_for(key, sealed.name),
                             sealed.ciphertext)
    raw = ops.unpack_u32(blocked, sealed.n_bytes)
    return raw.view(_DTYPES[sealed.dtype]).reshape(sealed.shape)


# ---------------------------------------------------------------------------
# trees: nested dicts and NamedTuples (QTensor, a train state) of tensor
# leaves, named like jax.tree_util.keystr
# ---------------------------------------------------------------------------

def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_leaves_with_names(tree: Params, path: str = ""
                           ) -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) over a nested dict in jax's flattening order (sorted
    keys); a name reads ``['a']['b']`` like ``jax.tree_util.keystr``. A
    NamedTuple flattens as jax flattens it, field by field in declaration
    order: a :class:`QTensor` as ``['w_gate'].values`` then ``.scale``, a
    train state as ``.params[...]``, ``.opt.m[...]``, ..., ``.opt.step``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_names(tree[k], f"{path}[{k!r}]")
    elif _is_namedtuple(tree):
        for field in tree._fields:
            yield from tree_leaves_with_names(getattr(tree, field),
                                              f"{path}.{field}")
    else:
        yield path, tree


def tree_map_with_names(fn, tree: Params, *rest: Params,
                        path: str = "") -> Params:
    """``fn(keystr, leaf, *leaves of rest)`` over every leaf of ``tree``
    (and the trees of the same structure in ``rest``), keeping the dict
    and NamedTuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_names(fn, v, *(r[k] for r in rest),
                                       path=f"{path}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map_with_names(fn, getattr(tree, f),
                                *(getattr(r, f) for r in rest),
                                path=f"{path}.{f}")
            for f in tree._fields))
    return fn(path, tree, *rest)


def tree_map(fn, tree: Params, *rest: Params) -> Params:
    """Apply ``fn`` to every leaf (and the matching leaves of ``rest``)
    through dicts and NamedTuples."""
    return tree_map_with_names(lambda _, *leaves: fn(*leaves), tree, *rest)


def seal_tree(key: SealingKey, tree: Params, prefix: str = "params",
              suffix: str = "") -> Dict[str, SealedTensor]:
    """Seal every leaf under ``prefix + keystr(path) + suffix``."""
    return {prefix + path + suffix: seal_tensor(key, prefix + path + suffix, leaf)
            for path, leaf in tree_leaves_with_names(tree)}


def unseal_tree(key: SealingKey, sealed: Dict[str, SealedTensor],
                treedef_like: Params, prefix: str = "params",
                suffix: str = "") -> Params:
    """Inverse of :func:`seal_tree` into the dict and NamedTuple structure
    of ``treedef_like`` (its leaves are not read)."""
    return tree_map_with_names(
        lambda path, _: unseal_tensor(key, sealed[prefix + path + suffix]),
        treedef_like)


def sealed_nbytes(sealed: Dict[str, SealedTensor]) -> int:
    """Total plaintext bytes a sealed dict carries (headers/MACs excluded)."""
    return sum(st.n_bytes for st in sealed.values())


def tree_digest(sealed: Dict[str, SealedTensor]) -> str:
    """Stable digest over all MACs — bound into the attestation measurement."""
    h = hashlib.sha256()
    for name in sorted(sealed):
        h.update(name.encode())
        h.update(sealed[name].mac)
    return h.hexdigest()
