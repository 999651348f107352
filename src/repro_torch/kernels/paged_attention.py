"""Paged decode attention, and its fused-unseal variant: kernels B3 and B4.

Port of ``repro.kernels.paged_attention`` (the Pallas kernels
``paged_attention`` and ``paged_attention_unseal``). One decode token per
slot attends over one layer's page pool by walking the page table: no dense
gather. Layout is the reference's: q ``[slots, heads, head_dim]``, pools
``[num_pages+1, page_size, kv_heads, head_dim]`` (page 0 is the null page),
table ``[slots, max_pages]`` int32, valid ``[slots]`` int32 (the slot attends
to positions < valid). Pages wholly past ``valid`` are skipped and the
in-page tail is masked to :data:`NEG_INF`; the update per page is the
reference's online softmax in f32.

``paged_attention_unseal`` reads pools whose pages may be ciphertext: a page
whose sidecar row ``[nonce0, nonce1, nonce2, live]`` (uint32 bits, int32 here)
has a live flag is XORed with its ChaCha20 keystream before use. Linear word
w of the page's bytes takes word ``w % 16`` of block ``layer * bpp + w // 16``.

On the card the work is the hand-written CUDA kernel
``csrc/paged_attention.cu``, split-KV decode attention: the table's columns
are cut into splits of :func:`split_geometry`'s size, one CTA per (split,
kv head, slot) writes f32 partials, and a second launch merges them in split
order. A tensor on the CPU goes to the plain version (:func:`_emulated_walk`,
the reference's page walk as torch loops over the table's columns).
``chip_smoke.py`` also runs the plain version on the card, as the reference
the kernel is held to. :func:`_split_walk` is the kernel's split-and-combine
walk in torch, and :func:`_unseal_head_rows` its keystream stage (which
blocks the producer warps compute, where they store them, and which word
each consumer lane XORs), for the tests only.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.chacha20 import _MASK, _words, chacha_block_words

NEG_INF = -1e30

# pool dtypes the in-kernel XOR path supports; anything else restores
# through the host-decrypt path instead
FUSED_DTYPES = (torch.float32, torch.bfloat16)
# the largest row of one head the kernel takes (csrc: 32 lanes x kMaxWords)
MAX_ROW_BYTES = 1024

# Launches of each CUDA kernel since the last reset (the plain version never
# counts): a run reads them to show the main path went through the kernels.
# One wrapper call counts one, though it launches the split pass and the
# combine pass.
launches = {"paged_attention": 0, "paged_attention_unseal": 0}

# The kernel's split of a walk: about SPLITS splits of the table, each at
# least SPLIT_POSITIONS[0] and at most SPLIT_POSITIONS[1] positions (whole
# pages). Measured on an H100 at Llama2-7B's decode shapes (PERF.md): of
# 32, 64 and 128 positions a split, 32 was fastest on a 16-page table (the
# serving path's call and the engine's decode step) and 128 on a 128-page
# table (16 slots x 2048 positions).
SPLITS = 8
SPLIT_POSITIONS = (32, 128)


def split_geometry(max_pages: int, page_size: int) -> tuple[int, int]:
    """(pages per split, number of splits) of the kernel's walk over a table
    ``max_pages`` wide. It reads the table width and the page size only,
    never the batch or any slot's ``valid``: a slot's splits, and so its
    output bits, are the same alone and in any batch."""
    lo = max(1, -(-SPLIT_POSITIONS[0] // page_size))
    hi = max(lo, SPLIT_POSITIONS[1] // page_size)
    per = min(max(-(-max_pages // SPLITS), lo), hi)
    return per, -(-max_pages // per)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# B4's keystream stage (csrc/paged_attention.cu): PRODUCERS threads beside
# the 4 consumer warps fill a ring of KS_STAGES pages; a block's 16 words,
# then the next block's KS_STRIDE words on, so a warp's 32 stores of one
# word of 32 blocks fall into 32 banks
PRODUCERS, KS_STAGES, KS_STRIDE = 128, 2, 17


def keystream_slots(kh: int, hk: int, ps: int,
                    row_words: int) -> tuple[list, list]:
    """The ChaCha20 blocks (page-relative) that touch kv head ``kh``'s rows
    of a page of ``ps`` rows, each once and in order, as the kernel lists
    them at CTA start, and ``row_slot[t]``: the slot of row t's first
    block (its later blocks follow). Rows that share a block count it
    once."""
    blocks: list = []
    row_slot: list = []
    last = -1
    for t in range(ps):
        w0 = (t * hk + kh) * row_words
        b0, b1 = w0 >> 4, (w0 + row_words - 1) >> 4
        row_slot.append(len(blocks) - 1 if b0 <= last else len(blocks))
        blocks.extend(range(max(last + 1, b0), b1 + 1))
        last = b1
    return blocks, row_slot


def keystream_blocks(hk: int, ps: int, row_words: int) -> int:
    """Keystream slots a B4 CTA keeps per page for K (and as many for V):
    the most over the kv heads (the host's sizing of the ring)."""
    return max(len(keystream_slots(kh, hk, ps, row_words)[0])
               for kh in range(hk))


def supports_fused_unseal(dtype, page_bytes: int) -> bool:
    """True when a page of this dtype can be decrypted in-kernel: the page
    covers whole ChaCha20 blocks (64 B) and is f32 or bf16."""
    return page_bytes % 64 == 0 and dtype in FUSED_DTYPES


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or uint32) bits -> int64 holding the uint32 values."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & _MASK


def _page_keystream(key_words, nonce_words, layer: int, bpp: int,
                    device="cpu") -> torch.Tensor:
    """Linear keystream of one page, or of a row of pages: ``bpp`` ChaCha20
    blocks at counter_base = layer * bpp, word i = word i % 16 of block
    i // 16. Nonce words are ints, or int64 ``[n, 1]`` tensors (one nonce
    per page). Returns int64 ``[bpp * 16]`` (or ``[n, bpp * 16]``) of uint32
    values."""
    counters = (torch.arange(bpp, dtype=torch.int64, device=device)
                + int(layer) * bpp) & _MASK
    words = chacha_block_words(_words(key_words, 8), list(nonce_words),
                               counters)
    ks = torch.stack(words, dim=-1)                 # [..., bpp, 16]
    return ks.reshape(*ks.shape[:-2], bpp * 16)


def _unseal_tile(tile: torch.Tensor, crypt_row: torch.Tensor, key_words,
                 layer: int, bpp: int) -> torch.Tensor:
    """XOR page tiles with their keystream where the crypt flag is live.
    ``tile`` is one page ``[ps, hk, hd]`` with ``crypt_row [4]``, or a row
    of pages ``[n, ps, hk, hd]`` with ``[n, 4]``. A dead flag passes the
    bits through unchanged. f32 pages XOR whole u32 words; bf16 element e
    takes the low half of word e // 2 when e is even, the high half when
    odd (little-endian bytes)."""
    single = crypt_row.dim() == 1
    if single:
        tile, crypt_row = tile[None], crypt_row[None]
    n = tile.shape[0]
    crypt = _u32(crypt_row)
    live = (crypt[:, 3] != 0)[:, None]
    ks32 = _page_keystream(key_words, [crypt[:, i:i + 1] for i in range(3)],
                           layer, bpp, tile.device)            # [n, bpp*16]
    if tile.dtype == torch.float32:
        bits = tile.reshape(n, -1).view(torch.int32)
        ks = torch.where(ks32 >= 2**31, ks32 - 2**32, ks32).to(torch.int32)
    elif tile.dtype == torch.bfloat16:
        bits = tile.reshape(n, -1).view(torch.int16)
        ks16 = torch.stack([ks32 & 0xFFFF, ks32 >> 16], dim=-1).reshape(n, -1)
        ks = torch.where(ks16 >= 2**15, ks16 - 2**16, ks16).to(torch.int16)
    else:
        raise TypeError(f"no fused unseal for {tile.dtype} pages")
    plain = torch.where(live, bits ^ ks, bits).view(tile.dtype)
    out = plain.reshape(tile.shape)
    return out[0] if single else out


def _unseal_head_rows(tile: torch.Tensor, crypt_row: torch.Tensor, key_words,
                      layer: int, bpp: int, kh: int) -> torch.Tensor:
    """Kernel B4's keystream stage in torch (tests only): one page ``[ps,
    hk, hd]`` with its sidecar row, kv head ``kh``'s rows ``[ps, hd]``. The
    producers fill the ring (slot b at ``b * KS_STRIDE``) with block
    ``counter_base + blocks[b]``; the lane reading word w of row t XORs
    ring word ``(row_slot[t] + off // 16) * KS_STRIDE + off % 16`` with
    ``off = w0 % 16 + w``, w0 the row's first page word: for the lane's
    words w = lane + 32 i, the word for i = 0 plus ``2 * KS_STRIDE * i``.
    A dead page computes no keystream and passes through."""
    ps, hk, hd = tile.shape
    rows = tile[:, kh].contiguous()
    crypt = _u32(crypt_row)
    if int(crypt[3]) == 0:
        return rows
    bits = rows.view(torch.int32)                   # [ps, row_words]
    row_words = bits.shape[1]
    blocks, row_slot = keystream_slots(kh, hk, ps, row_words)
    counters = (torch.tensor(blocks, dtype=torch.int64)
                + int(layer) * bpp) & _MASK
    words = chacha_block_words(_words(key_words, 8),
                               [int(crypt[i]) for i in range(3)], counters)
    ring = torch.zeros(len(blocks) * KS_STRIDE, dtype=torch.int64)
    slots = torch.arange(len(blocks)) * KS_STRIDE
    for w, ks in enumerate(words):
        ring[slots + w] = ks
    t = torch.arange(ps)[:, None]
    w0 = (t * hk + kh) * row_words
    w = torch.arange(row_words)[None, :]
    off = (w0 & 15) + w % 32               # lane = w % 32, i = w // 32
    idx = ((torch.tensor(row_slot)[:, None] + (off >> 4)) * KS_STRIDE
           + (off & 15) + 2 * KS_STRIDE * (w // 32))
    ks = ring[idx]
    ks = torch.where(ks >= 2**31, ks - 2**32, ks).to(torch.int32)
    return (bits ^ ks).view(tile.dtype)


def _attend_page_math(q32, k, v, j: int, valid, m_prev, l_prev, acc_prev, *,
                      scale: float, page_size: int):
    """One online-softmax update over one page per slot (GQA batched over
    kv heads): q32 ``[b, h, hd]`` f32; k/v ``[b, ps, hk, hd]`` (any float
    dtype); valid ``[b]``; m/l ``[b, h, 1]``, acc ``[b, h, hd]``."""
    b, h, hd = q32.shape
    hk = k.shape[2]
    g = h // hk
    qg = q32.reshape(b, hk, g, hd)
    kt = k.float().permute(0, 2, 1, 3)                  # [b, hk, ps, hd]
    s = torch.einsum("bkgd,bkpd->bkgp", qg, kt) * scale
    k_pos = j * page_size + torch.arange(page_size, device=q32.device)
    live = k_pos < valid[:, None]                       # [b, ps]
    s = torch.where(live[:, None, None, :], s,
                    NEG_INF).reshape(b, h, page_size)

    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)                            # [b, h, ps]
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + p.sum(dim=-1, keepdim=True)
    # rows past valid are never read, as in the kernel: a page's stale tail
    # may hold anything (a freed ciphertext-resident page keeps its
    # ciphertext bits), and 0 * NaN would poison the sum
    vt = torch.where(live[:, :, None, None], v.float(),
                     0.0).permute(0, 2, 1, 3)           # [b, hk, ps, hd]
    pv = torch.einsum("bkgp,bkpd->bkgd", p.reshape(b, hk, g, page_size), vt)
    return m_new, l_new, acc_prev * alpha + pv.reshape(b, h, hd)


def _walk_state(table, valid, q32, k_pool, v_pool, cols, unseal=None):
    """The page walk over table columns ``cols`` in plain torch: every
    slot's page of a column loaded at once, the same update per page, and
    slots whose ``valid`` ends before the column keeping their state.
    Returns (m, l, acc): ``[b, h, 1]``, ``[b, h, 1]``, ``[b, h, hd]``."""
    b, h, hd = q32.shape
    ps = k_pool.shape[1]
    scale = 1.0 / np.sqrt(hd)
    m = torch.full((b, h, 1), NEG_INF, dtype=torch.float32, device=q32.device)
    l = torch.zeros((b, h, 1), dtype=torch.float32, device=q32.device)
    acc = torch.zeros((b, h, hd), dtype=torch.float32, device=q32.device)
    for j in cols:
        phys = table[:, j].long()
        k, v = k_pool[phys], v_pool[phys]
        if unseal is not None:
            k, v = unseal(phys, k, v)
        m2, l2, a2 = _attend_page_math(q32, k, v, j, valid, m, l, acc,
                                       scale=scale, page_size=ps)
        live = (j * ps < valid)[:, None, None]
        m = torch.where(live, m2, m)
        l = torch.where(live, l2, l)
        acc = torch.where(live, a2, acc)
    return m, l, acc


@torch.inference_mode()
def _emulated_walk(table, valid, q, k_pool, v_pool, unseal=None):
    """The reference's page walk in plain torch, one state over every
    column up to the largest ``valid`` (columns past every slot's ``valid``
    are not visited)."""
    valid = valid.to(torch.int32)
    top = int(valid.max()) if q.shape[0] else 0
    cols = range(min(table.shape[1], -(-top // k_pool.shape[1])))
    _, l, acc = _walk_state(table, valid, q.float(), k_pool, v_pool, cols,
                            unseal)
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


@torch.inference_mode()
def _split_walk(table, valid, q, k_pool, v_pool, unseal=None):
    """The kernel's split-and-combine walk in plain torch (tests only):
    every split of :func:`split_geometry` walks its own columns from the
    empty state, then the splits merge in split order, m = max m_i,
    l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m),
    out = acc / max(l, 1e-30). A split past a slot's ``valid`` keeps the
    empty state and adds exact zeros."""
    per, n_splits = split_geometry(table.shape[1], k_pool.shape[1])
    valid = valid.to(torch.int32)
    parts = [_walk_state(table, valid, q.float(), k_pool, v_pool,
                         range(i * per, min((i + 1) * per, table.shape[1])),
                         unseal) for i in range(n_splits)]
    m = parts[0][0]
    for mi, _, _ in parts[1:]:
        m = torch.maximum(m, mi)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for mi, li, ai in parts:
        w = torch.exp(mi - m)
        l = l + li * w
        acc = acc + ai * w
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def paged_attention_plain(q, k_pool, v_pool, table, valid):
    """The plain version of :func:`paged_attention`, on any device."""
    return _emulated_walk(table, valid, q, k_pool, v_pool)


def paged_attention_unseal_plain(q, k_pool, v_pool, table, valid, layer,
                                 key_words, k_crypt, v_crypt, *,
                                 blocks_per_page: int):
    """The plain version of :func:`paged_attention_unseal`, on any device."""
    kw = _words(key_words, 8)

    def unseal(phys, k, v):
        return (_unseal_tile(k, k_crypt[phys], kw, layer, blocks_per_page),
                _unseal_tile(v, v_crypt[phys], kw, layer, blocks_per_page))

    return _emulated_walk(table, valid, q, k_pool, v_pool, unseal=unseal)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _kernel_fn():
    from repro_torch.kernels import build
    fn = build.load("paged_attention.cu").repro_paged_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p,           # q k v table valid out
                                                     # part_acc part_ml
                   i, i, i, i, i, i, i, i,           # b h hk hd ps pages
                                                     # per_split bf16
                   ctypes.c_float,                   # scale
                   p, p, ctypes.POINTER(ctypes.c_uint32),  # crypts, key
                   ctypes.c_uint32, p]               # counter_base, stream
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, table, valid) -> None:
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"want q [b, h, hd] and pools [P+1, ps, hk, hd], got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    b, h, hd = q.shape
    _, _, hk, phd = k_pool.shape
    if phd != hd or h % hk:
        raise ValueError(f"head_dim {hd} vs {phd}, heads {h} vs kv heads {hk}")
    if q.dtype not in FUSED_DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q and pools must share one dtype of {FUSED_DTYPES}, "
                        f"got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if table.dtype != torch.int32 or valid.dtype != torch.int32:
        raise TypeError("table and valid must be int32")
    if table.dim() != 2 or table.shape[0] != b or tuple(valid.shape) != (b,):
        raise ValueError(f"want table [{b}, max_pages] and valid [{b}], got "
                         f"{tuple(table.shape)}, {tuple(valid.shape)}")
    ts = (q, k_pool, v_pool, table, valid)
    if len({t.device for t in ts}) != 1:
        raise ValueError("q, pools, table and valid must share one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("q, pools, table and valid must be contiguous")


def _launch(name, q, k_pool, v_pool, table, valid, crypts=(None, None),
            key=(0,) * 8, counter_base=0):
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for device {q.device}")
    b, h, hd = q.shape
    _, ps, hk, _ = k_pool.shape
    if (hd * q.element_size()) % 4 or hd * q.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"a head's row must be whole u32 words of at most "
                         f"{MAX_ROW_BYTES} B, got hd={hd} in {q.dtype}")
    per, n_splits = split_geometry(table.shape[1], ps)
    out = torch.empty_like(q)
    part_acc = torch.empty((b, h, n_splits, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, h, n_splits, 2), dtype=torch.float32,
                          device=q.device)
    fn = _kernel_fn()
    kc, vc = (c.data_ptr() if c is not None else None for c in crypts)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                table.data_ptr(), valid.data_ptr(), out.data_ptr(),
                part_acc.data_ptr(), part_ml.data_ptr(),
                b, h, hk, hd, ps, table.shape[1], per,
                int(q.dtype == torch.bfloat16), float(1.0 / np.sqrt(hd)),
                kc, vc, (ctypes.c_uint32 * 8)(*key), counter_base & _MASK,
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1     # one per call: the split and combine passes
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, table: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Decode attention over a paged KV pool, no dense gather. Returns
    ``[slots, heads, head_dim]`` in q's dtype; rows whose table maps
    nowhere (idle slots) produce values the engine discards.

    A CUDA tensor launches the kernel (building it on first use) and raises
    if it cannot; a CPU tensor goes to the plain version."""
    _check(q, k_pool, v_pool, table, valid)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, table, valid)
    return _launch("paged_attention", q, k_pool, v_pool, table, valid)


def paged_attention_unseal(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           valid: torch.Tensor, layer: int, key_words,
                           k_crypt: torch.Tensor, v_crypt: torch.Tensor, *,
                           blocks_per_page: int) -> torch.Tensor:
    """:func:`paged_attention` over a pool whose pages may be ciphertext.
    ``k_crypt``/``v_crypt`` ``[num_pages+1, 4]`` int32 (or uint32) sidecars:
    words 0-2 the page blob's nonce, word 3 the live flag (0 = plaintext,
    passed through bit for bit). ``layer`` is the layer ordinal
    (counter_base = layer * blocks_per_page); ``key_words`` the 8 key
    words. Same device rule as :func:`paged_attention`."""
    _check(q, k_pool, v_pool, table, valid)
    _, ps, hk, hd = k_pool.shape
    page_bytes = ps * hk * hd * k_pool.element_size()
    if page_bytes != blocks_per_page * 64:
        raise ValueError(f"page of {page_bytes} B is not {blocks_per_page} "
                         f"ChaCha20 blocks")
    for c in (k_crypt, v_crypt):
        if (c.dtype not in (torch.int32, torch.uint32)
                or tuple(c.shape) != (k_pool.shape[0], 4)
                or c.device != q.device or not c.is_contiguous()):
            raise ValueError(f"sidecars must be contiguous int32 "
                             f"[{k_pool.shape[0]}, 4] on {q.device}")
    if q.device.type == "cpu":
        return paged_attention_unseal_plain(
            q, k_pool, v_pool, table, valid, layer, key_words, k_crypt,
            v_crypt, blocks_per_page=blocks_per_page)
    return _launch("paged_attention_unseal", q, k_pool, v_pool, table, valid,
                   crypts=(k_crypt, v_crypt), key=_words(key_words, 8),
                   counter_base=int(layer) * blocks_per_page)
