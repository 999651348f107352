"""Byte-level tokenizer (vocab 256 + specials), a copy of
``repro.data.tokenizer``: the same ids for the same text."""

from __future__ import annotations

from typing import List

import numpy as np

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
VOCAB_SIZE = 259


class ByteTokenizer:
    vocab_size = VOCAB_SIZE
    pad_id = PAD_ID
    bos_id = BOS_ID
    eos_id = EOS_ID

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [BOS_ID] + ids
        if eos:
            ids = ids + [EOS_ID]
        return np.asarray(ids, np.int32)

    def decode(self, ids: List[int] | np.ndarray) -> str:
        raw = bytes(int(i) for i in np.asarray(ids).reshape(-1)
                    if 0 <= int(i) < 256)
        return raw.decode("utf-8", errors="replace")
