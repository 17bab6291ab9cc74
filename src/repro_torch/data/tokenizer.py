"""Byte-level tokenizer (the port's own copy of ``repro.data.tokenizer``).

ids 0..3 are specials, bytes live at 4..259.  [MASK] is not part of the
tokenizer: each model config reserves its own mask id.
"""

from __future__ import annotations

PAD_ID = 0
EOS_ID = 1
BOS_ID = 2
SEP_ID = 3
BYTE_OFFSET = 4
VOCAB_SIZE = 260


class ByteTokenizer:
    pad_id = PAD_ID
    eos_id = EOS_ID
    bos_id = BOS_ID
    sep_id = SEP_ID
    vocab_size = VOCAB_SIZE

    def encode(self, text: str, *, bos: bool = False,
               eos: bool = False) -> list[int]:
        ids = [BYTE_OFFSET + b for b in text.encode("utf-8")]
        if bos:
            ids = [BOS_ID] + ids
        if eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            if i == EOS_ID:
                break
            if BYTE_OFFSET <= i < BYTE_OFFSET + 256:
                out.append(i - BYTE_OFFSET)
        return out.decode("utf-8", errors="replace")
