"""Prompt alignment shared by the serving engine: prompts are
right-padded with PAD up to the next block boundary."""

from __future__ import annotations


def pad_to_block(ids: list[int], block_size: int, pad_id: int) -> list[int]:
    r = len(ids) % block_size
    return ids + [pad_id] * (block_size - r) if r else ids
