"""The four assigned input shapes (a copy of ``repro.configs.shapes``).

``train_4k``    training step, 4096 x 256
``prefill_32k`` inference prefill, 32768 x 32
``decode_32k``  inference decode: ONE new token against a 32k KV cache
``long_500k``   long-context decode: ONE token against 512k state
                (sub-quadratic paths only: recurrent state or sliding window)
"""
from __future__ import annotations

from repro_torch.configs.base import (KIND_DECODE, KIND_PREFILL, KIND_TRAIN,
                                      ShapeConfig)

TRAIN_4K = ShapeConfig(
    name="train_4k", seq_len=4_096, global_batch=256, kind=KIND_TRAIN,
    num_slots=64, per_adapter_batch=4)   # paper: 60-64 concurrent configs

PREFILL_32K = ShapeConfig(
    name="prefill_32k", seq_len=32_768, global_batch=32, kind=KIND_PREFILL,
    num_slots=16, per_adapter_batch=2)

DECODE_32K = ShapeConfig(
    name="decode_32k", seq_len=32_768, global_batch=128, kind=KIND_DECODE,
    num_slots=16, per_adapter_batch=8)

LONG_500K = ShapeConfig(
    name="long_500k", seq_len=524_288, global_batch=1, kind=KIND_DECODE,
    num_slots=1, per_adapter_batch=1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
