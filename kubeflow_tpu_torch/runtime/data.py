"""Input batches (the port's own copy of kubeflow_tpu/runtime/data.py's
synthetic LM generator). numpy's default_rng from the same seed gives
batches bit-equal to the reference's."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_tokens(batch: int, seq_len: int, vocab: int = 32000,
                     seed: int = 0) -> Iterator[dict]:
    """Infinite synthetic LM batches: the same host batch every step, so
    the input pipeline costs ~0 and the step time is the device's."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (batch, seq_len + 1), dtype=np.int32)
    while True:
        yield {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
