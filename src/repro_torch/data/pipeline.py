"""Host-side data pipeline: deterministic, resumable, prefetching (port of
``repro/data/pipeline.py``; numpy only, the same draws for the same seed).

The corpus abstraction is a memory-mapped-style token matrix (synthetic here;
a real deployment swaps `synthetic_corpus` for array-record shards — the
Pipeline contract is unchanged). Batches are assembled on the host and fed
to the train step, which moves them to its device; `state()`/`restore()`
make the pipeline checkpointable so a restart resumes mid-epoch
(fault-tolerance requirement).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


def synthetic_corpus(n_docs: int, seq_len: int, vocab: int, seed: int = 0,
                     n_topics: int = 16) -> np.ndarray:
    """Topic-structured synthetic corpus (n_docs, seq_len+1).

    Each doc draws a topic with its own token distribution — gives the DPP
    batch selector real diversity structure to exploit.
    """
    rng = np.random.default_rng(seed)
    topics = rng.integers(0, n_topics, n_docs)
    # topic-conditional unigram tables, sharply peaked
    base = rng.random((n_topics, vocab)) ** 8
    base /= base.sum(-1, keepdims=True)
    out = np.empty((n_docs, seq_len + 1), np.int32)
    for t in range(n_topics):
        idx = np.nonzero(topics == t)[0]
        if len(idx) == 0:
            continue
        out[idx] = rng.choice(vocab, size=(len(idx), seq_len + 1), p=base[t])
    return out


@dataclasses.dataclass
class TokenPipeline:
    corpus: np.ndarray              # (n_docs, seq_len+1) int32
    batch_size: int
    seed: int = 0
    selector: Optional[object] = None    # DPPBatchSelector or None

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._step = 0

    # -- checkpointable state -------------------------------------------------
    def state(self) -> Dict:
        return {"step": self._step, "seed": self.seed}

    def restore(self, state: Dict) -> None:
        self.seed = state["seed"]
        self._rng = np.random.default_rng(self.seed)
        self._step = 0
        if self.selector is not None and hasattr(self.selector, "reset"):
            # device-backed selectors buffer prefetched samples; drop them so
            # the replayed rng stream regenerates identical draws
            self.selector.reset()
        while self._step < state["step"]:
            self._draw()          # replay for determinism

    # -- iteration ---------------------------------------------------------------
    def _draw(self) -> np.ndarray:
        self._step += 1
        if self.selector is not None:
            return self.selector.select(self._rng, self.batch_size)
        return self._rng.choice(self.corpus.shape[0], self.batch_size,
                                replace=False)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            idx = self._draw()
            yield {"tokens": self.corpus[idx]}
