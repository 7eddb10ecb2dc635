"""Synthetic LM token stream: deterministic, restart-replayable.

The port's own copy of ``repro/data/lm_synth.py``: pure numpy, identical
operation for operation, so both packages draw byte-equal batches from the
same seed and index (tests/test_torch_lm_train.py holds them to that).

Sequences come from a small order-2 hidden Markov chain over the vocabulary
(state -> state transitions, each state emitting from a small token subset),
so there is real signal for an LM to learn, unlike uniform random tokens.
"""
from __future__ import annotations

import numpy as np


class LMTokenStream:
    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0, n_states: int = 64):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed
        rng = np.random.RandomState(seed)
        self.n_states = n_states
        self.trans = rng.dirichlet(np.ones(n_states) * 0.1, size=n_states)
        self.emit_support = rng.randint(0, vocab_size, size=(n_states, 32))
        self.emit_probs = rng.dirichlet(np.ones(32) * 0.5, size=n_states)

    def batch(self, index: int, batch_size: int) -> np.ndarray:
        """Deterministic int32 [batch, seq_len + 1] (inputs + next-token labels)."""
        rng = np.random.RandomState((self.seed * 7_368_787 + index) % (2**31 - 1))
        out = np.zeros((batch_size, self.seq_len + 1), np.int32)
        state = rng.randint(0, self.n_states, size=batch_size)
        for t in range(self.seq_len + 1):
            u = rng.uniform(size=batch_size)
            cum = np.cumsum(self.emit_probs[state], axis=1)
            pick = (u[:, None] < cum).argmax(axis=1)
            out[:, t] = self.emit_support[state, pick]
            u2 = rng.uniform(size=batch_size)
            cumt = np.cumsum(self.trans[state], axis=1)
            state = (u2[:, None] < cumt).argmax(axis=1)
        return out

    def batches(self, batch_size: int, num_batches: int, start: int = 0):
        """``(tokens, labels)`` pairs of int32 [batch, seq_len]."""
        for i in range(start, start + num_batches):
            b = self.batch(i, batch_size)
            yield b[:, :-1], b[:, 1:]
