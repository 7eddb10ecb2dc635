"""Synthetic CTR datasets shaped like Criteo / Avazu (paper §4.1).

The port's own copy of ``repro/data/ctr_synth.py``: pure numpy, identical
operation for operation, so both packages draw byte-equal batches from the
same config (tests/test_torch_data.py holds them to that).  The port keeps a
copy instead of importing it because ``repro_torch`` never imports ``repro``.

Criteo/Avazu cannot be downloaded, so the generator builds a dataset with
the same *structure*: F categorical fields with power-law (Zipf) value
frequencies, and labels from a planted factorization-machine teacher —
first-order weights + pairwise latent interactions.

Feature ids are global: field f's values occupy [offset_f, offset_f + card_f),
matching the single-embedding-table layout CTR systems use.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CTRDatasetConfig:
    name: str
    n_fields: int
    cardinalities: tuple[int, ...]  # per-field number of distinct values
    teacher_rank: int = 8  # latent dim of the planted FM teacher
    zipf_a: float = 1.2  # power-law exponent for value frequencies
    label_noise: float = 0.1  # fraction of teacher logit replaced by noise
    seed: int = 0

    @property
    def n_features(self) -> int:
        return int(sum(self.cardinalities))

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.cardinalities)[:-1]]).astype(
            np.int64
        )


def _powerlaw_cards(n_fields: int, total: int, seed: int) -> tuple[int, ...]:
    """Field cardinalities spanning 4 orders of magnitude, like real CTR data."""
    rng = np.random.RandomState(seed)
    raw = np.exp(rng.uniform(np.log(4), np.log(total / 4), n_fields))
    raw = raw / raw.sum() * total
    return tuple(int(max(c, 4)) for c in raw)


def criteo_like(scale: float = 1.0, seed: int = 0) -> CTRDatasetConfig:
    """39 fields (26 categorical + 13 discretized numeric), ~1.1M features."""
    total = int(1_086_895 * scale)
    return CTRDatasetConfig(
        name="criteo-synth",
        n_fields=39,
        cardinalities=_powerlaw_cards(39, total, seed),
        seed=seed,
    )


def avazu_like(scale: float = 1.0, seed: int = 1) -> CTRDatasetConfig:
    """24 fields (21 categorical + hour/weekday/is_weekend), ~4.4M features."""
    total = int(4_428_293 * scale)
    return CTRDatasetConfig(
        name="avazu-synth",
        n_fields=24,
        cardinalities=_powerlaw_cards(24, total, seed),
        seed=seed,
    )


class CTRSynthetic:
    """Deterministic batch generator with train/valid/test splits.

    Batches are (ids int32 [B, F], labels float32 [B]); the generator is
    stateless in the sample index so any worker can reproduce any batch —
    this is what makes restart-replay (launch/train.py) exact.
    """

    def __init__(self, cfg: CTRDatasetConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        self.offsets = cfg.offsets
        # Planted teacher: first-order weight + rank-r latent per feature.
        n = cfg.n_features
        self.teacher_w = rng.normal(0.0, 1.0, n).astype(np.float32)
        self.teacher_v = rng.normal(
            0.0, 1.0 / np.sqrt(cfg.teacher_rank), (n, cfg.teacher_rank)
        ).astype(np.float32)
        self.bias = -0.7  # CTR datasets are imbalanced (~25% positive)
        # Zipf sampling tables per field (truncated, renormalized).
        self._field_probs = []
        for card in cfg.cardinalities:
            ranks = np.arange(1, card + 1, dtype=np.float64)
            p = ranks ** (-cfg.zipf_a)
            self._field_probs.append((p / p.sum()).astype(np.float64))

    def _sample_ids(self, rng: np.random.RandomState, batch: int) -> np.ndarray:
        cols = []
        for f, card in enumerate(self.cfg.cardinalities):
            vals = rng.choice(card, size=batch, p=self._field_probs[f])
            cols.append(vals + self.offsets[f])
        return np.stack(cols, axis=1).astype(np.int32)

    def _teacher_logit(self, ids: np.ndarray) -> np.ndarray:
        w = self.teacher_w[ids].sum(axis=1)
        v = self.teacher_v[ids]  # [B, F, r]
        s = v.sum(axis=1)
        pair = 0.5 * ((s * s).sum(axis=1) - (v * v).sum(axis=(1, 2)))
        # Normalize pair term so neither term dominates.
        return self.bias + 0.3 * w + 0.1 * pair

    def batch(self, split: str, index: int, batch_size: int):
        """Deterministic (ids, labels) for (split, index)."""
        salt = {"train": 0, "valid": 1_000_003, "test": 2_000_003}[split]
        rng = np.random.RandomState(
            (self.cfg.seed * 9_176_161 + salt + index) % (2**31 - 1)
        )
        ids = self._sample_ids(rng, batch_size)
        logit = self._teacher_logit(ids)
        noise = rng.normal(0.0, 1.0, batch_size)
        z = (1 - self.cfg.label_noise) * logit + self.cfg.label_noise * noise
        p = 1.0 / (1.0 + np.exp(-z))
        labels = (rng.uniform(size=batch_size) < p).astype(np.float32)
        return ids, labels

    def batches(self, split: str, batch_size: int, num_batches: int):
        for i in range(num_batches):
            yield self.batch(split, i, batch_size)
