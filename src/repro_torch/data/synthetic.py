"""[Copy of repro/data/synthetic.py — numpy only, verbatim apart from imports.]

Synthetic datasets.

No real CIFAR/TinyImageNet is available offline, so the faithful FedDPC
reproduction trains on *class-conditional structured images*: each class
is a Gaussian mixture around a class template with per-class frequency
patterns — learnable by LeNet/ResNet but non-trivial, giving the same
qualitative optimization landscape (heterogeneous multi-class vision).

LM token streams (for the federated LLM substrate) are Zipf-sampled with
per-client topic skew.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_image_dataset(num_classes: int, samples_per_class: int,
                       image_size: int = 32, channels: int = 3,
                       seed: int = 0, noise: float = 0.35
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """-> images (N, H, W, C) float32 in [-1, 1], labels (N,) int32."""
    rng = np.random.RandomState(seed)
    h = w = image_size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    templates = []
    for c in range(num_classes):
        fx, fy = 1 + (c % 5), 1 + ((c // 5) % 5)
        phase = 2 * np.pi * (c / max(num_classes, 1))
        base = (np.sin(2 * np.pi * fx * xx / w + phase)
                * np.cos(2 * np.pi * fy * yy / h))
        chans = np.stack([np.roll(base, shift=k * 3, axis=1)
                          for k in range(channels)], axis=-1)
        templates.append(chans)
    templates = np.stack(templates)                    # (C, H, W, ch)

    images = np.empty((num_classes * samples_per_class, h, w, channels),
                      np.float32)
    labels = np.empty((num_classes * samples_per_class,), np.int32)
    for c in range(num_classes):
        sl = slice(c * samples_per_class, (c + 1) * samples_per_class)
        jitter = rng.randn(samples_per_class, 1, 1, 1).astype(np.float32) * 0.2
        images[sl] = (templates[c][None] * (1 + jitter)
                      + noise * rng.randn(samples_per_class, h, w, channels))
        labels[sl] = c
    perm = rng.permutation(len(labels))
    return np.clip(images[perm], -3, 3), labels[perm]


def make_lm_dataset(num_docs: int, seq_len: int, vocab_size: int,
                    seed: int = 0, num_topics: int = 16
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Zipf token streams with topic structure.
    -> tokens (N, S) int32, topic (N,) int32 (the heterogeneity label)."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    base = 1.0 / ranks ** 1.1
    tokens = np.empty((num_docs, seq_len), np.int32)
    topics = rng.randint(0, num_topics, size=num_docs).astype(np.int32)
    for topic in range(num_topics):
        idx = np.where(topics == topic)[0]
        if len(idx) == 0:
            continue
        boost = np.ones(vocab_size)
        boost_idx = np.random.RandomState(seed * 997 + topic).choice(
            vocab_size, size=max(vocab_size // 20, 1), replace=False)
        boost[boost_idx] *= 8.0
        p = base * boost
        p /= p.sum()
        tokens[idx] = np.random.RandomState(seed * 31 + topic).choice(
            vocab_size, size=(len(idx), seq_len), p=p).astype(np.int32)
    return tokens, topics
