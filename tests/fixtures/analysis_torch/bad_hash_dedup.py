"""Seeded violation (torch twin of ``bad_hash_dedup.py``): hash-fingerprint
dedup in an engine module.

Colliding non-identical rows can interleave between equal rows and break
sort adjacency — the frontier balloons into spurious overflow. Dedup
must be EXACT (sort rows by full contents, merge neighbours)."""

import torch


def dedup_frontier(configs):
    fingerprints = [hash(tuple(c)) for c in configs]   # <- hash-dedup
    order = sorted(range(len(configs)),
                   key=lambda i: fingerprints[i])
    return torch.tensor([configs[i] for i in order])
