"""The JAX package's epoch permutation of a device-resident dataset, drawn
on the device as JAX draws it (pathtracker_tpu/data/resident.py:164-176):

    jax.random.permutation(fold_in(fold_in(key(seed), epoch), dev), n)

(``dev`` the card's index in the data mesh, 0 on one card) with the
installed JAX's default ``jax_threefry_partitionable``: a Threefry-2x32 key
from the seed, two fold-ins, then
``ceil(3 ln n / ln(2^32 - 1))`` rounds (jax._src.random._shuffle) of a
split and a stable sort of the running order by fresh 32-bit draws. One
round up to n = 1,625, two up to 6.6e9.

Every uint32 lives in an int64 tensor and is masked after each add, so the
arithmetic is exact on any device. The keys are a few words, hashed on the
host; the n draws and the sorts run on the device. Both packages' sorts are
stable, so clips whose 32-bit keys collide keep their order from the
previous round in both; tests/test_torch_resident.py holds the result to
JAX's.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1) under the key
    (k1, k2), as jax._src.prng's lowering; int64 tensors holding uint32."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _hash(k: tuple[int, int], counters) -> list[tuple[int, int]]:
    """Threefry of (0, c) for each counter c, on the host: a key's words."""
    c = torch.tensor(counters, dtype=torch.int64)
    y0, y1 = threefry2x32(*k, torch.zeros_like(c), c)
    return list(zip(y0.tolist(), y1.tolist()))


def key(seed: int) -> tuple[int, int]:
    """jax.random.key(seed) for a seed below 2**31: (0, seed)."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2**31)")
    return (0, seed)


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """jax.random.fold_in(k, data): Threefry of the counter (0, data)."""
    return _hash(k, [int(data) & _MASK])[0]


def split(k: tuple[int, int]) -> tuple[tuple[int, int], tuple[int, int]]:
    """The two keys of jax.random.split(k) (partitionable): Threefry of the
    counters (0, 0) and (0, 1)."""
    first, second = _hash(k, [0, 1])
    return first, second


def random_bits(k: tuple[int, int], n: int, device):
    """jax.random.bits(k, (n,)) in 32 bits (partitionable): the two words of
    Threefry over the counters (0, i), XORed."""
    y0, y1 = threefry2x32(*k, torch.zeros(n, dtype=torch.int64, device=device),
                          torch.arange(n, device=device))
    return y0 ^ y1


def permutation(k: tuple[int, int], n: int, device):
    """jax.random.permutation(k, n) as an int64 tensor on ``device``."""
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_MASK))
    order = torch.arange(n, device=device)
    for _ in range(rounds):
        k, sub = split(k)
        sort_keys = random_bits(sub, n, device)
        order = order[torch.sort(sort_keys, stable=True).indices]
    return order


def epoch_permutation(seed: int, epoch: int, n: int, device, dev: int = 0):
    """The permutation of a card's ``n`` resident clips for ``epoch``: the
    key folded with the epoch, then with ``dev``, the card's index in the
    data mesh (0 on one card), as make_resident_train_step draws it."""
    k = fold_in(fold_in(key(seed), epoch), dev)
    return permutation(k, n, device)
