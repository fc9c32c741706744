"""``jax.random``'s default stream in numpy: the port's draw of the reference's
random numbers, bit for bit, without JAX (ROADMAP faults F4 and F11).

The reference draws the ``RandomCosts`` baseline as
``jax.random.uniform(jax.random.PRNGKey(ticks), (F,), minval=1, maxval=100)``
(``fitslam_tpu/models/costs.py``, key made in ``models/exploration.py``).
This module reproduces that draw for the JAX of this repository's
environment (0.9.0, ``jax_threefry_partitionable`` on, which is also the
default of JAX 0.5 and later):

- ``prng_key(seed)``: the raw Threefry key of ``PRNGKey(seed)``, (2,)
  uint32 = (0, seed mod 2**32): with 64-bit types off, as here, JAX takes
  the seed as a 32-bit integer, so the high word is 0;
- ``threefry_2x32``: the Threefry-2x32 block cipher, 20 rounds, as
  ``jax._src.prng.threefry_2x32``;
- ``uniform(key, shape, minval, maxval)``: float32 uniforms. The counter of
  element i is the 64-bit index i split into two words (the partitionable
  scheme); the 32 random bits are the two output words XOR-ed; the top 23
  bits become the mantissa of a float in [1, 2), minus 1; then
  ``floats * (maxval - minval) + minval``, which XLA's CPU compiler
  contracts into one fused multiply-add, so it is formed here as a float64
  product and sum rounded once to float32 (ROADMAP F13); then
  ``max(minval, .)``.

Everything is host numpy ``uint32``/``float32``: the caller uploads the draw
(``utils/transfer.upload``). ``tests/test_torch_frontier_roadmap.py`` holds
it bit-equal to ``jax.random``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def prng_key(seed: int) -> np.ndarray:
    """The raw (2,) uint32 key of ``jax.random.PRNGKey(seed)`` with 64-bit
    types off."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry_2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    (2,) uint32 key; uint32 arithmetic wraps as the cipher requires."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)`` under the partitionable
    Threefry scheme."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry_2x32(key, hi, lo)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key: np.ndarray, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(32 - 23)) | one).view(np.float32) - np.float32(1.0)
    span = np.float64(hi - lo)
    scaled = (floats.astype(np.float64) * span + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)
