"""Inputs shared by the port's tests. Imports neither JAX nor the JAX
package, so the card tests (``test_torch_gpu.py``) can use it where only
PyTorch is installed."""

import numpy as np


def tf32_ties(rng: np.random.Generator, shape) -> np.ndarray:
    """f32 values whose 13 bits below TF32's mantissa are exactly half a
    unit (ties for the rounding), of both signs and exponents 2^-20-2^20."""
    bits = rng.integers(0, 1 << 23, shape, dtype=np.int64) & ~0x1FFF | 0x1000
    bits |= (rng.integers(127 - 20, 127 + 20, shape, dtype=np.int64) << 23) | (rng.integers(0, 2, shape) << 31)
    return bits.astype(np.uint32).view(np.float32)
