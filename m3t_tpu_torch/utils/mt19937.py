"""Bit-exact ``std::mt19937`` for reference-parity model sampling (a copy of
m3t_tpu/utils/mt19937.py).

The reference samples sparse-viewpoint-model points with a per-view
``std::mt19937 generator{7}`` and raw ``generator() % size`` draws
(m3t/src/region_model.cpp:513-529, depth_model.cpp:316-350).  NumPy's MT19937
uses a different seeding routine (init_by_array), so parity requires this exact
implementation: libstdc++/libc++ seed with the classic ``init_genrand`` recurrence
``mt[i] = 1812433253 * (mt[i-1] ^ (mt[i-1] >> 30)) + i`` and produce the standard
tempered outputs.  The twist is vectorized in dependency-ordered chunks.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)


class StdMT19937:
    """Bit-exact twin of ``std::mt19937{seed}``; ``next()`` == ``generator()``."""

    def __init__(self, seed: int = 7):
        mt = np.empty(_N, np.uint64)
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            prev = int(mt[i - 1])
            mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF
        self._mt = mt.astype(np.uint32)
        self._buf = np.empty(0, np.uint32)
        self._pos = 0

    def _twist(self) -> None:
        mt = self._mt
        new = np.empty(_N, np.uint32)

        def step(dst, cur, nxt, far):
            y = (cur & _UPPER) | (nxt & _LOWER)
            new[dst] = far ^ (y >> np.uint32(1)) \
                ^ np.where(y & np.uint32(1), _MATRIX_A, np.uint32(0))

        # i in [0, 227): neighbours and mt[i+M] still hold OLD state.
        step(np.s_[0:_N - _M], mt[0:_N - _M], mt[1:_N - _M + 1], mt[_M:_N])
        # i in [227, 454): mt[i+M-N] == new[i-227] (already produced above).
        step(np.s_[_N - _M:2 * (_N - _M)], mt[_N - _M:2 * (_N - _M)],
             mt[_N - _M + 1:2 * (_N - _M) + 1], new[0:_N - _M])
        # i in [454, 623): depends on new[i - 227] == new[227:396] (chunk 2).
        step(np.s_[2 * (_N - _M):_N - 1], mt[2 * (_N - _M):_N - 1],
             mt[2 * (_N - _M) + 1:_N], new[_N - _M:_N - _M + (_N - 1) - 2 * (_N - _M)])
        # i == 623 wraps to new[0] and new[396].
        y = (mt[_N - 1] & _UPPER) | (new[0] & _LOWER)
        new[_N - 1] = new[_M - 1] ^ (y >> np.uint32(1)) \
            ^ (_MATRIX_A if y & np.uint32(1) else np.uint32(0))

        # Tempering (vectorized for the whole block).
        self._mt = new
        y = new.copy()
        y ^= y >> np.uint32(11)
        y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
        y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
        y ^= y >> np.uint32(18)
        self._buf = y
        self._pos = 0

    def next(self) -> int:
        """One raw draw, identical to ``operator()`` of ``std::mt19937``."""
        if self._pos >= len(self._buf):
            self._twist()
        v = int(self._buf[self._pos])
        self._pos += 1
        return v

    def draws(self, n: int) -> np.ndarray:
        """n raw draws as uint64 (for vectorized ``% size`` consumers)."""
        out = np.empty(n, np.uint64)
        for i in range(n):
            out[i] = self.next()
        return out
