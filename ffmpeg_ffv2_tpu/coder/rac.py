"""Binary adaptive range coder — bit-exact with the FFV1 bitstream.

This is the scalar Python oracle used to validate the C++ host coder and the
device kernels.  Semantics follow the FFV1 specification / the reference
implementation (libavcodec/rangecoder.{c,h}): byte-oriented renormalization
with carry propagation through an outstanding-byte chain, 8-bit adaptive
states with probability-evolution transition tables, and the two termination
flavours (version 0: size-carried; version 1: an extra state-129 zero bit).
"""

from __future__ import annotations

import numpy as np

# ff_build_rac_states(c, 0.05 * (1LL << 32), 256 - 8): the double->int
# conversion truncates, giving 214748364.
DEFAULT_RAC_FACTOR = int(0.05 * (1 << 32))
DEFAULT_RAC_MAX_P = 256 - 8

_ONE = 1 << 32


def build_rac_states(factor: int = DEFAULT_RAC_FACTOR,
                     max_p: int = DEFAULT_RAC_MAX_P):
    """Build (zero_state, one_state) uint8[256] transition tables.

    Mirrors the probability-evolution model of the reference
    (libavcodec/rangecoder.c:68-106): states are 8-bit probabilities; after
    coding a "one" the probability moves towards 1 by ``factor/2^32`` of the
    remaining gap.
    """
    one_state = np.zeros(256, dtype=np.int64)
    zero_state = np.zeros(256, dtype=np.int64)

    last_p8 = 0
    p = _ONE // 2
    for _ in range(128):
        p8 = (256 * p + _ONE // 2) >> 32
        if p8 <= last_p8:
            p8 = last_p8 + 1
        if last_p8 and last_p8 < 256 and p8 <= max_p:
            one_state[last_p8] = p8
        p += ((_ONE - p) * factor + _ONE // 2) >> 32
        last_p8 = p8

    for i in range(256 - max_p, max_p + 1):
        if one_state[i]:
            continue
        p = (i * _ONE + 128) >> 8
        p += ((_ONE - p) * factor + _ONE // 2) >> 32
        p8 = (256 * p + _ONE // 2) >> 32
        if p8 <= i:
            p8 = i + 1
        if p8 > max_p:
            p8 = max_p
        one_state[i] = p8

    for i in range(1, 255):
        zero_state[i] = 256 - one_state[256 - i]

    return zero_state.astype(np.uint8), one_state.astype(np.uint8)


# Default tables, shared by every coder instance that doesn't override them.
DEFAULT_ZERO_STATE, DEFAULT_ONE_STATE = build_rac_states()


class RangeEncoder:
    """Byte-oriented adaptive binary range encoder."""

    __slots__ = ("low", "range", "out", "outstanding_count", "outstanding_byte",
                 "zero_state", "one_state")

    def __init__(self, zero_state: np.ndarray | None = None,
                 one_state: np.ndarray | None = None):
        self.low = 0
        self.range = 0xFF00
        self.out = bytearray()
        self.outstanding_count = 0
        self.outstanding_byte = -1
        self.zero_state = (DEFAULT_ZERO_STATE if zero_state is None
                           else np.asarray(zero_state, dtype=np.uint8))
        self.one_state = (DEFAULT_ONE_STATE if one_state is None
                          else np.asarray(one_state, dtype=np.uint8))

    def set_state_tables(self, one_state: np.ndarray):
        """Install a custom one_state transition table (coder=range_tab)."""
        one = np.asarray(one_state, dtype=np.uint8).copy()
        zero = np.zeros(256, dtype=np.uint8)
        idx = np.arange(1, 256)
        zero[256 - idx] = (256 - one[idx].astype(np.int64)).astype(np.uint8)
        self.one_state = one
        self.zero_state = zero

    def _renorm(self):
        while self.range < 0x100:
            if self.outstanding_byte < 0:
                self.outstanding_byte = self.low >> 8
            elif self.low <= 0xFF00:
                self.out.append(self.outstanding_byte)
                self.out.extend(b"\xFF" * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = self.low >> 8
            elif self.low >= 0x10000:
                self.out.append((self.outstanding_byte + 1) & 0xFF)
                self.out.extend(b"\x00" * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = (self.low >> 8) & 0xFF
            else:
                self.outstanding_count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def put(self, states: np.ndarray, idx: int, bit: int):
        """Code one bit with the adaptive state ``states[idx]``."""
        s = int(states[idx])
        range1 = (self.range * s) >> 8
        if not bit:
            self.range -= range1
            states[idx] = self.zero_state[s]
        else:
            self.low += self.range - range1
            self.range = range1
            states[idx] = self.one_state[s]
        self._renorm()

    def put_fixed(self, bit: int, prob: int = 128):
        """Code a bit with a throwaway state (no adaptation persists)."""
        st = np.array([prob], dtype=np.uint8)
        self.put(st, 0, bit)

    def terminate(self, version: int) -> bytes:
        """Flush; version 1 writes the state-129 terminator bit first."""
        if version == 1:
            st = np.array([129], dtype=np.uint8)
            self.put(st, 0, 0)
        self.range = 0xFF
        self.low += 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        assert self.low == 0
        return bytes(self.out)


class RangeDecoder:
    """Mirror of :class:`RangeEncoder` (libavcodec/rangecoder.h:123-152)."""

    __slots__ = ("low", "range", "buf", "pos", "end", "overread",
                 "zero_state", "one_state")

    MAX_OVERREAD = 2

    def __init__(self, data: bytes, zero_state: np.ndarray | None = None,
                 one_state: np.ndarray | None = None):
        self.buf = data
        self.low = int.from_bytes(data[0:2], "big") if len(data) >= 2 else 0
        self.pos = 2
        self.end = len(data)
        self.range = 0xFF00
        self.overread = 0
        if self.low >= 0xFF00:
            self.low = 0xFF00
            self.end = self.pos
        self.zero_state = (DEFAULT_ZERO_STATE if zero_state is None
                           else np.asarray(zero_state, dtype=np.uint8))
        self.one_state = (DEFAULT_ONE_STATE if one_state is None
                          else np.asarray(one_state, dtype=np.uint8))

    def set_state_tables(self, one_state: np.ndarray):
        one = np.asarray(one_state, dtype=np.uint8).copy()
        zero = np.zeros(256, dtype=np.uint8)
        idx = np.arange(1, 256)
        zero[256 - idx] = (256 - one[idx].astype(np.int64)).astype(np.uint8)
        self.one_state = one
        self.zero_state = zero

    def _refill(self):
        if self.range < 0x100:
            self.range <<= 8
            self.low <<= 8
            if self.pos < self.end:
                self.low += self.buf[self.pos]
                self.pos += 1
            else:
                self.overread += 1

    def get(self, states: np.ndarray, idx: int) -> int:
        s = int(states[idx])
        range1 = (self.range * s) >> 8
        self.range -= range1
        if self.low < self.range:
            states[idx] = self.zero_state[s]
            self._refill()
            return 0
        else:
            self.low -= self.range
            states[idx] = self.one_state[s]
            self.range = range1
            self._refill()
            return 1

    def get_fixed(self, prob: int = 128) -> int:
        st = np.array([prob], dtype=np.uint8)
        return self.get(st, 0)

    def bytes_consumed(self) -> int:
        return self.pos
