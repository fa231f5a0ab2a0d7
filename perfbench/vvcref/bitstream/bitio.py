"""MSB-first bit writer/reader with exp-Golomb helpers.

Counterpart of the reference's bins.rs / binary_writer.rs / binary_reader.rs,
re-expressed as a Python bytearray-backed writer (and reader for the
conformance decoder).
"""


class BitWriter:
    def __init__(self):
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0  # bits in _cur (0..7)
        self.total_bits = 0

    def u(self, value, nbits):
        """Write fixed-width unsigned value, MSB first."""
        value = int(value)
        assert 0 <= value < (1 << nbits), (value, nbits)
        for i in range(nbits - 1, -1, -1):
            self.bit((value >> i) & 1)

    def bit(self, b):
        self._cur = (self._cur << 1) | (1 if b else 0)
        self._nbits += 1
        self.total_bits += 1
        if self._nbits == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._nbits = 0

    def ue(self, value):
        """Unsigned exp-Golomb."""
        value = int(value)
        assert value >= 0
        code = value + 1
        n = code.bit_length() - 1
        self.u(0, n) if n else None
        self.u(code, n + 1)

    def se(self, value):
        """Signed exp-Golomb."""
        value = int(value)
        if value == 0:
            self.ue(0)
        else:
            self.ue(2 * abs(value) - (1 if value > 0 else 0))

    def byte_align(self, bit=0):
        while self._nbits != 0:
            self.bit(bit)

    def rbsp_trailing(self):
        self.bit(1)
        self.byte_align(0)

    def bytes(self):
        assert self._nbits == 0, "not byte aligned"
        return bytes(self._bytes)


class BitReader:
    def __init__(self, data):
        self.data = data
        self.pos = 0  # bit position

    def bit(self):
        byte = self.data[self.pos >> 3]
        b = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def u(self, nbits):
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.bit()
        return v

    def ue(self):
        n = 0
        while self.bit() == 0:
            n += 1
            assert n < 64
        return (1 << n) - 1 + (self.u(n) if n else 0)

    def se(self):
        v = self.ue()
        if v == 0:
            return 0
        sign = 1 if v % 2 == 1 else -1
        return sign * ((v + 1) // 2)

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7

    @property
    def byte_pos(self):
        assert self.pos % 8 == 0
        return self.pos >> 3
