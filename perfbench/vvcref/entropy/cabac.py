"""VVC CABAC arithmetic engine — encoder and decoder (spec 9.3.4 / 9.3.3).

Dual-window probability model: each context keeps two estimates
state0 (10-bit) / state1 (14-bit) with per-context adaptation shifts
(window sizes) from the Table-51 shiftIdx data. Engine behaviour matches
the spec exactly; cf. the reference engine in bool_coder.rs:86-296
(init :1073, per-bin decision :254, renorm/bits-outstanding :157,
bypass :202, terminate :218).

Contexts are stored per syntax element id (SE numbering in core.tables.SE),
I-slice init type only (this framework is all-intra).
"""
import numpy as np

from ..core import tables


class CabacContexts:
    """Per-slice context state: state0/state1 arrays per syntax element."""

    def __init__(self):
        self._entries = {}
        for se_id, e in enumerate(tables._CAB["ctx_table"]):
            if e is None:
                continue
            init = np.array(e["init"][0], dtype=np.int32)   # I-slice inits
            shift = np.array(e["shift"][0], dtype=np.int32)
            self._entries[se_id] = [init, shift,
                                    np.zeros_like(init), np.zeros_like(init)]

    def init_states(self, slice_qp):
        """Context initialisation (spec 9.3.2.2; bool_coder.rs:1073)."""
        qp = int(np.clip(slice_qp, 0, 63))
        for se_id, (init, shift, s0, s1) in self._entries.items():
            slope = (init >> 3).astype(np.int64) - 4
            offset = (init & 7).astype(np.int64) * 18 + 1
            pre = np.clip(((slope * (qp - 16)) >> 1) + offset, 1, 127)
            s0[:] = pre << 3
            s1[:] = pre << 7

    def snapshot(self):
        return {k: (v[2].copy(), v[3].copy()) for k, v in self._entries.items()}

    def restore(self, snap):
        for k, (s0, s1) in snap.items():
            self._entries[k][2][:] = s0
            self._entries[k][3][:] = s1

    def states(self, se_id):
        e = self._entries[se_id]
        return e[1], e[2], e[3]  # shift_idx, state0, state1


class CabacEncoder:
    """Arithmetic encoding engine writing bits into a BitWriter."""

    def __init__(self, bitwriter, trace=None):
        self.w = bitwriter
        self.ctx = CabacContexts()
        self.range = 510
        self.offset = 0
        self.first_bit = True
        self.outstanding = 0
        # per-bin debug dump (the reference's bool_coder.rs:275-286 role):
        # when set to a list, every regular bin appends (se_id, inc, bin)
        # and every bypass appends (-1, -1, bin) — diffable against the
        # independent decoder's trace to localise syntax mismatches
        self.trace = trace

    def init_slice(self, slice_qp):
        self.ctx.init_states(slice_qp)
        self.init_engine()

    def init_engine(self):
        self.range = 510
        self.offset = 0

    # -- bit plumbing ------------------------------------------------------
    def _put(self, bit):
        if not self.first_bit:
            self.w.bit(bit)
        self.first_bit = False
        while self.outstanding > 0:
            self.w.bit(0 if bit else 1)
            self.outstanding -= 1

    def _put_trailing(self, bit):
        self.w.bit(bit)
        while self.outstanding > 0:
            self.w.bit(0 if bit else 1)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.offset < 256:
                self._put(0)
            elif self.offset >= 512:
                self.offset -= 512
                self._put(1)
            else:
                self.offset -= 256
                self.outstanding += 1
            self.range <<= 1
            self.offset <<= 1

    # -- bins --------------------------------------------------------------
    def encode_bin(self, se_id, ctx_inc, bin_val):
        """Regular (context-coded) bin."""
        if self.trace is not None:
            self.trace.append((se_id, ctx_inc, 1 if bin_val else 0))
        shift_idx, s0, s1 = self.ctx.states(se_id)
        i = ctx_inc
        p_state = int(s1[i]) + 16 * int(s0[i])
        val_mps = p_state >> 14
        q_range_idx = self.range >> 5
        lps = ((q_range_idx * ((p_state if val_mps == 0 else 32767 - p_state) >> 9)) >> 1) + 4
        b = 1 if bin_val else 0
        if b == val_mps:
            self.range -= lps
        else:
            self.offset += self.range - lps
            self.range = lps
        self._renorm()
        sh = int(shift_idx[i])
        sh0 = (sh >> 2) + 2
        sh1 = (sh & 3) + 3 + sh0
        s0[i] = int(s0[i]) - (int(s0[i]) >> sh0) + ((1023 * b) >> sh0)
        s1[i] = int(s1[i]) - (int(s1[i]) >> sh1) + ((16383 * b) >> sh1)

    def encode_bypass(self, bin_val):
        if self.trace is not None:
            self.trace.append((-1, -1, 1 if bin_val else 0))
        self.offset <<= 1
        if bin_val:
            self.offset += self.range
        if self.offset >= 1024:
            self._put(1)
            self.offset -= 1024
        elif self.offset < 512:
            self._put(0)
        else:
            self.offset -= 512
            self.outstanding += 1

    def encode_terminate(self, bin_val):
        """end_of_* one-bit; bin 1 flushes the engine (bool_coder.rs:218)."""
        self.range -= 2
        if bin_val:
            self.offset += self.range
            self.range = 2
            self._renorm()
            self._put((self.offset >> 9) & 1)
            two = ((self.offset >> 7) & 3) | 1
            self._put_trailing((two >> 1) & 1)
            self._put_trailing(two & 1)
        else:
            self._renorm()
        if bin_val:
            self.first_bit = True
            self.outstanding = 0


class CabacDecoder:
    """Arithmetic decoding engine reading bits from a BitReader."""

    def __init__(self, bitreader):
        self.r = bitreader
        self.ctx = CabacContexts()
        self.range = 510
        self.offset = 0

    def init_slice(self, slice_qp):
        self.ctx.init_states(slice_qp)
        self.init_engine()

    def init_engine(self):
        self.range = 510
        self.offset = self.r.u(9)

    def decode_bin(self, se_id, ctx_inc):
        shift_idx, s0, s1 = self.ctx.states(se_id)
        i = ctx_inc
        p_state = int(s1[i]) + 16 * int(s0[i])
        val_mps = p_state >> 14
        q_range_idx = self.range >> 5
        lps = ((q_range_idx * ((p_state if val_mps == 0 else 32767 - p_state) >> 9)) >> 1) + 4
        self.range -= lps
        if self.offset >= self.range:
            b = 1 - val_mps
            self.offset -= self.range
            self.range = lps
        else:
            b = val_mps
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.r.bit()
        sh = int(shift_idx[i])
        sh0 = (sh >> 2) + 2
        sh1 = (sh & 3) + 3 + sh0
        s0[i] = int(s0[i]) - (int(s0[i]) >> sh0) + ((1023 * b) >> sh0)
        s1[i] = int(s1[i]) - (int(s1[i]) >> sh1) + ((16383 * b) >> sh1)
        return b

    def decode_bypass(self):
        self.offset = (self.offset << 1) | self.r.bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_terminate(self):
        self.range -= 2
        if self.offset >= self.range:
            # bin == 1: slice/tile end; align to byte for subsequent data
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.r.bit()
        return 0
