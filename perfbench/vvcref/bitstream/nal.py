"""NAL unit / Annex-B byte-stream packaging (spec 7.3.1, 7.4.1, B.2).

Behavioural counterpart of nal.rs: 2-byte NAL header, 0x000003 emulation
prevention, and the reference's start-code convention (three zero bytes then
00 00 01 before every NAL; cf. nal.rs:193-201).
"""

# NAL unit types (spec Table 5)
TRAIL_NUT = 0
IDR_W_RADL = 7
IDR_N_LP = 8
VPS_NUT = 14
SPS_NUT = 15
PPS_NUT = 16
PREFIX_APS_NUT = 17
SUFFIX_APS_NUT = 18
PH_NUT = 19
AUD_NUT = 20
EOS_NUT = 21
EOB_NUT = 22


def nal_header(nuh_layer_id, nal_unit_type, nuh_temporal_id=0):
    b0 = ((nuh_layer_id >> 5) & 1) << 0 | 0  # forbidden_zero + reserved_zero + layer_id[5]
    byte0 = (0 << 7) | (0 << 6) | (nuh_layer_id & 0x3F)
    byte1 = ((nal_unit_type & 0x1F) << 3) | ((nuh_temporal_id + 1) & 0x7)
    return bytes([byte0, byte1])


def emulation_prevention(rbsp):
    """Insert 0x03 after any 00 00 followed by a byte <= 3 (nal.rs:274-291)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def remove_emulation_prevention(data):
    out = bytearray()
    zeros = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def write_nal(out, nuh_layer_id, nal_unit_type, rbsp, nuh_temporal_id=0):
    """Append one Annex-B NAL unit to bytearray `out`."""
    out += b"\x00\x00\x00"          # leading zeros (reference convention)
    out += b"\x00\x00\x01"          # start code
    out += nal_header(nuh_layer_id, nal_unit_type, nuh_temporal_id)
    out += emulation_prevention(rbsp)


def parse_annexb(data):
    """Split an Annex-B byte stream into (nal_unit_type, nuh_layer_id,
    rbsp_bytes) tuples with emulation prevention removed."""
    units = []
    i = 0
    n = len(data)
    # find start codes 00 00 01
    starts = []
    while i + 2 < n:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # trim trailing zero bytes of the next start code prefix
        while e > s and data[e - 1] == 0:
            e -= 1
        payload = data[s:e]
        if len(payload) < 2:
            continue
        layer_id = payload[0] & 0x3F
        nut = (payload[1] >> 3) & 0x1F
        rbsp = remove_emulation_prevention(payload[2:])
        units.append((nut, layer_id, rbsp))
    return units
