"""Binarization processes (spec 9.3.3.2-9.3.3.6).

Encode-side helpers return bin lists; decode-side helpers consume bins via a
`read()` callable (which the syntax layer wires to the right context /
bypass decision per bin index). Cf. bool_coder.rs:1176-1331.
"""


def fl_bins(val, c_max):
    """Fixed-length: ilog2(c_max)+1 bits, MSB first (c_max >= 1)."""
    n = c_max.bit_length()
    return [((val >> i) & 1) == 1 for i in range(n - 1, -1, -1)]


def tr_bins(val, c_max, rice):
    """Truncated Rice."""
    prefix = val >> rice
    out = []
    if prefix < (c_max >> rice):
        out += [True] * prefix + [False]
    else:
        out += [True] * (c_max >> rice)
    if c_max > val and rice > 0:
        suffix = val - (prefix << rice)
        out += fl_bins(suffix, (1 << rice) - 1)
    return out


def tb_bins(val, c_max):
    """Truncated binary."""
    n = c_max + 1
    k = n.bit_length() - 1
    u = (1 << (k + 1)) - n
    if val < u:
        return fl_bins(val, (1 << k) - 1) if k > 0 else []
    return fl_bins(val + u, (1 << (k + 1)) - 1)


def egk_bins(val, k):
    """k-th order exp-Golomb (bool_coder.rs:1257)."""
    out = []
    v = val
    while v >= (1 << k):
        out.append(True)
        v -= 1 << k
        k += 1
    out.append(False)
    for i in range(k - 1, -1, -1):
        out.append(((v >> i) & 1) == 1)
    return out


def limited_egk_bins(val, k, max_pre_ext_len, trunc_suffix_len):
    """Limited k-th order EG (bool_coder.rs:1278)."""
    out = []
    code_value = val >> k
    pre = 0
    while pre < max_pre_ext_len and code_value > (2 << pre) - 2:
        pre += 1
        out.append(True)
    if pre == max_pre_ext_len:
        esc = trunc_suffix_len
    else:
        out.append(False)
        esc = pre + k
    v = val - (((1 << pre) - 1) << k)
    for i in range(esc - 1, -1, -1):
        out.append(((v >> i) & 1) == 1)
    return out


# --------------------------- decoders ------------------------------------

def read_fl(read, c_max):
    n = (c_max.bit_length() - 1) + 1
    v = 0
    for _ in range(n):
        v = (v << 1) | read()
    return v


def read_tr(read_prefix, read_suffix, c_max, rice):
    """Truncated Rice decode; read_prefix(idx) / read_suffix() return bins.

    Suffix presence mirrors the encoder (`c_max > symbol && rice > 0`):
    with the c_max = N << rice usage in this codec, a suffix is present
    exactly when the prefix terminated before saturating (prefix < c_max>>rice).
    Returns (value, prefix) — a saturated prefix means value >= c_max and the
    caller handles the escape suffix.
    """
    prefix = 0
    max_prefix = c_max >> rice
    while prefix < max_prefix and read_prefix(prefix):
        prefix += 1
    val = prefix << rice
    if rice > 0 and prefix < max_prefix:
        suffix = 0
        for _ in range(rice):
            suffix = (suffix << 1) | read_suffix()
        val += suffix
    return val, prefix


def read_tb(read, c_max):
    """Truncated binary decode."""
    n = c_max + 1
    k = n.bit_length() - 1
    u = (1 << (k + 1)) - n
    v = 0
    for _ in range(k):
        v = (v << 1) | read()
    if v >= u:
        v = ((v << 1) | read()) - u
    return v


def read_egk(read, k):
    v = 0
    while read():
        v += 1 << k
        k += 1
    for i in range(k - 1, -1, -1):
        v += read() << i
    return v


def read_limited_egk(read, k, max_pre_ext_len, trunc_suffix_len):
    pre = 0
    while pre < max_pre_ext_len and read():
        pre += 1
    if pre == max_pre_ext_len:
        esc = trunc_suffix_len
    else:
        esc = pre + k
    v = 0
    for _ in range(esc):
        v = (v << 1) | read()
    return v + (((1 << pre) - 1) << k)
