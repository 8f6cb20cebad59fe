"""HEVC deblocking threshold tables: QP -> beta and QP -> tC.

Reference parity: hevc_deblocking_filter_cpu.h:1021-1033 (beta_table, tc_table)
and cpu.h:1064-1072 (GetBeta/GetTc, clamped at QP 51).

TPU-first design note: Qp is a single scalar per frame, so beta/tC are looked
up once on the host and passed to kernels as int32 scalars -- there is no
reason to put a 52-entry LUT on the device (reference rebuilds the device-side
tables on every __device__ call, gpu.cu:79-101; we do the lookup exactly once).
"""

from __future__ import annotations

# QP 0..51. beta == 0 for QP < 16 and tC == 0 for QP < 18, which makes the
# whole deblocking filter a no-op at low QP (cond1 `< beta` can never hold,
# and every normal-filter row gate `|delta| < 10*tc` fails).
BETA_TABLE: tuple[int, ...] = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,          # QP 0..15
    6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,  # QP 16..31
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,  # QP 32..47
    58, 60, 62, 64,                                            # QP 48..51
)

TC_TABLE: tuple[int, ...] = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,          # QP 0..15
    0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3,           # QP 16..31
    3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13,        # QP 32..47
    14, 16, 18, 20,                                            # QP 48..51
)

# The 8x8 sample-block grid size everything in the pipeline is built around
# (reference: const int sample_block_size = 8, cpu.h:1035).
SAMPLE_BLOCK_SIZE = 8
HALF_BLOCK = SAMPLE_BLOCK_SIZE // 2
MAX_PIXEL = (1 << 8) - 1  # cpu.h:1202

# The sample bit depths the port filters: 8 (HEVC Main; uint8 samples) and
# 10 (Main 10; int16 samples in [0, 1023], the 16-bit words of yuv420p10le
# planes).  At 10 bits beta and tC are the tables' values scaled by
# 2^(bit_depth - 8) and every filtered sample is clipped to
# [0, 2^bit_depth - 1], as H.265's edge filtering (8.7.2.5) does; the
# reference project filters 8-bit samples only.
BIT_DEPTHS = (8, 10)


def check_bit_depth(bit_depth) -> int:
    """bit_depth as an int; raises ValueError outside BIT_DEPTHS."""
    if bit_depth not in BIT_DEPTHS:
        raise ValueError(f"bit_depth must be one of {BIT_DEPTHS}, got {bit_depth!r}")
    return int(bit_depth)


# The chroma formats the port filters, each with its (SubWidthC,
# SubHeightC) (H.265 Table 6-1): "4:2:0", chroma planes (h/2, w/2) and a
# packed frame of 3h/2 rows (luma, U, V); and, of the format range
# extensions, "4:2:2" (e.g. Main 4:2:2 10), chroma planes (h, w/2) and 2h
# rows, and "4:4:4" (Main 4:4:4, Main 4:4:4 10), chroma planes (h, w) and 3h
# rows.  Each chroma plane is filtered on its own 8x8 grid with the
# one-sample filter, its BS maps looked up at the chroma width and gated by
# the luma tile counts (Q2; at 4:4:4 the plane's own), and chroma tc is the
# table's at the frame's QP in each (outside 4:2:0 H.265 sets QpC =
# Min(qPi, 51), no Table 8-10 lookup).
CHROMA_FORMATS = {"4:2:0": (2, 2), "4:2:2": (2, 1), "4:4:4": (1, 1)}


def check_chroma_format(chroma_format) -> str:
    """chroma_format itself; raises ValueError outside CHROMA_FORMATS."""
    if chroma_format not in CHROMA_FORMATS:
        raise ValueError(f"chroma_format must be one of {tuple(CHROMA_FORMATS)}, "
                         f"got {chroma_format!r}")
    return chroma_format


def chroma_width(w: int, chroma_format: str = "4:2:0") -> int:
    """A chroma plane's columns for a frame of w luma columns: w/2 at 4:2:0
    and 4:2:2, w at 4:4:4."""
    return w // CHROMA_FORMATS[check_chroma_format(chroma_format)][0]


def chroma_height(h: int, chroma_format: str = "4:2:0") -> int:
    """A chroma plane's rows for a frame of h luma rows: h/2 at 4:2:0, h at
    4:2:2 and 4:4:4."""
    return h // CHROMA_FORMATS[check_chroma_format(chroma_format)][1]


def packed_rows(h: int, chroma_format: str = "4:2:0") -> int:
    """The rows of a packed frame w samples wide -- luma, then U and V --
    for h luma rows: 3h/2 at 4:2:0, 2h at 4:2:2, 3h at 4:4:4."""
    sub_w = CHROMA_FORMATS[check_chroma_format(chroma_format)][0]
    return h + 2 * chroma_height(h, chroma_format) // sub_w


def max_pixel(bit_depth: int = 8) -> int:
    """The largest sample value, 2^bit_depth - 1 (the clip of every filtered
    sample)."""
    return (1 << check_bit_depth(bit_depth)) - 1


def scale_thresholds(beta: int, tc: int, bit_depth: int = 8) -> tuple[int, int]:
    """The tables' beta and tC at a bit depth: each times 2^(bit_depth - 8)."""
    up = check_bit_depth(bit_depth) - 8
    return int(beta) << up, int(tc) << up


def get_beta(qp: int) -> int:
    """QP -> beta threshold (cpu.h:1064-1067; QP clamped at 51)."""
    qp = int(qp)
    if qp < 0:
        raise ValueError(f"QP must be non-negative, got {qp}")
    return BETA_TABLE[min(qp, 51)]


def get_tc(qp: int) -> int:
    """QP -> tC threshold (cpu.h:1069-1072; QP clamped at 51)."""
    qp = int(qp)
    if qp < 0:
        raise ValueError(f"QP must be non-negative, got {qp}")
    return TC_TABLE[min(qp, 51)]
