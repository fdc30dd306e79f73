"""Inputs at the pairing boundaries of the int16-lane DP kernels
(``kernels.match_units`` and ``colstream.match_units_colstream`` with
``int16_lanes=True``), made with numpy from a seed at small widths. The
CPU tests hold the plain versions to frizbee_tpu's int16 kernels and to
the int32 results on them; ``chip_smoke.py`` holds the CUDA kernels to
the plain versions on the same inputs.

Both kernels run pass 2 on a block queue of the rows (row-major) or (row,
query) entries (column stream) that the prefilter passes, ordered by
trimmed-window length, two entries a thread. The cases make queues of
every length mod 4 (a pair with an odd row out), a full doubled queue,
pairs of a 1-column window beside a W-column one, and matched rows all
in one half of a tile's length order.
"""

from __future__ import annotations

import numpy as np

# the seed both the CPU tests and chip_smoke.py build the cases from
SEED = 41

# row-major: a W=128 bucket of 640 rows, which the int16 kernel stages in
# 256-row blocks (the int32 kernel in 128-row ones)
ROWMAJOR_B, ROWMAJOR_W = 640, 128
# (n, T): the greedy embedding and the minimal-position DP, at needle
# ceilings 16 and 32
ROWMAJOR_NT = ((8, 0), (8, 4), (24, 0), (24, 4))
# live counts of the two queries of a launch: each residue mod 4, a warp,
# the int32 block (128), the doubled block (256) crossed, and 514 and 515,
# whose last block holds only a 1-unit row and a 128-unit one (and one
# more 128-unit row)
ROWMAJOR_COUNTS = ((1, 2), (3, 5), (7, 31), (33, 65), (127, 129),
                   (255, 257), (383, 514), (515, 603))

# column stream: five 1024-row groups of a W=32 bucket (128-row tiles)
COLSTREAM_W, COLSTREAM_GROUPS = 32, 5
# the needles of each needle length, three queries a launch: the first
# two share a round of the int16 kernel (their entries mix in its queue),
# the third runs alone; "k" matches no row
COLSTREAM_QUERIES = {
    8: ("dEadbeEf", "fxdeabQ_", "DeADBEeF"),
    1: ("d", "k", "D"),
}
COLSTREAM_NT = ((8, 0), (8, 1), (1, 0))
# live counts of the three queries (a group is alive below its count):
# every group, one group, and mixes that leave a round one query
COLSTREAM_COUNTS = ((5120, 5120, 5120), (5120, 1, 3 * 1024 - 37),
                    (1, 1025, 5120), (2, 2, 2))
# group 3: its k-th 128-row tile holds this many rows with the first
# 8-unit needle (the last tile every row, with the second needle too)
COLSTREAM_TILE_MATCHES = (1, 2, 3, 5, 7, 65, 127, 128)

_POOL = np.frombuffer(b"abcdefghABCDEFGH", np.uint8).astype(np.int64)
_FILLER = np.frombuffer(b"qrstuvwxyzQRSTUVWXYZ0123456789/_-",
                        np.uint8).astype(np.int64)


def _swapcase(u):
    upper = (u >= 0x41) & (u <= 0x5A)
    lower = (u >= 0x61) & (u <= 0x7A)
    return np.where(upper, u + 32, np.where(lower, u - 32, u))


def rowmajor_case(seed: int, n: int, T: int) -> dict:
    """A row-major byte bucket for needle length ``n`` at typo budget
    ``T``: ``cp`` (B, W) int8 rows, ``nu`` (B,) int32, ``needle`` (2n,)
    orig then flip units, ``idx`` (B,) int32 corpus indices (a few -1),
    ``rows`` (2, B) int32 row orders (identity, a permutation). Rows
    0-127 carry the needle with at most T units dropped (all matched),
    rows 128-255 no needle unit (all rejected); the rest mix both, with a
    tenth of the rows empty and a tenth W units long; rows 512 and 513 are
    1 and W units long and row 514 W units."""
    rng = np.random.default_rng(seed)
    B, W = ROWMAJOR_B, ROWMAJOR_W
    orig = rng.choice(_POOL, n)
    flip = _swapcase(orig)
    cp = rng.choice(_FILLER, (B, W))
    r = rng.random(B)
    nu = np.where(r < 0.1, 0, np.where(r > 0.9, W, rng.integers(0, W + 1, B)))
    nu[512:515] = (1, W, W)
    for i in range(B):
        if 128 <= i < 256 or (i >= 256 and rng.random() < 0.3):
            continue
        if i >= 256:
            sprinkle = rng.random(W) < 0.1
            cp[i, sprinkle] = rng.choice(_POOL, int(sprinkle.sum()))
        drop = int(rng.integers(0, T + (1 if i < 128 else 3)))
        keep = np.sort(rng.permutation(n)[:max(n - drop, 0)])
        units = np.where(rng.random(len(keep)) < 0.3, flip[keep], orig[keep])
        if i == 512:
            units = units[:1]
        nu[i] = max(nu[i], len(units))
        pos = np.sort(rng.choice(nu[i], len(units), replace=False))
        cp[i, pos] = units
    cp = np.where(np.arange(W)[None, :] < nu[:, None], cp, 0)
    idx = rng.permutation(B).astype(np.int32)
    idx[rng.random(B) < 0.05] = -1
    rows = np.stack([np.arange(B), rng.permutation(B)]).astype(np.int32)
    return dict(cp=cp.astype(np.uint8).view(np.int8), nu=nu.astype(np.int32),
                needle=np.concatenate([orig, flip]), idx=idx, rows=rows)


def colstream_rows(seed: int) -> list:
    """The rows (strings) of the column-stream bucket, in group order
    (no clustering): group 0 random rows over the needles' letters;
    group 1 empty rows but for three of W units a 256-row span (two carry
    the needle), so an empty row meets a full one; group 2 rows of 12
    units, the odd ones with the needle; group 3 tiles with
    COLSTREAM_TILE_MATCHES rows of the needle each; group 4 tiles of 64
    rows of 12 units and 64 of W, the needle in only the short ones (even
    tiles) or only the long ones (odd tiles), except tiles 2 and 3, whose
    only rows with a 'd' are "d" and "d...d" of W units (tile 3: two of
    those), a 1-column window beside a W-column one."""
    rng = np.random.default_rng(seed)
    W = COLSTREAM_W
    needle, other = COLSTREAM_QUERIES[8][:2]
    long_d = "d" + "q" * (W - 2) + "d"

    def fill(length):
        return "".join(rng.choice(list("qrstuvwxyz_"), length))

    def with_needle(length, text=needle):
        row = fill(length - len(text))
        at = int(rng.integers(0, len(row) + 1))
        return row[:at] + text + row[at:]

    rows = []
    for i in range(COLSTREAM_GROUPS * 1024 - 37):
        g, t = divmod(i, 1024)
        tile, k = divmod(t, 128)
        if g == 0:
            row = "".join(rng.choice(list("deabfx/_Q"),
                                     int(rng.integers(0, W + 1))))
        elif g == 1:
            row = {5: "x" * 24 + needle, 77: "q" * W,
                   200: needle + "_" * 24}.get(t % 256, "")
        elif g == 2:
            row = ("ab" + needle + "yz") if i % 2 else "abqqqqqqqqyz"
        elif g == 3:
            m = COLSTREAM_TILE_MATCHES[tile]
            length = int(rng.integers(8, W + 1))
            if m == 128:
                row = with_needle(max(length, 16), needle + other)
            elif k < m:
                row = with_needle(length)
            else:
                row = fill(length)
        elif tile in (2, 3):
            row = {0: "d", 1: long_d, 2: long_d if tile == 3 else None}.get(
                k) or fill(int(rng.integers(1, W + 1)))
        else:
            short = k % 2 == 0
            carry = short == (tile % 2 == 0)
            length = 12 if short else W
            row = with_needle(length) if carry else fill(length)
        rows.append(row)
    return rows


def colstream_case(seed: int) -> dict:
    """The column-stream bucket as the kernels take it: ``cpT`` (nG*W, 8,
    128) int8, ``nuT`` (nG*8, 128) int32, ``idxT`` (nG*1024,) int32 (the
    37 padding rows -1), built from :func:`colstream_rows`."""
    W, G = COLSTREAM_W, COLSTREAM_GROUPS
    rng = np.random.default_rng(seed + 1)
    cp = np.zeros((G * 1024, W), np.uint8)
    nu = np.zeros(G * 1024, np.int32)
    for i, row in enumerate(colstream_rows(seed)):
        units = np.frombuffer(row.encode(), np.uint8)
        cp[i, :len(units)] = units
        nu[i] = len(units)
    cpT = np.ascontiguousarray(
        cp.view(np.int8).reshape(G, 1024, W).transpose(0, 2, 1)
    ).reshape(G * W, 8, 128)
    idx = rng.permutation(G * 1024).astype(np.int32)
    idx[G * 1024 - 37:] = -1
    return dict(cpT=cpT, nuT=nu.reshape(G * 8, 128), idxT=idx)
