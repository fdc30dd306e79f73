"""The reference's own view of a corpus of strings: flat unit arrays on a
device, and row blocks of similar length cut from them as padded
matrices.

A unit is a byte, or on the unicode path a codepoint. Each unit carries
its value, its first (lead) byte, the last byte of the unit before it (-1
for a row's first unit), its byte offset in the row and its byte length:
what the bonus schedule and the byte-offset results need. The literal
path works on bytes on either unit mode, so the bytes are kept too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

U16_MAX = 0xFFFF


def is_upper(b):
    return (b >= 0x41) & (b <= 0x5A)


def is_lower(b):
    return (b >= 0x61) & (b <= 0x7A)


def is_delim(b):
    """An ASCII byte that is not alphanumeric (-1, padding, is none)."""
    alnum = is_upper(b) | is_lower(b) | ((b >= 0x30) & (b <= 0x39))
    return (b >= 0) & (b <= 127) & ~alnum


def _cp_byte_len(cp: torch.Tensor) -> torch.Tensor:
    return (1 + (cp >= 0x80).int() + (cp >= 0x800).int()
            + (cp >= 0x10000).int())


def _cp_first_byte(cp: torch.Tensor, blen: torch.Tensor) -> torch.Tensor:
    lead = torch.where(blen == 2, 0xC0 | (cp >> 6),
                       torch.where(blen == 3, 0xE0 | (cp >> 12),
                                   0xF0 | (cp >> 18)))
    return torch.where(blen == 1, cp, lead)


def _cp_last_byte(cp: torch.Tensor, blen: torch.Tensor) -> torch.Tensor:
    return torch.where(blen == 1, cp, 0x80 | (cp & 0x3F))


def _in_rows(x: torch.Tensor, starts: torch.Tensor):
    """(x shifted right by one unit inside each row with -1 at each row's
    first unit, each unit's offset from its row's first unit)."""
    prev = torch.cat([x.new_full((1,), -1), x[:-1]])
    firsts = starts[:-1][starts[:-1] < len(x)]
    prev[firsts] = -1
    counts = starts[1:] - starts[:-1]
    row_start = torch.repeat_interleave(starts[:-1], counts)
    offset = torch.arange(len(x), device=x.device) - row_start
    return prev, offset


@dataclass
class Block:
    """Rows ``rows`` (indices into the corpus) as (R, L) matrices, padded
    with -1 past each row's ``n_units``."""

    rows: torch.Tensor
    n_units: torch.Tensor
    n_bytes: torch.Tensor
    cp: torch.Tensor
    first: torch.Tensor
    prev_last: torch.Tensor
    byte_off: torch.Tensor
    byte_len: torch.Tensor

    def select(self, idx: torch.Tensor) -> "Block":
        """The block of its rows ``idx``."""
        return Block(*(getattr(self, f)[idx]
                       for f in Block.__dataclass_fields__))


class Units:
    """A corpus of strings in one unit mode, resident on ``device``."""

    def __init__(self, strings: Sequence[str], unicode: bool, device):
        self.unicode = unicode
        self.device = torch.device(device)
        self.n = len(strings)
        enc = [s.encode("utf-8") for s in strings]
        self.n_bytes_np = np.fromiter(map(len, enc), np.int64, self.n)
        dev = self.device

        def starts_of(lengths):
            st = np.zeros(self.n + 1, np.int64)
            np.cumsum(lengths, out=st[1:])
            return torch.from_numpy(st).to(dev)

        self._bstarts = starts_of(self.n_bytes_np)
        self._bytes = torch.from_numpy(
            np.frombuffer(b"".join(enc), np.uint8).copy()).to(dev).int()
        del enc
        if unicode:
            cp = torch.from_numpy(np.frombuffer(
                "".join(strings).encode("utf-32-le"), np.uint32).view(
                    np.int32).copy()).to(dev)
            nu = np.fromiter(map(len, strings), np.int64, self.n)
            self._ustarts = starts_of(nu)
            blen = _cp_byte_len(cp)
            first = _cp_first_byte(cp, blen)
            prev_last, _ = _in_rows(_cp_last_byte(cp, blen), self._ustarts)
            # a unit's byte offset: the bytes of the units before it
            cum = torch.cumsum(blen, 0) - blen
            _, upos = _in_rows(cp, self._ustarts)
            boff = (cum - cum[(torch.arange(len(cp), device=dev)
                               - upos)]).int()
        else:
            cp, nu, self._ustarts = self._bytes, self.n_bytes_np, (
                self._bstarts)
            blen = torch.ones_like(cp)
            first = cp
            prev_last, boff = _in_rows(cp, self._ustarts)
        self.n_units_np = nu
        self._flat = {
            "cp": cp, "first": first, "prev_last": prev_last,
            "byte_off": boff.int(), "byte_len": blen.int(),
        }
        self.n_units = torch.from_numpy(nu).to(dev)
        self.n_bytes = torch.from_numpy(self.n_bytes_np).to(dev)
        # rows in order of unit count: blocks of similar length pad little
        self._order_np = np.argsort(nu, kind="stable")
        self.order = torch.from_numpy(self._order_np).to(dev)

    def blocks(self, cells: int) -> Iterator[Block]:
        """Every row once, in blocks of at most ``cells`` padded units."""
        nu = np.maximum(self.n_units_np[self._order_np], 1)
        i = 0
        while i < self.n:
            # rows ascend in length, so [i, j) pads to nu[j - 1]: the
            # largest j within budget (one row at least)
            lo, hi = i + 1, self.n
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if (mid - i) * int(nu[mid - 1]) <= cells:
                    lo = mid
                else:
                    hi = mid - 1
            yield self.block(self.order[i:lo])
            i = lo

    def block(self, rows: torch.Tensor) -> Block:
        nu = self.n_units[rows]
        width = max(int(nu.max()), 1) if len(rows) else 1
        col = torch.arange(width, device=self.device)
        valid = col[None, :] < nu[:, None]
        idx = torch.where(valid, self._ustarts[rows][:, None] + col[None, :],
                          0)
        mats = {k: torch.where(valid, v[idx], -1)
                for k, v in self._flat.items()}
        return Block(rows, nu, self.n_bytes[rows], **mats)

    def byte_block(self, rows: torch.Tensor) -> torch.Tensor:
        """The rows' bytes as an (R, L) matrix padded with -1."""
        return self.byte_windows(rows, torch.zeros_like(rows),
                                 self.n_bytes[rows])

    def byte_windows(self, rows: torch.Tensor, start: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
        """Each row's ``length`` bytes from byte ``start`` as an (R, L)
        matrix padded with -1."""
        width = max(int(length.max()), 1) if len(rows) else 1
        col = torch.arange(width, device=self.device)
        valid = col[None, :] < length[:, None]
        idx = torch.where(valid, (self._bstarts[rows] + start)[:, None]
                          + col[None, :], 0)
        return torch.where(valid, self._bytes[idx], -1)
