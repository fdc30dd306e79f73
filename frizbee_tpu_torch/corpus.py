"""Corpus packing: ragged strings -> length-bucketed unit matrices, and the
device layouts the kernels stream.

Counterpart of ``frizbee_tpu/corpus.py``. A unit is a byte on the ASCII
path (one int8 matrix per bucket) and a codepoint on the unicode path (one
int32 matrix per bucket, with the UTF-8 byte counts of each row beside
it). Packing runs in the native packer (``native/packer.cpp``, one
OpenMP pass a bucket; its NumPy twin is reached through the test hook
``native._FORCE_NUMPY``); the per-unit UTF-8 context arrays are built
only on the host, on demand, for the batched traceback and the generic
pipelines (``PackedBucket._full_arrays``): the kernels derive that
context from the codepoints, or read the colstream ctx plane. A packed
``Corpus`` is query-independent: build once, serve many batches — the
production serving pattern. Its tensors live on the corpus device, which
is the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import native
from .ops.presence import PLANES

# ctx-plane bit layout of the colstream unicode blocks (frizbee_tpu's
# ops/colstream.CTX_*): one int8 per unit
CTX_UPPER_FIRST = 1   # is_upper(first UTF-8 byte)
CTX_DELIM_FIRST = 2   # delim(first byte)
CTX_LOWER_LAST = 4    # lower(last byte)
CTX_DELIM_LAST = 8    # delim(last byte)
CTX_BLEN_SHIFT = 4    # bits 4-6: UTF-8 byte length

# Unit-width buckets. Rows wider than the last form the XL set, served
# by the host path (reference: src/smith_waterman/algo/mod.rs:18).
DEFAULT_BUCKETS: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024)
LANE_BUCKETS: Tuple[int, ...] = DEFAULT_BUCKETS

# Colstream row groups: 1024 rows, viewed as (SUBL, 128) tiles so the
# block layout matches frizbee_tpu's element for element.
SUBL = 8
GROUP_ROWS = SUBL * 128
# The widest bucket whose groups the finalize-cap chooser counts (the
# column-stream kernels' limit); a wider one counts as all alive.
CAP_COUNT_MAX_WIDTH = 1024


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another. Never drifts to the CPU on a host without a card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def max_bucket_rows(width: int) -> int:
    """Row cap per packed bucket: row ids and unit counts must co-pack
    into one 31-bit sort key on the compacted serving tiers. Oversized
    buckets split into chained buckets of the same width."""
    return min(1 << 20, 1 << (30 - (width).bit_length()))


def _utf8_lead_byte(cp: np.ndarray) -> np.ndarray:
    """First UTF-8 byte of each codepoint (vectorized)."""
    out = np.where(cp < 0x80, cp, 0)
    out = np.where((cp >= 0x80) & (cp < 0x800), 0xC0 | (cp >> 6), out)
    out = np.where((cp >= 0x800) & (cp < 0x10000), 0xE0 | (cp >> 12), out)
    out = np.where(cp >= 0x10000, 0xF0 | (cp >> 18), out)
    return out.astype(np.int32)


def _utf8_last_byte(cp: np.ndarray) -> np.ndarray:
    """Last UTF-8 byte of each codepoint (vectorized)."""
    return np.where(cp < 0x80, cp, 0x80 | (cp & 0x3F)).astype(np.int32)


def _utf8_len(cp: np.ndarray) -> np.ndarray:
    out = np.ones_like(cp)
    out = np.where(cp >= 0x80, 2, out)
    out = np.where(cp >= 0x800, 3, out)
    out = np.where(cp >= 0x10000, 4, out)
    return out.astype(np.int32)


def _delim_byte(b: np.ndarray) -> np.ndarray:
    letter = ((b >= 0x41) & (b <= 0x5A)) | ((b >= 0x61) & (b <= 0x7A))
    digit = (b >= 0x30) & (b <= 0x39)
    return (b >= 0) & (b <= 127) & ~letter & ~digit


def ctx_plane(cp: np.ndarray) -> np.ndarray:
    """int8 UTF-8 bonus context of each codepoint (CTX_* layout): the
    case and delimiter classes of its first and last byte and its byte
    length — the per-column facts the colstream kernels would otherwise
    derive from the codepoint on every pass."""
    first = _utf8_lead_byte(cp)
    last = _utf8_last_byte(cp)
    ctx = ((first >= 0x41) & (first <= 0x5A)).astype(np.int8) \
        * CTX_UPPER_FIRST
    ctx |= _delim_byte(first).astype(np.int8) * CTX_DELIM_FIRST
    ctx |= ((last >= 0x61) & (last <= 0x7A)).astype(np.int8) * CTX_LOWER_LAST
    ctx |= _delim_byte(last).astype(np.int8) * CTX_DELIM_LAST
    ctx |= _utf8_len(cp).astype(np.int8) << CTX_BLEN_SHIFT
    return ctx


def _size_class(b: int) -> int:
    """Smallest {2^k * m/4 : m in 4..7} >= b (min 256): coarse row-count
    classes bound padding waste at 25% while collapsing bucket shapes."""
    c = 256
    while True:
        for m in (4, 5, 6, 7):
            cand = (c * m) // 4
            if cand >= b:
                return cand
        c *= 2


def _cluster_order(counts: np.ndarray, nu: np.ndarray, leaf: int,
                   unicode: bool) -> np.ndarray:
    """Row order clustering rows with similar fold-bit presence into
    ``leaf``-sized groups, so group-OR presence planes reject whole
    groups for most queries: a 16-key lexsort over presence bits (unit
    count innermost). Byte corpora rank the lowest-supported bits
    (>= 2%) first; codepoint corpora the most balanced ones."""
    b = counts.shape[0]
    if b <= leaf:
        return np.argsort(nu, kind="stable").astype(np.int64)
    masks = counts > 0
    freq = masks.mean(axis=0)
    if unicode:
        rank = np.argsort(np.abs(freq - 0.5), kind="stable")
    else:
        cand = np.where(freq >= 0.02)[0]
        if len(cand) == 0:
            cand = np.arange(counts.shape[1])
        rank = cand[np.argsort(freq[cand], kind="stable")]
    keys = [masks[:, rank[c]] for c in range(min(16, len(rank)))]
    return np.lexsort([nu] + keys[::-1])


@dataclass
class PackedBucket:
    """One length bucket of the corpus, padded to ``width`` units."""

    width: int
    # Original corpus indices of the rows, (B,); size-class padding is -1
    indices: np.ndarray
    # Unit values, (B, W), zero-padded: int8 bytes on the ASCII path,
    # int32 codepoints on the unicode path
    cp: np.ndarray
    # Units per haystack, (B,) int32
    n_units: np.ndarray
    # Bytes per haystack, (B,) int32
    n_bytes: np.ndarray
    device: torch.device

    @property
    def size(self) -> int:
        return int(self.indices.shape[0])

    @property
    def unicode(self) -> bool:
        """Codepoint units (int32) rather than bytes (int8)."""
        return self.cp.dtype != np.int8

    def _full_arrays(self):
        """(cp, first_byte, prev_last_byte, byte_off, byte_len), (B, W)
        int32 host arrays of the unit values and their UTF-8 context
        (cached): each unit's first byte, the previous unit's last byte
        (-1 at a row's start), its byte offset within the row and its
        byte length; padding holds 0, with -1 as the previous byte. The
        batched traceback reads them (frizbee_tpu's
        ``PackedBucket._full_arrays``); they never go to the device."""
        if not hasattr(self, "_full"):
            b, w = self.cp.shape
            cols = np.arange(w, dtype=np.int32)[None, :]
            valid = cols < self.n_units[:, None]
            if self.unicode:
                cp32 = np.where(valid, self.cp, 0).astype(np.int32)
                first = np.where(valid, _utf8_lead_byte(cp32), 0)
                last = _utf8_last_byte(cp32)
                blen = np.where(valid, _utf8_len(cp32), 0).astype(np.int32)
                boff = np.zeros((b, w), np.int32)
                np.cumsum(blen[:, :-1], axis=1, out=boff[:, 1:])
                boff = np.where(valid, boff, 0).astype(np.int32)
            else:
                cp32 = np.where(valid, self.cp.astype(np.int32) & 0xFF, 0)
                first = last = cp32
                boff = np.where(valid, cols, 0).astype(np.int32)
                blen = valid.astype(np.int32)
            prev = np.concatenate(
                [np.full((b, 1), -1, np.int32), last[:, :-1]], axis=1
            )
            prev = np.where(valid, prev, -1).astype(np.int32)
            self._full = (cp32.astype(np.int32), first.astype(np.int32),
                          prev, boff, blen)
        return self._full

    def device_arrays(self):
        """The generic pipelines' 8-tuple on the corpus device (cached,
        built on first use: five (B, W) int32 planes): (cp, first_byte,
        prev_last_byte, byte_off, byte_len) of :meth:`_full_arrays`, then
        n_units, n_bytes and indices (B,) int32 (-1 on size-class
        padding) — the ``ops/fuzzy.fuzzy_pipeline`` /
        ``ops/literal.literal_pipeline`` operands (frizbee_tpu's
        ``device_arrays()``)."""
        if not hasattr(self, "_device_full"):
            dev = self.device
            self._device_full = tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                for a in self._full_arrays() + (
                    self.n_units, self.n_bytes, self.indices)
            )
        return self._device_full

    def presence_counts(self) -> np.ndarray:
        """(B, 128) uint8 per-row fold-bit occurrence counts capped at
        PLANES, in bucket row order (cached). Padding columns land in a
        sentinel bin 128; 64k-row chunks keep the bincount cache-friendly."""
        if not hasattr(self, "_counts"):
            b, w = self.cp.shape
            cp32 = self.cp.astype(np.int32)
            if not self.unicode:
                cp32 &= 0xFF
            nu = self.n_units.astype(np.int32)
            upper = (cp32 >= 0x41) & (cp32 <= 0x5A)
            fold = np.where(upper, cp32 + 0x20, cp32) & 127
            fold = np.where(
                np.arange(w, dtype=np.int32)[None, :] < nu[:, None],
                fold, 128,
            )
            counts = np.empty((b, 128), np.uint8)
            step = 65536
            for s in range(0, b, step):
                e = min(s + step, b)
                rows_c = e - s
                row_of = np.repeat(np.arange(rows_c, dtype=np.int64), w)
                c = np.bincount(
                    row_of * 129 + fold[s:e].ravel(),
                    minlength=rows_c * 129,
                ).reshape(rows_c, 129)[:, :128]
                counts[s:e] = np.minimum(c, PLANES)
            self._counts = counts
        return self._counts

    def device_presence_bits(self) -> torch.Tensor:
        """(B, PLANES*128) int8 per-row presence planes on the corpus
        device, in bucket row order (cached): plane k column c is 1 when
        fold-bit c occurs more than k times — the ``bits8`` operand of
        the stage-1 survivor matmul (frizbee_tpu's
        ``device_arrays_ascii()[4]``, or ``device_arrays_units()[4]``
        for a unicode bucket)."""
        if not hasattr(self, "_device_bits"):
            counts = self.presence_counts()
            bits8 = np.concatenate(
                [(counts > k) for k in range(PLANES)], axis=1
            ).astype(np.int8)
            self._device_bits = torch.from_numpy(bits8).to(self.device)
        return self._device_bits

    def device_arrays_ascii(self):
        """Row-major kernel arrays on the corpus device (cached): (cp
        (B, W) int8, n_units (B,) int32, indices (B,) int32 with -1 on
        size-class padding), in bucket row order — the operands of
        ``ops/kernels.match_units`` (frizbee_tpu's
        ``device_arrays_ascii()[:3]``)."""
        if self.unicode:
            raise ValueError("a unicode bucket has no byte matrix; use "
                             "device_arrays_units()")
        if not hasattr(self, "_device_ascii"):
            dev = self.device
            self._device_ascii = (
                torch.from_numpy(self.cp).to(dev),
                torch.from_numpy(self.n_units.astype(np.int32)).to(dev),
                torch.from_numpy(self.indices.astype(np.int32)).to(dev),
            )
        return self._device_ascii

    def device_arrays_units(self):
        """Row-major kernel arrays of a unicode bucket (cached): (cp
        (B, W) int32 codepoints, n_units (B,) int32, indices (B,) int32
        with -1 on size-class padding), in bucket row order
        (frizbee_tpu's ``device_arrays_units()[:3]``)."""
        if not self.unicode:
            raise ValueError("a byte bucket has no codepoint matrix; use "
                             "device_arrays_ascii()")
        if not hasattr(self, "_device_units"):
            dev = self.device
            self._device_units = (
                torch.from_numpy(self.cp.astype(np.int32)).to(dev),
                torch.from_numpy(self.n_units.astype(np.int32)).to(dev),
                torch.from_numpy(self.indices.astype(np.int32)).to(dev),
            )
        return self._device_units

    def device_arrays_rowmajor(self):
        """The row-major kernel's operands: :meth:`device_arrays_units`
        for a unicode bucket, else :meth:`device_arrays_ascii`."""
        if self.unicode:
            return self.device_arrays_units()
        return self.device_arrays_ascii()

    def device_arrays_colstream(self):
        """Column-stream blocks (cached): (cpT (nG*W, SUBL, 128) int8
        bytes or int32 codepoints, nuT (nG*SUBL, 128) int32, idxT
        (nG*1024,) int32, blk_bits (nG, PLANES*128) int8, ctxT
        (nG*W, SUBL, 128) int8 UTF-8 bonus context plane (``ctx_plane``)
        of a unicode bucket, None for a byte bucket).

        Rows are content-clustered (``_cluster_order``), padded to whole
        1024-row groups, and laid out unit-major: row r of group g at unit
        column j is element ``(g*W + j)*1024 + r`` of cpT (and of ctxT),
        so the threads of a warp, one per row, read one column
        contiguously. The same elements view as ``(nG, W, 1024)``. idxT
        maps colstream slot -> corpus index (-1 on padding). blk_bits are
        the group-max capped presence planes: a group failing ``hits >=
        tot - typos`` holds no stage-1 survivor, so the kernel skips
        it."""
        if hasattr(self, "_device_colstream"):
            return self._device_colstream
        b, w = self.cp.shape
        nu = self.n_units.astype(np.int32)
        counts = self.presence_counts()
        order = _cluster_order(counts, nu, GROUP_ROWS, unicode=self.unicode)
        cpo = self.cp[order]
        nup = nu[order]
        idxt = self.indices.astype(np.int32)[order]
        counts = counts[order]
        pad = (-b) % GROUP_ROWS
        if pad:
            cpo = np.pad(cpo, ((0, pad), (0, 0)))
            nup = np.pad(nup, (0, pad))
            counts = np.pad(counts, ((0, pad), (0, 0)))
            idxt = np.pad(idxt, (0, pad), constant_values=-1)
        ng = cpo.shape[0] // GROUP_ROWS
        cpt = np.ascontiguousarray(
            cpo.reshape(ng, GROUP_ROWS, w).transpose(0, 2, 1)
        ).reshape(ng * w, SUBL, 128)
        ctxt = None
        if self.unicode:
            # padding units (cp 0) get cp 0's context; the kernels read the
            # plane only under the unit-count gate
            ctxt = ctx_plane(cpt)
        blk_counts = counts.reshape(ng, GROUP_ROWS, 128).max(axis=1)
        blk_bits = np.concatenate(
            [(blk_counts > k) for k in range(PLANES)], axis=1
        ).astype(np.int8)
        dev = self.device
        self._device_colstream = (
            torch.from_numpy(cpt).to(dev),
            torch.from_numpy(nup.reshape(ng * SUBL, 128)).to(dev),
            torch.from_numpy(idxt).to(dev),
            torch.from_numpy(blk_bits).to(dev),
            None if ctxt is None else torch.from_numpy(ctxt).to(dev),
        )
        self._keep_host_planes(blk_bits)
        return self._device_colstream

    def _keep_host_planes(self, blk_bits: np.ndarray) -> None:
        """Keep the host copies of the group presence planes: the
        dispatcher picks the static result-sort capacity from per-group
        alive counts before the batch runs. The int8 planes, and for a
        bucket the chooser counts a C-contiguous float32 copy (~1.5 KB a
        group) that its ``sgemm`` reads as it is."""
        self._blk_bits_np = blk_bits
        self._blk_planes_f32 = (
            np.ascontiguousarray(blk_bits, dtype=np.float32)
            if self.width <= CAP_COUNT_MAX_WIDTH else None)

    def host_blk_bits(self) -> np.ndarray:
        """NumPy copy of the colstream group presence planes."""
        if not hasattr(self, "_blk_bits_np"):
            self.device_arrays_colstream()
        return self._blk_bits_np

    def host_blk_planes(self) -> Optional[np.ndarray]:
        """Float32 copy of :meth:`host_blk_bits` (cached), the cap
        chooser's operand; None for a bucket wider than
        ``CAP_COUNT_MAX_WIDTH``, which it counts as all alive."""
        if not hasattr(self, "_blk_planes_f32"):
            self.device_arrays_colstream()
        return self._blk_planes_f32


@dataclass
class Corpus:
    """A packed corpus resident on ``device``."""

    haystacks: List[str]
    unicode: bool
    buckets: List[PackedBucket]
    # Indices of haystacks longer than the largest bucket (host path)
    xl_indices: np.ndarray
    device: torch.device

    def __len__(self) -> int:
        return len(self.haystacks)

    def greedy_risk(self) -> bool:
        """True when any bucketed row could take the greedy path (more
        UTF-8 bytes than the 1024-byte DP cap: only multi-byte-heavy
        unicode rows)."""
        return any(
            b.size and int(b.n_bytes.max()) > 1024 for b in self.buckets
        )

    def xl_presence(self) -> np.ndarray:
        """(n_xl, 128) uint8 capped fold-bit occurrence counts of the XL
        (host-path) rows, in ``xl_indices`` order, computed once off the
        resident encoded blob (:meth:`xl_blob`; one vectorized bincount):
        the host twin of stage 1 that lets the matcher presence-reject XL
        rows before their host pipeline. Units are UTF-8 bytes, or
        codepoints in a unicode corpus; each folds A-Z to a-z, then keeps
        its low 7 bits; counts cap at the device planes' depth."""
        if "_xl_presence" not in self.__dict__:
            n_xl = len(self.xl_indices)
            blob = self.xl_blob()
            if self.unicode:
                units = blob["joined_u32"].astype(np.int64)
                starts = blob["ustarts"]
            else:
                units = np.frombuffer(blob["joined"], np.uint8).astype(
                    np.int64)
                starts = blob["bstarts"]
            fold = np.where(
                (units >= 0x41) & (units <= 0x5A), units + 0x20, units
            ) & 127
            row_of = np.repeat(np.arange(n_xl, dtype=np.int64),
                               np.diff(starts))
            flat = np.bincount(row_of * 128 + fold, minlength=n_xl * 128)
            self._xl_presence = np.minimum(
                flat.reshape(n_xl, 128), PLANES
            ).astype(np.uint8)
        return self._xl_presence

    def xl_blob(self) -> Dict[str, np.ndarray]:
        """The XL (host-path) rows encoded once, in ``xl_indices`` order
        (cached): ``joined`` (UTF-8 bytes) and ``bstarts`` (its (n_xl+1,)
        int64 row offsets) and, in a unicode corpus, ``joined_u32`` (UTF-32
        codepoints) and ``ustarts``. The engines' ``match_xl_rows`` score
        per-query candidate subsets straight off it through the native host
        pipelines, so a row's encoding is paid once a corpus."""
        if "_xl_blob" not in self.__dict__:
            joined, bstarts, joined_u32, ustarts = native.encode_rows(
                [self.haystacks[int(i)] for i in self.xl_indices],
                self.unicode)
            blob = {"joined": joined, "bstarts": bstarts}
            if self.unicode:
                blob["joined_u32"] = joined_u32
                blob["ustarts"] = ustarts
            self._xl_blob = blob
        return self._xl_blob

    def device_xl_mask(self) -> torch.Tensor:
        """(n,) bool mask of the XL (host-path) rows on the corpus
        device (cached)."""
        if "_xl_mask" not in self.__dict__:
            m = np.zeros(len(self.haystacks), dtype=bool)
            m[self.xl_indices] = True
            self._xl_mask = torch.from_numpy(m).to(self.device)
        return self._xl_mask

    _SAVE_VERSION = 1

    def save(self, path: str) -> None:
        """Write the packed corpus to ``path`` in ``frizbee_tpu``'s format
        (npz, version 1; the path is used verbatim, no ``.npz`` suffix is
        appended), so either package's ``Corpus.load`` reads it. Codepoint
        buckets also write their per-unit UTF-8 context arrays
        (``_full_arrays``), as the reference's packer stores them: its
        generic pipelines read them rather than derive them."""
        data = [h.encode("utf-8") for h in self.haystacks]
        lens = np.fromiter((len(d) for d in data), dtype=np.int64,
                           count=len(data))
        arrs: Dict[str, np.ndarray] = {
            "version": np.int64(self._SAVE_VERSION),
            "unicode": np.int64(int(self.unicode)),
            "hay_blob": np.frombuffer(b"".join(data), dtype=np.uint8),
            "hay_lens": lens,
            "xl_indices": self.xl_indices,
            "n_buckets": np.int64(len(self.buckets)),
        }
        for i, b in enumerate(self.buckets):
            arrs[f"b{i}_width"] = np.int64(b.width)
            arrs[f"b{i}_indices"] = b.indices
            arrs[f"b{i}_cp"] = b.cp
            arrs[f"b{i}_n_units"] = b.n_units
            arrs[f"b{i}_n_bytes"] = b.n_bytes
            if b.unicode:
                _cp, first, prev, boff, blen = b._full_arrays()
                arrs[f"b{i}_first"] = first
                arrs[f"b{i}_prev"] = prev
                arrs[f"b{i}_boff"] = boff
                arrs[f"b{i}_blen"] = blen
        # through a handle: np.savez(str) appends ".npz" to a path
        # without it, which load(path) would then miss
        with open(path, "wb") as fh:
            np.savez(fh, **arrs)

    @classmethod
    def from_numpy(cls, haystacks: Sequence[str], buckets, xl_indices,
                   unicode: bool = False, device=None) -> "Corpus":
        """A corpus from packed bucket arrays, e.g. those of a
        ``frizbee_tpu`` corpus: ``buckets`` holds one (width, indices, cp,
        n_units, n_bytes) tuple per bucket; ``cp`` holds codepoints when
        ``unicode``, else int8 bytes or int32 byte values."""
        dev = resolve_device(device)
        out = []
        for width, indices, cp, n_units, n_bytes in buckets:
            cp = np.asarray(cp)
            if unicode:
                cp = cp.astype(np.int32)
            elif cp.dtype != np.int8:
                cp = (cp.astype(np.int32) & 0xFF).astype(np.uint8).view(
                    np.int8
                )
            out.append(PackedBucket(
                width=int(width),
                indices=np.asarray(indices, np.int64),
                cp=np.ascontiguousarray(cp),
                n_units=np.asarray(n_units, np.int32),
                n_bytes=np.asarray(n_bytes, np.int32),
                device=dev,
            ))
        return cls(list(haystacks), bool(unicode), out,
                   np.asarray(xl_indices, np.int64), dev)

    @classmethod
    def load(cls, path: str, device=None) -> "Corpus":
        """Read a corpus written by :meth:`save` or by ``frizbee_tpu``'s
        ``Corpus.save`` (npz, format version 1). The per-unit context
        arrays a file may hold derive from the codepoints here
        (``PackedBucket._full_arrays``), so they are not read."""
        with np.load(path) as z:
            version = int(z["version"])
            if version != cls._SAVE_VERSION:
                raise ValueError(
                    f"unsupported corpus file version {version}"
                )
            blob = z["hay_blob"].tobytes()
            lens = z["hay_lens"]
            ends = np.cumsum(lens)
            haystacks = [
                blob[e - n: e].decode("utf-8")
                for n, e in zip(lens.tolist(), ends.tolist())
            ]
            buckets = [
                (
                    int(z[f"b{i}_width"]), z[f"b{i}_indices"],
                    z[f"b{i}_cp"], z[f"b{i}_n_units"], z[f"b{i}_n_bytes"],
                )
                for i in range(int(z["n_buckets"]))
            ]
            return cls.from_numpy(
                haystacks, buckets, z["xl_indices"],
                unicode=bool(int(z["unicode"])), device=device,
            )


def _gather_rows(flat: np.ndarray, starts: np.ndarray, rows: np.ndarray,
                 counts: np.ndarray, w: int) -> np.ndarray:
    """(len(rows), w) zero-padded matrix of each row's units, fully
    vectorized: the NumPy twin of ``native.pack_rows_u8`` /
    ``pack_rows_u32`` (row -1 is size-class padding)."""
    b = len(rows)
    cp = np.zeros((b, w), flat.dtype)
    unit_rows = np.repeat(np.arange(b), counts)
    cum = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(counts, out=cum[1:])
    col_idx = np.arange(cum[-1], dtype=np.int64) - cum[:-1][unit_rows]
    cp[unit_rows, col_idx] = flat[
        starts[np.maximum(rows, 0)][unit_rows] + col_idx
    ]
    return cp


def pack_corpus(
    haystacks: Sequence[str],
    unicode: bool = False,
    bucket_widths: Optional[Sequence[int]] = None,
    device=None,
) -> Corpus:
    """Pack haystacks into buckets resident on ``device`` (default: the
    card): byte units, or codepoint units when ``unicode``. Bucket
    assignment, sparse-bucket consolidation, chained splits and
    size-class padding follow frizbee_tpu's ``pack_corpus`` exactly, so
    both packings hold the same rows. Rows are copied into the buckets by
    the native packer (its NumPy twin under ``native._FORCE_NUMPY``)."""
    dev = resolve_device(device)
    if bucket_widths is None:
        bucket_widths = LANE_BUCKETS
    n = len(haystacks)
    if n >= 1 << 31:
        raise ValueError(
            f"corpus has {n} haystacks; the maximum supported is 2^31 - 1"
        )
    if n == 0:
        return Corpus(list(haystacks), unicode, [], np.zeros(0, np.int64),
                      dev)

    if unicode:
        # unit = codepoint; the UTF-32 round trip vectorizes the decode
        unit_counts = np.fromiter((len(h) for h in haystacks),
                                  dtype=np.int64, count=n)
        flat = np.frombuffer("".join(haystacks).encode("utf-32-le"),
                             dtype=np.uint32)
        joined = None
    else:
        data = [h.encode("utf-8") for h in haystacks]
        unit_counts = np.fromiter((len(d) for d in data), dtype=np.int64,
                                  count=n)
        joined = b"".join(data)
        flat = np.frombuffer(joined, dtype=np.uint8)
        del data
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(unit_counts, out=starts[1:])
    use_native = not native._FORCE_NUMPY
    if not unicode:
        nbytes = unit_counts  # bytes == units
    elif use_native:
        nbytes = native.utf8_lengths(flat, starts)
    else:
        # UTF-8 bytes per row: a global cumsum of unit byte lengths
        glob = np.zeros(flat.shape[0] + 1, dtype=np.int64)
        np.cumsum(_utf8_len(flat.view(np.int32)), out=glob[1:])
        nbytes = glob[starts[1:]] - glob[starts[:-1]]
        del glob

    widths = sorted(set(int(w) for w in bucket_widths))
    max_w = widths[-1]
    assigned = np.full(n, -1, dtype=np.int64)
    for bi, w in enumerate(widths):
        lo = 0 if bi == 0 else widths[bi - 1]
        sel = (unit_counts <= w) & (unit_counts > lo if bi else unit_counts >= 0)
        assigned[sel] = bi
    xl_mask = unit_counts > max_w
    assigned[xl_mask] = -2

    # Consolidate sparse buckets into the next non-empty larger one
    min_rows = max(1024, n // 32)
    counts_per = [int(np.sum(assigned == bi)) for bi in range(len(widths))]
    for bi in range(len(widths) - 1):
        if 0 < counts_per[bi] < min_rows:
            nxt = next(
                (j for j in range(bi + 1, len(widths)) if counts_per[j] > 0),
                None,
            )
            if nxt is not None:
                assigned[assigned == bi] = nxt
                counts_per[nxt] += counts_per[bi]
                counts_per[bi] = 0

    buckets: List[PackedBucket] = []
    for bi, w in enumerate(widths):
        rows_all = np.nonzero(assigned == bi)[0]
        cap = max_bucket_rows(w)
        for s in range(0, rows_all.size, cap):
            rows = rows_all[s : s + cap]
            b = _size_class(rows.size)
            if b > rows.size:
                rows = np.concatenate(
                    [rows, np.full(b - rows.size, -1, np.int64)]
                )
            counts = np.where(rows >= 0, unit_counts[np.maximum(rows, 0)], 0)
            if not use_native:
                cp = _gather_rows(flat, starts, rows, counts, w)
            elif unicode:
                cp = native.pack_rows_u32(flat, starts, rows, w)
            else:
                cp = native.pack_rows_u8(joined, starts, rows, w)
            buckets.append(PackedBucket(
                width=w,
                indices=rows.astype(np.int64),
                cp=cp.view(np.int32) if unicode else cp.view(np.int8),
                n_units=counts.astype(np.int32),
                n_bytes=np.where(rows >= 0, nbytes[np.maximum(rows, 0)],
                                 0).astype(np.int32),
                device=dev,
            ))

    xl = np.nonzero(xl_mask)[0].astype(np.int64)
    return Corpus(list(haystacks), unicode, buckets, xl, dev)
