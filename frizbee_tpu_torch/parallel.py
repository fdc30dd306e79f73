"""Device-mesh parallel matching: shard the corpus, merge top-k globally.

Counterpart of ``frizbee_tpu/parallel.py`` on ``torch.distributed``. The
packed corpus rows are split data-parallel into equal shards, one per
entry of a 1-D :class:`Mesh`; each shard runs the match on its rows,
sorts them by the global order key and keeps its top-k, and the shards
merge through a gather and one sort of the gathered runs. The merge key
includes the unique global index, so the order is total and the merged
result equals the single-device one, bit for bit (the reference's
parallel == sequential property).

A mesh is driven in one of two ways:

- **single controller** (:func:`make_mesh`): this process runs every
  shard, one per visible card, or ``n_devices`` shards on one device
  (``device="cpu"`` in tests, ``"cuda"`` on one card). The collectives
  are a stack or a sum of the shards' tensors on the first shard's
  device.
- **multi-controller** (:func:`initialize_distributed`): one process per
  shard, joined by a ``torch.distributed`` process group (NCCL on the
  card, gloo on the CPU, or as the caller names it). Every process packs
  the same corpus and runs only its own shard's rows; the collectives are
  ``all_gather`` and ``all_reduce`` over the group.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .corpus import resolve_device
from .ops.batch import INT32_MAX, _fused_match_body, order_keys
from .ops.fuzzy import fuzzy_pipeline
from .ops.presence import PLANES

DATA_AXIS = "data"

# Sentinel index for padding rows; sorts after every real index
PAD_INDEX = INT32_MAX


class Mesh:
    """A 1-D data-parallel mesh along :data:`DATA_AXIS`.

    ``devices`` are the devices of the shards this process runs, in shard
    order; ``group`` is the process group joining the controllers, or
    None when this process runs every shard. Under a group each process
    runs one shard, its rank's."""

    def __init__(self, devices: Sequence, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.group = group
        if group is not None and len(self.devices) != 1:
            raise ValueError("a multi-controller mesh runs one shard a "
                             "process")

    @property
    def size(self) -> int:
        """Shards in the whole mesh."""
        if self.group is None:
            return len(self.devices)
        return dist.get_world_size(self.group)

    def local_shards(self) -> List[Tuple[int, torch.device]]:
        """(shard index, device) of each shard this process runs."""
        if self.group is None:
            return list(enumerate(self.devices))
        return [(dist.get_rank(self.group), self.devices[0])]


def _indexed(dev: torch.device) -> torch.device:
    """A card device with its index: tensors moved there compare equal
    to it, so a move to the device a tensor is on stays a no-op."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A single-controller mesh. With no ``device``: one shard on each of
    the first ``n_devices`` cards (default all), raising where there is
    no card. With a ``device``: ``n_devices`` shards (default 1) on that
    one device, the counterpart of JAX's virtual CPU devices."""
    if device is None:
        resolve_device(None)  # raises without a card
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(f"{n} shards asked, {count} cards visible")
        return Mesh([torch.device("cuda", i) for i in range(n)])
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs a shard, {n} asked")
    return Mesh([_indexed(torch.device(device))] * n)


def initialize_distributed(*, world_size: int, rank: int, init_method: str,
                           backend: Optional[str] = None,
                           device=None) -> Mesh:
    """Multi-controller setup: join the process group and return a mesh
    of one shard a rank. Call once per process before serving::

        mesh = initialize_distributed(
            init_method="tcp://host0:29500", world_size=4, rank=r)

    ``device`` defaults to the card (raising where there is none); a card
    device without an index becomes ``cuda:(rank % device_count)``, made
    the current device. ``backend`` defaults to NCCL on the card and gloo
    on the CPU; nothing switches backend after a failure. Tear down with
    ``torch.distributed.destroy_process_group()``."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return Mesh([dev], group=dist.group.WORLD)


def _all_gather(mesh: Mesh, parts: List[torch.Tensor]) -> torch.Tensor:
    """The local shards' equal-shape tensors -> (shards, ...) in shard
    order on the first local device (``jax.lax.all_gather``)."""
    if mesh.group is None:
        dev = mesh.devices[0]
        return torch.stack([p.to(dev) for p in parts])
    (t,) = parts
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t.contiguous(), group=mesh.group)
    return torch.stack(out)


def _psum(mesh: Mesh, parts: List[torch.Tensor]) -> torch.Tensor:
    """The local shards' tensors summed over the whole mesh, on the first
    local device (``jax.lax.psum``)."""
    if mesh.group is None:
        dev = mesh.devices[0]
        return torch.stack([p.to(dev) for p in parts]).sum(
            dim=0, dtype=parts[0].dtype)
    (t,) = parts
    t = t.clone()
    dist.all_reduce(t, group=mesh.group)
    return t


def _sort_by_pair(key1, key2, *payload, dim=-1):
    """Ascending (key1, key2) order along ``dim``, as one int64 key:
    ``key2`` is a non-negative index or PAD_INDEX, so ``key1 << 32 |
    key2`` orders as the pair does. Equal pairs join only entries that
    hold no match (padding, unmatched rows); the sort keeps their order."""
    k64 = (key1.to(torch.int64) << 32) | key2.to(torch.int64)
    perm = torch.sort(k64, dim=dim, stable=True).indices
    return tuple(torch.gather(x, dim, perm)
                 for x in (key1, key2) + payload)


def _local_match_topk(cp, first_byte, prev_last_byte, byte_off, byte_len,
                      n_units, n_bytes, row_index, needle_orig, needle_flip,
                      sc, *, max_typos, no_prefilter, k):
    """Per-shard pipeline: match rows -> sort by global key -> top-k, as
    one (5, k) int32 tensor (key1, key2, score, aux, end_col)."""
    matched, score, exact, end_col, needs_greedy, _ws, _we = fuzzy_pipeline(
        cp, first_byte, prev_last_byte, byte_off, byte_len, n_units,
        n_bytes, needle_orig, needle_flip, sc,
        max_typos=max_typos, no_prefilter=no_prefilter,
    )
    # padding rows carry row_index == PAD_INDEX: mask them out
    matched = matched & (row_index != PAD_INDEX)
    key1, key2 = order_keys(matched, score, row_index)
    # exact and needs_greedy share one operand through the sort: greedy
    # rows must reach the host for rescoring (their device score is a
    # window-capped approximation)
    aux = (exact.to(torch.int32) << 1) | needs_greedy.to(torch.int32)
    cols = _sort_by_pair(key1, key2, score.to(torch.int32), aux,
                         end_col.to(torch.int32))
    return torch.stack(cols)[:, :k]


def _merge_topk(g, k):
    """Merge gathered per-shard sorted runs, (shards, 5, kl), into the
    global top-k: (matched, index, score, exact, end_col,
    needs_greedy)."""
    key1, key2, score, aux, end_col = _sort_by_pair(
        *g.transpose(0, 1).reshape(5, -1))
    k = min(k, key1.shape[0])
    aux = aux[:k]
    return (key2[:k] != PAD_INDEX, key2[:k], score[:k], (aux >> 1) > 0,
            end_col[:k], (aux & 1) > 0)


def put_global_sharded(arr, mesh: Mesh,
                       replicated: bool = False) -> List[torch.Tensor]:
    """Host or device rows -> this process's part of a mesh-global array:
    one tensor per local shard, on its device. Row-sharded (the default),
    shard s takes rows ``[s*chunk, (s+1)*chunk)``, chunk = rows / mesh
    size (``pad_bucket_for_mesh`` makes the rows a multiple), in both
    controller modes: a multi-controller process feeds only its rank's
    rows. ``replicated``: every shard takes the whole array."""
    t = torch.as_tensor(arr)
    if replicated:
        return [t.to(dev) for _s, dev in mesh.local_shards()]
    n = mesh.size
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split into {n} shards")
    chunk = t.shape[0] // n
    return [t[s * chunk:(s + 1) * chunk].to(dev)
            for s, dev in mesh.local_shards()]


def sharded_match_topk(
    cp, first_byte, prev_last_byte, byte_off, byte_len, n_units, n_bytes,
    row_index, needle_orig, needle_flip, sc,
    *, mesh: Mesh, max_typos: int = 0, no_prefilter: bool = False,
    k: int = 64,
):
    """Shard a packed bucket over ``mesh`` and return the global top-k.

    Inputs are the packed bucket arrays (see :func:`pad_bucket_for_mesh`)
    with the batch dim padded to a multiple of the mesh size, as host
    arrays or tensors; padding rows carry ``row_index == PAD_INDEX``.
    Returns (matched, index, score, exact, end_col, needs_greedy), each
    (k,) on the mesh's first local device, the same in every process:
    the global top-k rows in (score desc, index asc) order. Rows flagged
    needs_greedy carry a window-capped device score and must be rescored
    on the host (:func:`match_corpus_sharded` does)."""
    rows = [put_global_sharded(a, mesh) for a in (
        cp, first_byte, prev_last_byte, byte_off, byte_len, n_units,
        n_bytes, row_index)]
    needle = [put_global_sharded(a, mesh, replicated=True)
              for a in (needle_orig, needle_flip, sc)]
    runs = [
        _local_match_topk(*(r[j] for r in rows), *(x[j] for x in needle),
                          max_typos=max_typos, no_prefilter=no_prefilter,
                          k=k)
        for j in range(len(mesh.local_shards()))
    ]
    # the collective: every shard's sorted top-k to every process
    return _merge_topk(_all_gather(mesh, runs), k)


def pad_bucket_for_mesh(bucket, n_shards: int):
    """Pad a PackedBucket's arrays so the batch dim divides the mesh size.

    Returns (cp, first_byte, prev_last_byte, byte_off, byte_len, n_units,
    n_bytes, row_index) as numpy, with padding rows flagged by
    ``row_index == PAD_INDEX`` and zero units so they never match."""
    b = bucket.size
    padded = -(-b // n_shards) * n_shards
    pad = padded - b

    def pad_rows(x, fill=0):
        if pad == 0:
            return x
        return np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, x.dtype)], axis=0
        )

    idx = bucket.indices.astype(np.int64)
    idx = np.where(idx < 0, PAD_INDEX, idx)  # size-class pad rows
    row_index = pad_rows(idx.astype(np.int32), PAD_INDEX)
    cp, first, prev, boff, blen = bucket._full_arrays()
    return (
        pad_rows(cp),
        pad_rows(first),
        pad_rows(prev, -1),
        pad_rows(boff),
        pad_rows(blen),
        pad_rows(bucket.n_units),
        pad_rows(bucket.n_bytes),
        row_index,
    )


def match_corpus_sharded(
    corpus, engine, mesh: Mesh, k: int = 64
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Match every bucket of ``corpus`` on the mesh and merge bucket
    top-ks.

    Host-side wrapper over :func:`sharded_match_topk`; greedy and XL rows
    are rescored by the engine's host path, exactly like the
    single-device engine. Returns (index, score, exact, end_col) of the
    global top-k in (score desc, index asc) order. Works single- and
    multi-controller: every process packs the same corpus and feeds its
    own shards' rows (:func:`put_global_sharded`)."""
    no_prefilter = engine.config.max_typos is None
    typos = 0 if no_prefilter else int(engine.config.max_typos)
    orig, flip, sc = engine._device_needle(mesh.devices[0])
    n = mesh.size

    parts = []
    for bucket in corpus.buckets:
        matched, index, score, exact, end_col, greedy = [
            x.cpu().numpy().copy()  # writable: greedy rows are patched
            for x in sharded_match_topk(
                *pad_bucket_for_mesh(bucket, n), orig, flip, sc,
                mesh=mesh, max_typos=typos, no_prefilter=no_prefilter, k=k,
            )
        ]
        # greedy rows (trimmed window > DP cap) carry capped device
        # scores; rescore on the host like the single-device engine does
        keep = matched.copy()
        for j in np.nonzero(matched & greedy)[0]:
            m = engine.match_one(corpus.haystacks[int(index[j])],
                                 int(index[j]))
            if m is None:
                keep[j] = False
            else:
                score[j], exact[j], end_col[j] = m.score, m.exact, m.end_col
        parts.append((index[keep], score[keep], exact[keep].astype(bool),
                      end_col[keep]))
    # XL rows (host path)
    for i in corpus.xl_indices:
        m = engine.match_one(corpus.haystacks[int(i)], int(i))
        if m is not None:
            parts.append(
                (np.array([m.index]), np.array([m.score]),
                 np.array([m.exact]), np.array([m.end_col]))
            )
    if not parts:
        z = np.zeros(0, np.int64)
        return z, z, z.astype(bool), z
    index = np.concatenate([p[0] for p in parts])
    score = np.concatenate([p[1] for p in parts])
    exact = np.concatenate([p[2] for p in parts])
    end_col = np.concatenate([p[3] for p in parts])
    order = np.lexsort((index, -score))[:k]
    return index[order], score[order], exact[order], end_col[order]


# -- batched (multi-query) sharded serving -----------------------------------


class ShardView:
    """Rows ``[lo, hi)`` of a bucket padded to a multiple of the mesh
    size, on ``device``: the bucket-like object ``ops/batch.
    _fused_match_body`` runs unchanged (``size``, ``width``,
    ``unicode``, ``device_arrays()``, ``device_arrays_rowmajor()``, and
    ``device_presence_bits()`` as its ``bits8``). Rows past the bucket
    are padding with zero units, index -1 and previous byte -1 (the
    corpus's own size-class padding, which can never match) and no
    presence bits. Each array is built on first use: with ``from_host``
    from the bucket's host arrays, only these rows moving to ``device``;
    else as views of the bucket's device tensors (rows inside the
    bucket, on the bucket's device)."""

    def __init__(self, bucket, lo: int, hi: int, device: torch.device,
                 from_host: bool = False):
        self.bucket = bucket
        self.lo, self.hi = lo, hi
        self.device = device
        self.from_host = from_host
        self.width = bucket.width
        self.unicode = bucket.unicode
        self._arrays = {}

    @property
    def size(self) -> int:
        return self.hi - self.lo

    def _rows(self, a, fill: int) -> torch.Tensor:
        """This view's rows of ``a`` (a host array or a device tensor),
        padded with ``fill``, on the view's device."""
        b = a.shape[0]
        part = a[min(self.lo, b):min(self.hi, b)]
        pad = self.size - part.shape[0]
        if isinstance(a, np.ndarray):
            if pad:
                part = np.concatenate(
                    [part, np.full((pad,) + a.shape[1:], fill, a.dtype)])
            dtype = a.dtype if a.dtype in (np.int8, np.uint8) else np.int32
            return torch.from_numpy(
                np.ascontiguousarray(part, dtype)).to(self.device)
        part = part.to(self.device)
        if pad == 0:
            return part
        return torch.cat([part, torch.full(
            (pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
            device=self.device)])

    def _cached(self, name, host, device, fills):
        if name not in self._arrays:
            arrays = host() if self.from_host else device()
            self._arrays[name] = tuple(
                self._rows(a, f) for a, f in zip(arrays, fills))
        return self._arrays[name]

    def device_arrays(self):
        # (cp, first_byte, prev_last_byte, byte_off, byte_len, n_units,
        #  n_bytes, indices)
        b = self.bucket
        return self._cached(
            "full",
            lambda: b._full_arrays() + (b.n_units, b.n_bytes, b.indices),
            b.device_arrays, (0, 0, -1, 0, 0, 0, 0, -1))

    def device_arrays_rowmajor(self):
        # (cp, n_units, indices)
        b = self.bucket
        return self._cached("rowmajor",
                            lambda: (b.cp, b.n_units, b.indices),
                            b.device_arrays_rowmajor, (0, 0, -1))

    def device_presence_bits(self) -> torch.Tensor:
        if "bits" not in self._arrays:
            if self.from_host:  # the planes of this view's rows' counts
                counts = self._rows(self.bucket.presence_counts(), 0)
                bits = torch.cat([counts > k for k in range(PLANES)],
                                 dim=1).to(torch.int8)
            else:
                bits = self._rows(self.bucket.device_presence_bits(), 0)
            self._arrays["bits"] = bits
        return self._arrays["bits"]


def _mesh_pad_buckets(corpus, mesh: Mesh):
    """Per local shard, one :class:`ShardView` a bucket: shard s of a
    bucket of B rows holds rows ``[s*chunk, (s+1)*chunk)`` with chunk =
    ceil(B / mesh size), so every shard holds the same rows. The views
    are kept on the corpus for each mesh layout, so a shard's rows reach
    its device once. A shard on the bucket's own device in a single
    controller views the bucket's device tensors; under a process group,
    or on another device, a view is built from the host rows of its own
    shard alone, so a rank never holds the whole bucket on its card."""
    key = (mesh.size, tuple(mesh.local_shards()), mesh.group is not None)
    cache = corpus.__dict__.setdefault("_shard_views", {})
    if key not in cache:
        n = mesh.size
        out = []
        for s, dev in mesh.local_shards():
            views = []
            for b in corpus.buckets:
                chunk = -(-b.size // n)
                from_host = (mesh.group is not None
                             or _indexed(b.device) != dev)
                views.append(ShardView(b, s * chunk, (s + 1) * chunk, dev,
                                       from_host=from_host))
            out.append(tuple(views))
        cache[key] = out
    return cache[key]


def sharded_match_sorted_batch(
    shards, stacked_patterns,
    *, mesh: Mesh, n: int, pattern_statics: Tuple,
    sort_by_score: bool, use_kernel: bool, fetch_rows: int,
):
    """Q-query mesh-sharded serving over the full query syntax: the
    multi-device form of ``ops/batch.fused_match_sorted_batch``.

    ``shards`` holds this process's shards (:func:`_mesh_pad_buckets`),
    ``stacked_patterns`` one (orig (Q, n), flip (Q, n), sc (Q, 9)) per
    pattern. Each shard runs the generic single-device body
    (``ops/batch._fused_match_body``: multi-pattern combine with negation
    veto, literal modes, fuzzy atoms on the ``match_units`` kernel where
    ``use_kernel`` holds, every sort strategy) over its views and keeps
    its sorted top ``kl = max(1, min(fetch_rows, rows a shard))``
    [index, meta] rows; the shards merge with one gather and a sort on
    keys rebuilt from the rows (score rides meta; the unique global
    index makes the order total). Exact per-query match counts sum
    across the mesh.

    Returns (Q, 1 + fetch_rows, 2) int32 on the mesh's first local
    device, the same in every process, with the single-device batch's
    layout: row 0 is [total_count, 0], rows 1.. are [index, meta] (meta
    as in ``ops/batch._pack_meta``), zero past the matches. Callers apply
    the single-device host fixups (``matcher._finalize_topk``)."""
    parts, counts_l = [], []
    for views in shards:
        dev = views[0].device
        pats = tuple(tuple(a.to(dev) for a in p) for p in stacked_patterns)
        b_local = sum(v.size for v in views)
        kl = max(1, min(fetch_rows, b_local))
        out = _fused_match_body(
            tuple(v.device_presence_bits() for v in views)
            if use_kernel else None,
            views, pats, n=n, pattern_statics=pattern_statics,
            sort_by_score=sort_by_score, use_kernel=use_kernel,
            fetch_rows=kl,
        )
        q = out.shape[0]
        cl = out[:, 0, 0]  # local match counts
        index_l = out[:, 1:, 0]
        meta_l = out[:, 1:, 1]
        valid = torch.arange(kl, device=dev)[None, :] < cl[:, None]
        # Merge keys rebuilt from the rows: the device-side order is
        # always (matched first, score desc, index asc) for score sorts
        # and index asc otherwise, _select_sorted's order; a reversed
        # strategy is applied on the host afterwards, as on one device
        # (matcher._host_fixups). The score is the logical meta >> 16.
        score = (meta_l >> 16) & 0xFFFF
        if sort_by_score:
            key1 = torch.where(valid, -score, PAD_INDEX)
            key2 = torch.where(valid, index_l, PAD_INDEX)
        else:
            key1 = key2 = torch.where(valid, index_l, PAD_INDEX)
        meta_m = torch.where(valid, meta_l, 0)
        parts.append(torch.stack([key1, key2, meta_m]).to(torch.int32))
        counts_l.append(cl)
    counts = _psum(mesh, counts_l)
    g = _all_gather(mesh, parts)  # (shards, 3, Q, kl)
    k1, k2, mm = g.permute(1, 2, 0, 3).reshape(3, q, -1)
    _k1, k2, mm = _sort_by_pair(k1, k2, mm, dim=1)
    f = min(fetch_rows, k2.shape[1])
    matched_m = k2[:, :f] != PAD_INDEX
    idx_m = torch.where(matched_m, k2[:, :f], 0)
    mm = torch.where(matched_m, mm[:, :f], 0)
    rows = torch.stack([idx_m, mm], dim=2)
    if f < fetch_rows:
        rows = torch.cat([rows, rows.new_zeros((q, fetch_rows - f, 2))],
                         dim=1)
    header = torch.stack([counts, torch.zeros_like(counts)], dim=1)
    return torch.cat([header[:, None, :], rows], dim=1)


def match_topk_batch_sharded(queries, corpus, mesh: Mesh, config=None,
                             k: int = 64):
    """Multi-query mesh-sharded top-k serving: the multi-device form of
    ``matcher.match_topk_batch``, covering the full query syntax —
    multi-pattern combine (negation veto), literal modes, typo budgets,
    every sort strategy.

    Q queries run against a corpus sharded data-parallel over ``mesh``,
    grouped into one sharded pass per query shape (pattern statics,
    needle lengths, ``use_kernel``); each returns ``(total_count, index,
    score, exact, end_col)`` with at most ``k`` rows, equal to the
    single-device serving path's. Greedy and XL rows go through the same
    ``_finalize_topk`` host fixups, applied to the same globally ordered
    fetched set. Queries the fused device path cannot serve (empty
    needles, a unit mode other than the corpus's) take the single-device
    path. A corpus given as strings is packed on the mesh's first local
    device."""
    from .config import Config
    from .matcher import Matcher, _finalize_topk, _resolve_batch

    config = config or Config()
    matchers, corpus = _resolve_batch(queries, corpus, config,
                                      device=mesh.devices[0])
    kfetch = max(1, min(k, len(corpus)))

    groups = {}
    prepared = {}
    for i, m in enumerate(matchers):
        if not m._fused_supported():
            continue
        if m._compiled[0].engine.unicode != corpus.unicode:
            continue
        if not corpus.buckets:
            continue  # XL/empty corpus: nothing to shard, host path only
        statics, use_kernel = m._fused_statics(corpus)
        hosts = tuple(cp.engine._host_needle() for cp in m._compiled)
        key = (statics, tuple(h[0].shape[0] for h in hosts), use_kernel)
        groups.setdefault(key, []).append(i)
        prepared[i] = hosts

    shards = _mesh_pad_buckets(corpus, mesh) if groups else None
    pending = []
    for (statics, _lens, use_kernel), members in groups.items():
        stacked = tuple(
            tuple(torch.from_numpy(np.stack([prepared[i][p][a]
                                             for i in members]))
                  for a in range(3))
            for p in range(len(statics))
        )
        out = sharded_match_sorted_batch(
            shards, stacked, mesh=mesh, n=len(corpus),
            pattern_statics=statics, sort_by_score=config.sort.is_by_score,
            use_kernel=use_kernel, fetch_rows=kfetch,
        )
        pending.append((out, members))

    raw = [None] * len(matchers)
    for out, members in pending:
        all_rows = out.cpu().numpy()  # one fetch per group
        for qi, i in enumerate(members):
            block = all_rows[qi]
            count = int(block[0, 0])
            rows = block[1:1 + min(count, block.shape[0] - 1)]
            raw[i] = (count,) + Matcher._decode_rows(rows)
    # _finalize_topk applies the same host fixups, greedy-overflow
    # fallback and per-query single-device fallback as match_topk_batch
    return _finalize_topk(matchers, corpus, raw, k)
