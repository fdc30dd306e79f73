"""Path-shaped corpus calibrated to saghen/frizbee's Chromium benchmark
(benches/lib.rs:18-40, BENCHMARKS.md:50-58: 1,406,941 source paths,
median 67 bytes, needle "linux" matching about 8%).

A frozen copy of ``frizbee_tpu_torch.datagen.chromium_like_corpus``: the
same draws from the same generator in the same order, so a seed gives
the same paths; the strings are assembled by one join over word ids
instead of a loop over rows. Each path is 3-8 segments from a fixed vocabulary,
6.1% of them with a ``linux`` segment inserted at a random place, then a
file name ``<stem>_<stem><ext>``.
"""

from __future__ import annotations

from typing import List

import numpy as np

PATH_SEGMENTS = [
    "src", "chrome", "browser", "content", "components", "third_party",
    "ui", "gfx", "net", "base", "build", "cc", "media", "gpu", "ipc",
    "mojo", "services", "extensions", "devtools", "renderer", "views",
    "ash", "blink", "v8", "skia", "webrtc", "linux", "win", "mac",
    "android", "test", "tests", "public", "common", "internal", "core",
    "impl", "api", "util", "tools", "sandbox", "policy", "accessibility",
]
FILE_STEMS = [
    "main", "browser_window", "render_frame_host", "tab_strip_model",
    "navigation_controller", "web_contents", "profile_manager",
    "bookmark_model", "history_service", "download_item", "pref_service",
    "layout_manager", "view_controller", "event_handler", "task_runner",
    "message_loop", "thread_pool", "memory_allocator", "string_util",
    "file_path", "time_ticks", "callback_helpers", "weak_ptr", "observer",
]
FILE_EXTS = [".cc", ".h", ".mm", ".py", ".js", ".ts", ".html", ".css",
             ".gn", ".json", ".md", ".xml", ".grd", ".mojom"]
LINUX_SHARE = 0.061


def generate(num_samples: int = 1_406_941, seed: int = 42) -> List[str]:
    rng = np.random.default_rng(seed)
    n = num_samples
    segs_vocab = [s for s in PATH_SEGMENTS if s != "linux"] + ["linux"]
    linux_id = len(segs_vocab) - 1
    n_seg = rng.integers(3, 9, n)
    segs = rng.choice(linux_id, size=int(n_seg.sum()))
    s1 = rng.choice(len(FILE_STEMS), size=n)
    s2 = rng.choice(len(FILE_STEMS), size=n)
    exts = rng.choice(len(FILE_EXTS), size=n)
    inj = rng.random(n) < LINUX_SHARE
    inj_at = rng.integers(0, 1 << 30, n)

    # the segment tokens of every row in order, "linux" inserted at
    # inj_at % (k + 1) among the row's k segments
    k_out = n_seg + inj
    row_tok0 = np.zeros(n + 1, np.int64)
    np.cumsum(k_out, out=row_tok0[1:])
    ins = np.where(inj, inj_at % (n_seg + 1), n_seg + 1)
    seg_row = np.repeat(np.arange(n), n_seg)
    seg_rank = np.arange(len(segs)) - np.repeat(
        np.concatenate([[0], np.cumsum(n_seg)[:-1]]), n_seg)
    tokens = np.empty(int(row_tok0[-1]), np.int64)
    tokens[row_tok0[seg_row] + seg_rank
           + (seg_rank >= ins[seg_row])] = segs
    tokens[(row_tok0[:-1] + ins)[inj]] = linux_id

    # every row as word ids of one vocabulary: its segments, each with
    # the "/" after it, then stem, "_", stem, extension
    vocab = ([w + "/" for w in segs_vocab] + FILE_STEMS + ["_"]
             + FILE_EXTS)
    stem0, under = len(segs_vocab), len(segs_vocab) + len(FILE_STEMS)
    ext0 = under + 1
    per_row = k_out + 4
    row_w0 = np.zeros(n + 1, np.int64)
    np.cumsum(per_row, out=row_w0[1:])
    words = np.empty(int(row_w0[-1]), np.int64)
    tok_row = np.repeat(np.arange(n), k_out)
    words[row_w0[tok_row] + (np.arange(len(tokens)) - row_tok0[tok_row])] = (
        tokens)
    tail = row_w0[:-1] + k_out
    words[tail] = stem0 + s1
    words[tail + 1] = under
    words[tail + 2] = stem0 + s2
    words[tail + 3] = ext0 + exts
    lens = np.array([len(w) for w in vocab], np.int64)
    row_len = np.add.reduceat(lens[words], row_w0[:-1])
    row0 = np.zeros(n + 1, np.int64)
    np.cumsum(row_len, out=row0[1:])
    text = "".join(map(vocab.__getitem__, words.tolist()))
    return [text[a:b] for a, b in zip(row0[:-1].tolist(), row0[1:].tolist())]
