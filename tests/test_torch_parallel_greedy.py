"""Mesh-sharded batch serving over greedy and XL rows in the port against
frizbee_tpu.parallel, the greedy cases of ``tests/test_parallel.py``:
Unicode rows whose window passes the DP cap (host-rescored) with an XL
row, and greedy rows at the k boundary for k in (2, 4, 8, 32), where the
host fixups must see the globally ordered fetched set, not a shard's.

ASCII needles over a codepoint corpus take the single-device path in
both packages, as the reference's cases do; each case runs again under
``UnicodeMatching.ALWAYS``, where the needles are codepoints and the
batch is sharded. Every case at 2, 4 and 8 shards, held as
``test_torch_parallel.check_batch_sharded`` holds the others."""

import pytest

from test_torch_parallel import SHARDS, check_batch_sharded

# case: (corpus, queries, config keywords, k, sharded)
GREEDY_CASES = {
    "unicode_greedy_xl": ("greedy_xl", ["linux", "kernel"], {}, 16, False),
    "unicode_greedy_xl_always": ("greedy_xl", ["linux", "kernel"],
                                 {"unicode": "ALWAYS"}, 16, True),
    **{f"greedy_k{k}{sfx}": ("k_boundary", ["linux"], kw, k, sharded)
       for k in (2, 4, 8, 32)
       for sfx, kw, sharded in (("", {}, False),
                                ("_always", {"unicode": "ALWAYS"}, True))},
}


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_greedy_batch_sharded(case, n, monkeypatch):
    name, queries, kw, k, sharded = GREEDY_CASES[case]
    check_batch_sharded(name, queries, kw, k, n, monkeypatch, sharded)
