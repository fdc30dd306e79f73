"""The port's result types and sort utilities against frizbee_tpu's:
``Match`` (fields, ordering, dict and pickle round trips), the
array-backed ``MatchList`` (access, slices, equality, repr, iteration),
the ``MatchIndices`` record, and ``sort.py``'s ``sort_matches`` and four
``k_merge_matches_by_*`` on seeded runs. The reference's ``Match`` may be
its C type, so records compare through ``to_dict``."""

import copy
import pickle
import random

import numpy as np
import pytest

import frizbee_tpu.sort as jsort
import frizbee_tpu.types as jtypes
import frizbee_tpu_torch.sort as tsort
import frizbee_tpu_torch.types as ttypes
from frizbee_tpu_torch import Match, MatchIndices, MatchList, sort_matches

MERGES = (
    "k_merge_matches_by_score_then_index_asc",
    "k_merge_matches_by_score_then_index_desc",
    "k_merge_matches_by_index_asc",
    "k_merge_matches_by_index_desc",
)


def _runs(seed):
    """Seeded runs of matches with unique indices, each pre-sorted by
    (score desc, index asc), as the port and the reference build them."""
    rng = random.Random(seed)
    out, jout, base = [], [], 0
    for _ in range(4):
        n = rng.randint(0, 40)
        rows = [(rng.randint(0, 300), base + i, rng.random() < 0.2,
                 rng.randint(0, 900)) for i in range(n)]
        base += n
        rows.sort(key=lambda r: (-r[0], r[1]))
        out.append([Match(*r) for r in rows])
        jout.append([jtypes.Match(*r) for r in rows])
    return out, jout


def _dicts(ms):
    return [m.to_dict() for m in ms]


def test_match_record_round_trips():
    m = Match(score=17, index=3, exact=True, end_col=9)
    jmatch = jtypes.Match(score=17, index=3, exact=True, end_col=9)
    assert m.to_dict() == jmatch.to_dict()
    assert Match.from_dict(m.to_dict()) == m
    assert Match.from_dict({"score": "5", "index": 2}) == Match(5, 2)
    assert Match.from_index(7) == Match(0, 7, False, 0)
    assert pickle.loads(pickle.dumps(m)) == m
    assert copy.deepcopy(m) == m and copy.copy(m) == m
    assert ttypes._rebuild_match(17, 3, True, 9) == m
    assert Match(5, 1) < Match(5, 2) < Match(4, 0)
    assert m.sort_key() == jmatch.sort_key()
    assert ttypes.PY_MATCH is not Match and callable(ttypes.build_matches)
    assert type(m).__module__ == "frizbee_tpu_torch.native.fastmatch"
    mi = MatchIndices(score=4, index=1, exact=False, indices=[5, 3])
    jmi = jtypes.MatchIndices(score=4, index=1, exact=False, indices=[5, 3])
    assert mi.to_dict() == jmi.to_dict()
    assert MatchIndices.from_dict(mi.to_dict()) == mi
    assert MatchIndices.from_index(2).to_dict() == \
        jtypes.MatchIndices.from_index(2).to_dict()
    assert pickle.loads(pickle.dumps(mi)) == mi


def test_match_list_against_reference():
    rng = np.random.default_rng(5)
    n = 25
    cols = (rng.permutation(100)[:n].astype(np.int64),
            rng.integers(0, 500, n).astype(np.int64),
            rng.random(n) < 0.3,
            rng.integers(0, 60, n).astype(np.int64))
    ml, jml = MatchList(*cols), jtypes.MatchList(*cols)
    assert len(ml) == len(jml) == n
    assert _dicts(ml) == _dicts(jml)
    assert _dicts(ml[3:11:2]) == _dicts(jml[3:11:2])
    assert ml[-1].to_dict() == jml[-1].to_dict()
    assert isinstance(ml[2:4], MatchList)
    assert ml == list(ml) and list(ml) == ml and ml == MatchList(*cols)
    assert ml != MatchList(*cols)[1:]
    assert repr(ml) == repr(jml) and repr(ml[:3]) == repr(jml[:3])
    for a, b in zip(ml.arrays(), cols):
        np.testing.assert_array_equal(a, b)
    copy_path = MatchList(np.arange(5, dtype=np.int64))
    assert _dicts(copy_path) == _dicts(jtypes.MatchList(
        np.arange(5, dtype=np.int64)))
    assert pickle.loads(pickle.dumps(list(ml))) == ml


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sort_and_k_merge_against_reference(seed):
    runs, jruns = _runs(seed)
    flat = [m for r in runs for m in r]
    jflat = [m for r in jruns for m in r]
    rng = random.Random(seed)
    order = list(range(len(flat)))
    rng.shuffle(order)
    shuffled = [flat[i] for i in order]
    jshuffled = [jflat[i] for i in order]
    assert _dicts(sort_matches(shuffled)) == _dicts(
        jsort.sort_matches(jshuffled))
    assert tsort.sort_matches is sort_matches
    assert sort_matches(flat[:1]) == flat[:1] and sort_matches([]) == []
    for name in MERGES:
        got = getattr(tsort, name)(runs)
        assert _dicts(got) == _dicts(getattr(jsort, name)(jruns)), name
        assert len(got) == len(flat)
