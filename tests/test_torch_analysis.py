"""The port's framework-free checks (``repro_torch.analysis``) against the
reference's (``repro/analysis/lock_lint.py``, ``mask_check.py``): the lock
lint's findings on the reference's seeded sources, an unlocked write
caught, the port's real sources clean; a seeded unsound skip predicate
(the reference's ``strict_live``, tests/test_analysis.py:99) caught, the
real predicate clean on the boundary and empirical sweeps (ragged rows,
the tool prefill and Phi-3-vision's prefixed rows included), and the
port's sweep on the reference's predicate giving the reference's
report."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.analysis import lock_lint as jlock  # noqa: E402
from repro.analysis import mask_check as jmask  # noqa: E402
from repro.kernels import tree_attention as jta  # noqa: E402
from repro_torch.analysis import lock_lint as tlock  # noqa: E402
from repro_torch.analysis import mask_check as tmask  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

# the reference's seeded source (tests/test_shardlint.py:143-158)
SEEDED = '''
class Pipe:
    def __init__(self):
        self._cv = object()
        self._results = {}
        self._n = 0

    def ok(self):
        with self._cv:
            self._results[1] = "x"
            self._n += 1

    def racy(self):
        self._results[2] = "y"      # unlocked subscript store
        self._n += 1                # unlocked augassign
        self._results.pop(2)        # unlocked mutator call
'''

# a tuple target, as WeightStore.publish writes (_params, _ready)
SEEDED_TUPLE = '''
class Store:
    def __init__(self):
        self._cond = object()
        self._params, self._ready = {}, None

    def publish(self, p):
        with self._cond:
            self._params, self._ready = p, None

    def racy(self, p):
        self._params, (self._ready, _) = p, (None, 0)
'''


def _rules(mod, **kw):
    return {"Pipe": mod.LockRule(lock="_cv", **kw)}


@pytest.mark.parametrize("fields,exempt", [
    (frozenset({"_results", "_n"}), {}),
    (frozenset({"_results"}), {"_n": "single writer"}),
    (frozenset(), {}),
])
def test_lock_lint_matches_the_reference_on_seeded_sources(fields, exempt):
    """Same findings, message for message, as the reference's lint on its
    own seeded source: the three unlocked writes in ``racy``, ``__init__``
    exempt, an exempt field skipped."""
    got = tlock.check_source(SEEDED, _rules(tlock, fields=fields,
                                            exempt=exempt), "seeded.py")
    want = jlock.check_source(SEEDED, _rules(jlock, fields=fields,
                                             exempt=exempt), "seeded.py")
    assert got == want
    assert len(got) == {2: 3, 1: 2, 0: 0}[len(fields)]
    assert all("racy" in m for m in got)


def test_lock_lint_catches_an_unlocked_tuple_write():
    """Each name of a tuple target is a write: the locked publish is
    clean, the unlocked one is caught for both fields (the reference's
    walk skips tuple targets and reports nothing)."""
    rules = {"Store": tlock.LockRule(
        lock="_cond", fields=frozenset({"_params", "_ready"}))}
    got = tlock.check_source(SEEDED_TUPLE, rules)
    assert len(got) == 2 and all("Store.racy" in m for m in got)
    assert any("_params" in m for m in got)
    assert any("_ready" in m for m in got)
    jrules = {"Store": jlock.LockRule(
        lock="_cond", fields=frozenset({"_params", "_ready"}))}
    assert jlock.check_source(SEEDED_TUPLE, jrules) == []


def test_lock_discipline_holds_on_the_port_sources():
    assert tlock.lock_findings() == []


def test_lock_rules_name_the_port_s_classes_and_fields():
    """Every rule's class exists in its file and every guarded or exempt
    field is written there (an outdated rule would pass vacuously), and
    an unlocked write planted in a copy of each locked class is caught."""
    for rel, rules in tlock.LOCK_RULES.items():
        src = (PORT / rel).read_text()
        tree = ast.parse(src)
        classes = {n.name: n for n in ast.walk(tree)
                   if isinstance(n, ast.ClassDef)}
        for cls, rule in rules.items():
            assert cls in classes, (rel, cls)
            written = {t.attr for n in ast.walk(classes[cls])
                       if isinstance(n, (ast.Assign, ast.AugAssign))
                       for tgt in (n.targets if isinstance(n, ast.Assign)
                                   else [n.target])
                       for t in ast.walk(tgt)
                       if isinstance(t, ast.Attribute)}
            assert rule.fields | set(rule.exempt) <= written, (cls, written)
            if rule.lock is None:
                continue
            f = sorted(rule.fields)[0]
            planted = src + (f"\n\nclass {cls}({cls}):\n"
                             f"    def racy(self):\n"
                             f"        self.{f} = None\n")
            msgs = tlock.check_source(planted, {cls: rule}, rel)
            assert any("racy" in m and f in m for m in msgs), msgs


def _strict_live(q_start, q_end, kv_start, block_max, qp_min=None,
                 kp_max=None, window=None):
    """tests/test_analysis.py:102's seeded bug: strict > wrongly skips
    tiles with block_max == q_start, which still hold the visible pair
    (i = q_start, j ≤ i)."""
    live = (kv_start <= q_end) & (block_max > q_start)
    if window is not None:
        live = live & ((qp_min - kp_max) < window)
    return live


def test_mask_check_catches_an_unsound_predicate():
    buckets = [(32, 32, 0, None), (32, 32, 8, 63)]
    found, _ = tmask.check_predicate(_strict_live, buckets=buckets)
    assert found and all(f.check == "mask" for f in found)
    assert "UNSOUND" in found[0].message
    want = jmask.check_predicate(_strict_live, buckets=buckets)[0]
    assert [str(f) for f in found] == [str(f) for f in want]


@pytest.mark.parametrize("fast", [True, False])
def test_mask_check_real_predicate_clean(fast):
    found, rep = tmask.check_predicate(fast=fast)
    assert found == []
    assert rep["unsound_skips"] == 0
    assert 0.0 < rep["proven_skip_rate"] < 1.0


@pytest.mark.parametrize("window", [None, 7])
def test_empirical_sweep_clean_on_ragged_and_serving_rows(window):
    found, rep = tmask.empirical_mask_check(seeds=range(2), window=window)
    assert found == []
    assert rep["proven_skip_rate"] > 0.0


def test_empirical_sweep_catches_a_mask_that_drops_a_tile(monkeypatch):
    """A ``block_live_mask`` that loses the diagonal tile of every row is
    caught."""
    real = tmask.block_live_mask

    def lossy(*a, **kw):
        m = np.array(real(*a, **kw))
        np.fill_diagonal(m, False)
        return m

    monkeypatch.setattr(tmask, "block_live_mask", lossy)
    found, _ = tmask.empirical_mask_check(seeds=range(1), ragged=False)
    assert found and "skipped" in found[0].message


def test_port_sweep_on_the_reference_predicate_gives_its_report():
    """On the reference's fast bucket universe, the port's sweep of the
    reference's ``block_live``, the port's sweep of the port's, and the
    reference's own sweep give the same report; the port's real shapes
    are the tiles its CUDA sources declare."""
    buckets = jmask.bucket_universe(fast=True)
    want = jmask.check_predicate(jta.block_live, buckets=buckets)
    assert tmask.check_predicate(jta.block_live, buckets=buckets) == want
    assert tmask.check_predicate(ta.block_live, buckets=buckets) == want
    assert dataclasses.asdict(tmask.Finding("t", "mask", "m")) == \
        {"target": "t", "check": "mask", "message": "m"}
    tiles = tmask.kernel_tiles()
    assert tiles["simple fwd"] == (ta.BLOCK_Q, ta.BLOCK_K) == (64, 64)
    assert tiles["hopper fwd/dq hd 192"] == (128, 64)
    assert {bq for bq, _, _, _ in tmask.bucket_universe()} == {64, 128}
