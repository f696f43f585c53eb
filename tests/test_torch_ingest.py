"""The port's real-time ingest tier (DESIGN.md §18): background
compaction, live memtable views, and their concurrency.

A port ``SegmentedIndex`` running merges off-thread, with live memtable
overlays serving unsealed documents, must answer QT1-QT5 with the same
full (ID, P, E, R) records, modulo the global -> compact doc-id remap, as
a fresh ``build_index`` over the logical corpus, at every observable
point: before any refresh (live view), mid-merge (pinned snapshots),
after swap-in, after faults, and after crash-recovery reopen. The
executor's ``fault_hook`` stalls or fails merges at chosen stages;
writer, deleter and reader threads race the merges. Every wait here
(``wait_idle``, ``result``, ``refresh(wait=True)``, joins) takes a
timeout, so no test can hang the run."""

import json
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core.index_builder import build_index
from repro_torch.core.search import ProximitySearchEngine
from repro_torch.core.torch_search import pack_ord_key_rows
from repro_torch.data.corpus import TokenTable, generate_corpus
from repro_torch.index import (
    CompactionExecutor,
    SegmentedIndex,
    leveled_plan,
    merge_segments,
    size_tiered_plan,
    write_json_atomic,
)
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving.pack_cache import PackedPostingCache

D = 5
T = 30  # seconds any single wait may take


@pytest.fixture(scope="module")
def corpus():
    table, lex = generate_corpus(n_docs=150, mean_doc_len=60, vocab_size=400, seed=3)
    lex.sw_count = 12
    lex.fu_count = 25
    return table.to_doc_lists(), lex


def _sample_query(ftable, lex, want, seed):
    rng = np.random.default_rng(seed)
    sw, fu = lex.sw_count, lex.fu_count
    for _ in range(3000):
        r = int(rng.integers(0, ftable.n_rows))
        d0, p0 = int(ftable.doc_ids[r]), int(ftable.positions[r])
        m = (ftable.doc_ids == d0) & (np.abs(ftable.positions - p0) <= D)
        lems = np.unique(ftable.lemma_ids[m])
        stop = lems[lems < sw]
        freq = lems[(lems >= sw) & (lems < sw + fu)]
        ordi = lems[lems >= sw + fu]
        if want == "qt1" and stop.size >= 3:
            return sorted(rng.choice(stop, 3, replace=False).tolist())
        if want == "qt2" and freq.size >= 2:
            return sorted(rng.choice(freq, 2, replace=False).tolist())
        if want == "qt3" and ordi.size >= 2:
            return sorted(rng.choice(ordi, 2, replace=False).tolist())
        if want == "qt4" and freq.size >= 1 and ordi.size >= 1:
            return sorted([int(rng.choice(freq)), int(rng.choice(ordi))])
        if want == "qt5" and stop.size >= 1 and freq.size + ordi.size >= 2:
            ns = np.concatenate([freq, ordi])
            return sorted(rng.choice(ns, 2, replace=False).tolist() + [int(rng.choice(stop))])
    return None


def _records(matches, remap=None):
    docs = matches.doc.tolist()
    if remap is not None:
        docs = [remap[int(x)] for x in docs]
    return sorted(zip(docs, matches.start.tolist(), matches.end.tolist(),
                      np.round(matches.score, 9).tolist()))


def _oracle(view, docs, lex):
    live = view.live_doc_ids()
    ftable = TokenTable.from_docs([np.array(docs[int(g)], np.int32) for g in live])
    remap = {int(g): i for i, g in enumerate(live.tolist())}
    return ftable, build_index(ftable, lex, max_distance=D), remap


def _assert_oracle_equiv(view, docs, lex, seed=0, min_qts=3):
    """One sampled query per QT: the view's full records equal a fresh
    rebuild's of its logical corpus."""
    if view.live_doc_ids().size == 0:
        return
    ftable, ref, remap = _oracle(view, docs, lex)
    e_view = ProximitySearchEngine(view, top_k=100_000)
    e_ref = ProximitySearchEngine(ref, top_k=100_000)
    tested = 0
    for i, want in enumerate(("qt1", "qt2", "qt3", "qt4", "qt5")):
        q = _sample_query(ftable, lex, want, seed=seed * 71 + i)
        if q is None:
            continue
        r_ref, _ = e_ref.search_ids(q)
        r_view, _ = e_view.search_ids(q)
        assert _records(r_ref) == _records(r_view, remap), (want, q)
        tested += 1
    assert tested >= min_qts


def _assert_view_equiv(view, docs, lex, queries):
    """The given queries' full records equal a fresh rebuild's."""
    _, ref, remap = _oracle(view, docs, lex)
    e_view = ProximitySearchEngine(view, top_k=100_000)
    e_ref = ProximitySearchEngine(ref, top_k=100_000)
    for q in queries:
        assert _records(e_ref.search_ids(q)[0]) == _records(e_view.search_ids(q)[0], remap), q


def _seal_every(seg, docs, every=8):
    """Add docs, sealing by hand every ``every`` (no auto-seal scheduling,
    so the caller holds the job handles)."""
    for i, d in enumerate(docs, 1):
        seg.add_document(d)
        if i % every == 0:
            with seg._lock:
                seg._seal_only()


def _stall(stage):
    """A fault hook that holds a merge at ``stage`` until ``hold`` is set;
    ``entered`` is set when a merge reaches it."""
    hold, entered = threading.Event(), threading.Event()

    def hook(at, job):
        if at == stage:
            entered.set()
            assert hold.wait(T)

    return hook, hold, entered


def _stalled_world(docs, lex, n_docs=40, stall_stage="before_swap"):
    """A background index whose first merge is held at ``stall_stage``."""
    hook, hold, entered = _stall(stall_stage)
    ex = CompactionExecutor(fault_hook=hook)
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=8, tier_fanout=3,
                         background=True, executor=ex)
    for d in docs[:n_docs]:
        seg.add_document(d)
    seg.refresh(wait=False)  # seals + schedules the stalled merge
    assert entered.wait(T)
    return seg, ex, hold, entered


# -- differential interleaving replay -----------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interleaving_replay_oracle(corpus, seed):
    """Randomized add/delete/refresh/search interleavings: the live view
    (sealed segments + memtable overlay + background merges in flight)
    matches the fresh-rebuild oracle at every search step."""
    docs, lex = corpus
    rng = np.random.default_rng(100 + seed)
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=8, tier_fanout=3, background=True)
    alive, nxt, checks = [], 0, 0
    try:
        for step in range(70):
            op = ["add", "add", "add", "add", "delete", "refresh", "search"][int(rng.integers(7))]
            if op == "add" and nxt < len(docs):
                gid = seg.add_document(docs[nxt])
                assert gid == nxt  # gids are assigned sequentially
                alive.append(gid)
                nxt += 1
            elif op == "delete" and alive:
                seg.delete_document(alive.pop(int(rng.integers(len(alive)))))
            elif op == "refresh":
                seg.refresh(wait=bool(rng.integers(2)), timeout=T)
            elif op == "search":
                _assert_oracle_equiv(seg.live_view(), docs, lex, seed=seed * 13 + step,
                                     min_qts=0)
                checks += 1
        seg.refresh(wait=True, timeout=T)
        _assert_oracle_equiv(seg.snapshot(), docs, lex, seed=seed)
        assert checks >= 3
        assert seg.stats["merges"] >= 1  # the replay actually compacted
    finally:
        seg.close()


# -- live memtable visibility ---------------------------------------------------------
def test_live_view_sees_unsealed_adds(corpus):
    docs, lex = corpus
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=50, tier_fanout=3)
    for d in docs[:30]:
        seg.add_document(d)
    seg.refresh()
    for d in docs[30:40]:
        seg.add_document(d)  # memtable only, no refresh
    snap, live = seg.snapshot(), seg.live_view()
    assert set(snap.live_doc_ids().tolist()) == set(range(30))
    assert set(live.live_doc_ids().tolist()) == set(range(40))
    assert live.mem_overlay is not None and live.mem_overlay.is_live
    _assert_oracle_equiv(live, docs, lex, seed=7)


def test_live_view_sees_unrefreshed_deletes(corpus):
    docs, lex = corpus
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=50, tier_fanout=3)
    for d in docs[:30]:
        seg.add_document(d)
    seg.refresh()
    for d in docs[30:36]:
        seg.add_document(d)
    seg.delete_document(5)  # sealed doc
    seg.delete_document(33)  # memtable doc
    live = seg.live_view()
    assert set(live.live_doc_ids().tolist()) == set(range(36)) - {5, 33}
    _assert_oracle_equiv(live, docs, lex, seed=8)


def test_live_view_memoized_until_mutation(corpus):
    docs, lex = corpus
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=50)
    for d in docs[:10]:
        seg.add_document(d)
    v1 = seg.live_view()
    assert seg.live_view() is v1  # no mutation: same frozen overlay
    seg.add_document(docs[10])
    v2 = seg.live_view()
    assert v2 is not v1
    seg.delete_document(0)
    assert seg.live_view() is not v2


# -- mid-merge consistency, fault injection ---------------------------------------------
def test_mid_merge_snapshot_stays_consistent(corpus):
    """A snapshot pinned while a merge is mid-flight serves the oracle's
    records; after swap-in the new snapshot does too, and the pin stays
    valid."""
    docs, lex = corpus
    seg, ex, hold, _ = _stalled_world(docs, lex)
    try:
        pinned = seg.snapshot()
        _assert_oracle_equiv(pinned, docs, lex, seed=21)  # mid-merge
        hold.set()
        assert ex.wait_idle(T)
        assert seg.stats["merges"] >= 1
        post = seg.snapshot()
        assert post is not pinned  # swap-in republished atomically
        _assert_oracle_equiv(post, docs, lex, seed=22)
        _assert_oracle_equiv(pinned, docs, lex, seed=23)
    finally:
        hold.set()
        ex.close()


def test_late_tombstone_survives_merge(corpus):
    """A delete arriving while its doc's segment is being merged is not
    purged by the swap-in (the capture predates it): the doc stays
    masked, never resurrected."""
    docs, lex = corpus
    seg, ex, hold, _ = _stalled_world(docs, lex)
    try:
        seg.delete_document(0)  # doc 0 is inside the merging tier
        hold.set()
        assert ex.wait_idle(T)
        view = seg.refresh(wait=True, timeout=T)
        assert 0 not in set(view.live_doc_ids().tolist())
        assert 0 in set(view.tombstones.tolist())  # survived, not purged
        _assert_oracle_equiv(view, docs, lex, seed=31)
    finally:
        hold.set()
        ex.close()


def test_refresh_seal_only_is_nonblocking(corpus):
    """refresh(wait=False) returns in O(memtable) time while a merge is
    still in flight."""
    docs, lex = corpus
    seg, ex, hold, entered = _stalled_world(docs, lex, stall_stage="before_merge")
    try:
        assert entered.is_set() and ex.pending() >= 1
        for d in docs[40:44]:
            seg.add_document(d)
        t0 = time.perf_counter()
        view = seg.refresh(wait=False)  # merge still stalled: must not block
        assert time.perf_counter() - t0 < 5.0
        assert ex.pending() >= 1
        assert set(view.live_doc_ids().tolist()) >= set(range(44))
        with pytest.raises(TimeoutError):  # a quiesce bounded while stalled
            seg.refresh(wait=True, timeout=0.2)
    finally:
        hold.set()
        ex.close()


def test_foreground_seal_only_refresh_skips_compaction(corpus):
    docs, lex = corpus
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=8, tier_fanout=3)
    for d in docs[:40]:
        seg.add_document(d)
    assert seg.stats["merges"] >= 1  # auto-seal compacts inline
    merges0 = seg.stats["merges"]
    for d in docs[40:44]:  # stay under memtable_docs: no auto-seal
        seg.add_document(d)
    n0 = seg.n_segments
    seg.refresh(wait=False)
    assert seg.stats["merges"] == merges0  # seal-only: no merge ran
    assert seg.n_segments >= n0
    seg.refresh(wait=True)
    _assert_oracle_equiv(seg.snapshot(), docs, lex, seed=41)


def test_superseded_merge_discarded(corpus):
    """A background merge whose victims were rewritten underneath it (a
    forced major compaction won the race) is discarded at validation: no
    duplicate documents."""
    docs, lex = corpus
    hook, hold, entered = _stall("before_merge")
    ex = CompactionExecutor(fault_hook=hook)
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=100, tier_fanout=3,
                         background=True, executor=ex)
    try:
        _seal_every(seg, docs[:40])
        jobs = ex.schedule(seg)
        assert jobs and entered.wait(T)
        seg.compact(force=True)  # inline major compaction rewrites the victims
        hold.set()
        assert jobs[0].result(timeout=T) == "superseded"
        assert ex.stats["superseded"] >= 1
        view = seg.refresh(wait=True, timeout=T)
        assert sorted(view.live_doc_ids().tolist()) == list(range(40))  # no dupes
        _assert_oracle_equiv(view, docs, lex, seed=51)
    finally:
        hold.set()
        ex.close()


def test_overlapping_plan_skipped_and_cancel_honored(corpus):
    docs, lex = corpus
    seg, ex, hold, _ = _stalled_world(docs, lex, stall_stage="before_merge")
    try:
        sched0 = ex.stats["scheduled"]
        assert ex.schedule(seg) == []  # victims overlap the in-flight job
        assert ex.stats["scheduled"] == sched0
        for d in docs[40:60]:
            seg.add_document(d)
        with seg._lock:
            seg._seal_only()
        queued = ex.schedule(seg)
        for j in queued:
            j.cancel()  # cooperative: resolves without merging
        hold.set()
        for j in queued:
            assert j.result(timeout=T) == "cancelled"
        assert ex.wait_idle(T)
    finally:
        hold.set()
        ex.close()


def test_compaction_metrics_and_spans(corpus):
    """The executor records into the port's obs registry and tracer."""
    docs, lex = corpus
    metrics, tracer = MetricsRegistry(), Tracer()
    ex = CompactionExecutor(metrics=metrics, tracer=tracer)
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=8, tier_fanout=3,
                         background=True, executor=ex)
    try:
        for d in docs[:40]:
            seg.add_document(d)
        seg.refresh(wait=True, timeout=T)
        snap = metrics.snapshot("compaction")
        assert snap["compaction.scheduled"] >= 1
        assert snap["compaction.started"] >= 1
        assert snap["compaction.merged"] >= 1
        assert snap["compaction.merge_ms"]["count"] >= 1
        assert ex.stats["merged"] == seg.stats["merges"]
        spans = [s for s in tracer.snapshot() if s.name == "compaction.merge"]
        assert len(spans) == ex.stats["started"]
        assert all(s.cat == "compaction" and s.args["victims"] for s in spans)
    finally:
        ex.close()


def test_rate_limit_spaces_merge_starts(corpus):
    """min_interval_s spaces merge starts: two jobs queued together start
    at least that far apart (each start as the worker stamped it)."""
    docs, lex = corpus
    starts = []

    def hook(stage, job):
        if stage == "before_merge":
            starts.append(ex._last_start)

    ex = CompactionExecutor(min_interval_s=0.3, fault_hook=hook)
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=1000, tier_fanout=2,
                         background=True, executor=ex)
    try:
        _seal_every(seg, docs[:8], every=2)  # four small segments of one tier
        seg._plan_fn = lambda segs, fanout: [[0, 1], [2, 3]]
        jobs = ex.schedule(seg)
        assert len(jobs) == 2
        assert all(j.result(timeout=T) in ("merged", "noop") for j in jobs)
        assert len(starts) == 2 and starts[1] - starts[0] >= 0.3
    finally:
        ex.close()


# -- policies -------------------------------------------------------------------------
def test_leveled_plan_merges_multi_run_tiers():
    class FakeSeg:
        def __init__(self, n):
            self.n_postings = n

    segs = [FakeSeg(10), FakeSeg(12), FakeSeg(300), FakeSeg(11), FakeSeg(4000)]
    assert size_tiered_plan(segs, fanout=4) == []  # tiering needs 4 per tier
    assert leveled_plan(segs, fanout=4) == [[0, 1, 3]]  # any tier with >= 2 runs
    with pytest.raises(ValueError):
        leveled_plan(segs, fanout=1)


def test_leveled_policy_end_to_end(corpus):
    docs, lex = corpus
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=8, tier_fanout=4,
                         background=True, policy="leveled")
    try:
        for d in docs[:60]:
            seg.add_document(d)
        for g in (2, 11, 25):
            seg.delete_document(g)
        view = seg.refresh(wait=True, timeout=T)
        tiers = {}
        for s in view.segments:  # steady state: at most one run per tier
            t = int(np.log(max(s.n_postings, 1)) / np.log(4))
            tiers[t] = tiers.get(t, 0) + 1
        assert all(v == 1 for v in tiers.values()), tiers
        _assert_oracle_equiv(view, docs, lex, seed=61)
    finally:
        seg.close()


@pytest.mark.parametrize("bad", [dict(policy="mystery"), dict(tier_fanout=1),
                                 dict(memtable_docs=0)])
def test_bad_settings_rejected(corpus, bad):
    _, lex = corpus
    with pytest.raises(ValueError):
        SegmentedIndex(lex, **bad)


# -- crash recovery and persistence ---------------------------------------------------
def test_crash_recovery_ignores_orphan_merge_output(tmp_path, corpus):
    """A crash between a merge's segment write and the manifest swap: the
    reopened index serves exactly the pre-merge state; orphaned segment
    dirs (complete or partial) and a torn manifest tmp are ignored."""
    docs, lex = corpus
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=8, tier_fanout=3)
    for d in docs[:30]:
        seg.add_document(d)
    seg.refresh()
    seg.save(tmp_path)
    manifest0 = json.loads((tmp_path / "manifest.json").read_text())
    merged = merge_segments(seg._segments, np.zeros(0, np.int64), lex, D, segment_id=9999)
    merged.save(tmp_path / "seg_009999")  # the merge wrote its output...
    partial = tmp_path / "seg_009998"  # ...another died mid-npz...
    partial.mkdir()
    np.savez(partial / "segment.npz", half=np.zeros(3))
    (tmp_path / "manifest.json.tmp").write_text('{"segments": ["seg_009999"')  # ...torn swap
    out = SegmentedIndex.load(tmp_path)
    assert [s.segment_id for s in out._segments] == [
        int(name[4:]) for name in manifest0["segments"]]
    assert not any(s.segment_id in (9998, 9999) for s in out._segments)
    view = out.refresh()
    assert sorted(view.live_doc_ids().tolist()) == list(range(30))
    _assert_oracle_equiv(view, docs, lex, seed=71)


def test_write_json_atomic_swaps_cleanly(tmp_path):
    target = tmp_path / "m.json"
    write_json_atomic(target, {"v": 1})
    assert json.loads(target.read_text()) == {"v": 1}
    write_json_atomic(target, {"v": 2})
    assert json.loads(target.read_text()) == {"v": 2}
    assert not (tmp_path / "m.json.tmp").exists()  # no tmp residue


def test_background_roundtrip_preserves_lineage(tmp_path, corpus):
    """Save/load through background churn: merge outputs keep their
    ``derived_from`` lineage and the reloaded index is oracle-equivalent."""
    docs, lex = corpus
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=8, tier_fanout=3, background=True)
    try:
        for d in docs[:50]:
            seg.add_document(d)
        for g in (1, 20):
            seg.delete_document(g)
        seg.refresh(wait=True, timeout=T)
        assert seg.stats["merges"] >= 1
        assert any(s.derived_from for s in seg._segments)
        seg.save(tmp_path)
    finally:
        seg.close()
    out = SegmentedIndex.load(tmp_path)
    lineage = {s.segment_id: s.derived_from for s in seg._segments}
    assert {s.segment_id: s.derived_from for s in out._segments} == lineage
    _assert_oracle_equiv(out.refresh(), docs, lex, seed=81)


# -- concurrency ------------------------------------------------------------------------
def _join(threads):
    for t in threads:
        t.join(timeout=T)
    assert not any(t.is_alive() for t in threads)


def test_readers_race_writer_and_merges(corpus):
    """Reader threads pin snapshots and live views and search while a
    writer adds, deletes and refreshes and background merges swap
    segments in (thread switches forced often). Every result stays
    inside its view's live docs, and the quiesced view matches the
    oracle."""
    docs, lex = corpus
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=10, tier_fanout=3, background=True)
    errors: list = []
    stop = threading.Event()
    queries = [[0, 1, 2], [0, 1], [1, 2, 3]]

    def reader(k):
        rng = np.random.default_rng(k)
        try:
            while not stop.is_set():
                view = seg.live_view() if rng.integers(2) else seg.snapshot()
                live = set(view.live_doc_ids().tolist())
                eng = ProximitySearchEngine(view, top_k=100_000)
                for q in queries:
                    got = {int(x) for x in eng.search_ids(q)[0].doc}
                    assert got <= live, "served a dead or unknown doc"
        except BaseException as exc:  # surfaces in the main thread
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    readers = [threading.Thread(target=reader, args=(k,)) for k in range(3)]
    deleted = []
    try:
        for t in readers:
            t.start()
        rng = np.random.default_rng(42)
        for i, d in enumerate(docs):
            gid = seg.add_document(d)
            if rng.integers(4) == 0:
                seg.delete_document(gid)
                deleted.append(gid)
            if i % 25 == 24:
                seg.refresh(wait=False)
        view = seg.refresh(wait=True, timeout=T)
    finally:
        stop.set()
        sys.setswitchinterval(interval)
        _join(readers)
        seg.close()
    assert not errors, errors[0]
    assert seg.stats["merges"] >= 1
    assert set(view.live_doc_ids().tolist()) == set(range(len(docs))) - set(deleted)
    _assert_view_equiv(view, docs, lex, queries)


def test_no_lost_tombstones_under_concurrent_deletes(corpus):
    """Deletes from several threads while merges run: every delete holds
    in the quiesced view (no resurrection through a racing merge)."""
    docs, lex = corpus
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=10, tier_fanout=3, background=True)
    try:
        for d in docs:
            seg.add_document(d)
        seg.refresh(wait=False)
        dead = list(range(0, len(docs), 3))
        errors: list = []

        def deleter(ids):
            try:
                for g in ids:
                    seg.delete_document(g)
            except BaseException as exc:
                errors.append(exc)

        threads = [threading.Thread(target=deleter, args=(dead[k::4],)) for k in range(4)]
        for t in threads:
            t.start()
        seg.refresh(wait=False)  # merges race the deleters
        _join(threads)
        assert not errors, errors[0]
        view = seg.refresh(wait=True, timeout=T)
        assert set(view.live_doc_ids().tolist()) == set(range(len(docs))) - set(dead)
        _assert_view_equiv(view, docs, lex, [[0, 1, 2], [1, 2]])
    finally:
        seg.close()


def test_merge_failure_leaves_state_intact_and_result_raises(corpus):
    """A merge raising mid-flight fails its job (result() re-raises, never
    hangs), leaves the pre-merge state serving correctly, and a later
    healthy refresh compacts as usual."""
    docs, lex = corpus

    class Boom(RuntimeError):
        pass

    armed = {"on": True}

    def hook(stage, job):
        if stage == "before_swap" and armed["on"]:
            raise Boom("injected mid-merge failure")

    ex = CompactionExecutor(fault_hook=hook)
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=100, tier_fanout=3,
                         background=True, executor=ex)
    try:
        _seal_every(seg, docs[:40])
        n0 = seg.n_segments
        jobs = ex.schedule(seg)
        assert jobs
        with pytest.raises(Boom):
            jobs[0].result(timeout=T)
        assert ex.stats["failed"] == 1
        assert seg.n_segments == n0  # no partial swap
        assert seg.stats["merges"] == 0
        _assert_view_equiv(seg.refresh(wait=False), docs, lex, [[0, 1, 2]])
        armed["on"] = False  # heal the fault: compaction proceeds
        view = seg.refresh(wait=True, timeout=T)
        assert seg.stats["merges"] >= 1
        _assert_view_equiv(view, docs, lex, [[0, 1, 2]])
    finally:
        ex.close()


def test_failed_merge_does_not_wedge_refresh_wait(corpus):
    """refresh(wait=True) over a persistently failing executor returns
    (compaction falls behind) instead of spinning."""
    docs, lex = corpus

    def hook(stage, job):
        if stage == "before_merge":
            raise RuntimeError("always failing")

    ex = CompactionExecutor(fault_hook=hook)
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=8, tier_fanout=3,
                         background=True, executor=ex)
    try:
        for d in docs[:40]:
            seg.add_document(d)
        view = seg.refresh(wait=True, timeout=T)
        assert seg.stats["merges"] == 0 and ex.stats["failed"] >= 1
        assert sorted(view.live_doc_ids().tolist()) == list(range(40))
    finally:
        ex.close()


def test_pack_cache_retained_across_background_merge(corpus):
    """Warm pack-cache entries survive a pure background compaction:
    untouched keys are served as hits and the retained rows are bitwise
    what a fresh derivation would produce."""
    docs, lex = corpus
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=10, tier_fanout=3, background=True)
    try:
        for d in docs[:50]:
            seg.add_document(d)
        v1 = seg.refresh(wait=False)
        cache = PackedPostingCache()
        keys = [0, 1, 2, 13, 14]
        warm = {k: cache.get(v1, "ord", k, 1024, 1) for k in keys}
        v2 = seg.refresh(wait=True, timeout=T)  # background merges swapped in
        assert seg.stats["merges"] >= 1 and v2 is not v1
        st0 = cache.stats
        for k in keys:
            got = cache.get(v2, "ord", k, 1024, 1)
            assert got[0] is warm[k][0]  # retained: same arrays
            np.testing.assert_array_equal(got[0], pack_ord_key_rows(v2, k, 1024, 1)[0])
        st = cache.stats
        assert st["retained"] > 0
        assert st["hits"] == st0["hits"] + len(keys)
        assert st["misses"] == st0["misses"]
    finally:
        seg.close()


def test_wait_idle_and_result_timeouts_bounded(corpus):
    """wait_idle(timeout) returns False and result(timeout) raises
    TimeoutError while a merge stalls; both complete once it lifts."""
    docs, lex = corpus
    hook, hold, entered = _stall("before_merge")
    ex = CompactionExecutor(fault_hook=hook)
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=100, tier_fanout=3,
                         background=True, executor=ex)
    try:
        _seal_every(seg, docs[:40])
        jobs = ex.schedule(seg)
        assert jobs and entered.wait(T)
        assert ex.wait_idle(timeout=0.2) is False
        with pytest.raises(TimeoutError):
            jobs[0].result(timeout=0.2)
        hold.set()
        assert jobs[0].result(timeout=T) in ("merged", "noop")
        assert ex.wait_idle(T)
    finally:
        hold.set()
        ex.close()
    assert not any(t.is_alive() for t in ex._threads)  # close() stopped the pool
