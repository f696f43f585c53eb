"""The port's segmented index against the reference package's: the same
seeded corpus goes through the same operation sequence (adds, deletes,
seal-only and compacting refreshes, forced compactions, a live memtable
overlay) on both ``SegmentedIndex`` classes, under both compaction
policies. At every checkpoint each segment's arrays, ``doc_map``,
``segment_id`` and ``derived_from``, the tombstones and every merged read
over the lexicon must be equal, and port and reference ``SearchService``
instances refreshed at the same points must serve equal records and
routes with equal pack-cache stats, raw and compressed, with
``serve_memtable`` and ``scalar_memtable`` on and off. Persistence crosses
both ways (reference save, port load, and the reverse), and
``carry_index`` takes a reference ``SegmentedIndex`` and ``SegmentedView``.
Exact equality throughout. The card test (``-m cuda``) serves a churned
port source on the card and holds it to the CPU run.

The reference imports are optional so that the card test can run on a
host without JAX; here they are always present."""

import json

import numpy as np
import pytest
import torch

from repro_torch.core import torch_search as port_ts
from repro_torch.core.index_builder import build_index
from repro_torch.core.lexicon import Lexicon
from repro_torch.core.search import ProximitySearchEngine
from repro_torch.data.corpus import TokenTable, generate_corpus, sample_mixed_queries
from repro_torch.index import (
    SegmentedIndex,
    SegmentedView,
    carry_index,
    index_to_arrays,
    load_index,
    save_index,
    size_tiered_plan,
    write_json_atomic,
)
from repro_torch.index.segment import MemSegment
from repro_torch.kernels.nearest_r import window_join
from repro_torch.serving import SearchService, ServeConfig
from repro_torch.serving.planner import FB_LIVE_MEMTABLE

try:
    from repro.core import jax_search as ref_ts
    from repro.core.index_builder import build_index as jax_build_index
    from repro.core.lexicon import Lexicon as JaxLexicon
    from repro.data.corpus import generate_corpus as jax_generate_corpus
    from repro.index import SegmentedIndex as JaxSegmentedIndex
    from repro.index import SegmentedView as JaxSegmentedView
    from repro.index import load_index as jax_load_index
    from repro.index import save_index as jax_save_index
    from repro.index import write_json_atomic as jax_write_json_atomic
    from repro.index.persist import index_to_arrays as jax_index_to_arrays
    from repro.index.segment import MemSegment as JaxMemSegment
    from repro.launch.mesh import make_mesh
    from repro.serving import SearchService as JaxService
    from repro.serving import ServeConfig as JaxConfig
except ImportError:  # a card host without JAX runs only the card test
    ref_ts = None

D = 5
MEMTABLE, FANOUT = 24, 3
KNOBS = dict(buckets=(256, 1024, 4096), max_batch=16, top_k=16)
# (compressed, serve_memtable, scalar_memtable); the compressed services
# pin the payload to the reference's first arm (no measured arbitration,
# whose choices follow each package's own timings)
SERVICES = {
    "raw": (False, False, True),
    "raw-memtable-scalar": (False, True, True),
    "raw-memtable-packed": (False, True, False),
    "compressed": (True, False, True),
    "compressed-memtable-scalar": (True, True, True),
    "compressed-memtable-packed": (True, True, False),
}
CHECKPOINTS = ("seed", "add-only", "pure-compaction", "delete", "add-merge",
               "purge", "overlay", "overlay-delete", "seal")
KINDS = ("ordinary", "wv", "fst", "nsw")


def _corpus(gen):
    table, lex = gen(n_docs=260, mean_doc_len=60, vocab_size=800, seed=13)
    lex.sw_count = 14
    lex.fu_count = 30
    return table, lex


def _replay(seg, docs, on_checkpoint):
    """The operation sequence, identical for both packages; ``seg`` is a
    foreground index, so every merge runs inline at a fixed point."""
    rng = np.random.default_rng(5)
    # the longest document stays, so the doc stride holds and the purge
    # below is a transition the row caches retain across
    dead: list[int] = [int(np.argmax([len(d) for d in docs]))]

    def delete(n, below):
        alive = sorted(set(range(below)) - set(dead))
        for g in rng.choice(alive, n, replace=False).tolist():
            seg.delete_document(g)
            dead.append(g)

    for d in docs[:144]:  # six auto-seals, inline compaction as tiers fill
        seg.add_document(d)
    on_checkpoint("seed", seg.refresh())
    for d in docs[144:164]:  # below memtable_docs: no auto-seal
        seg.add_document(d)
    on_checkpoint("add-only", seg.refresh(wait=False))  # seal only
    seg.compact(force=True)
    on_checkpoint("pure-compaction", seg.refresh(wait=False))
    delete(12, 164)
    on_checkpoint("delete", seg.refresh(wait=False))
    for d in docs[164:220]:  # auto-seals with inline merges
        seg.add_document(d)
    on_checkpoint("add-merge", seg.refresh())
    seg.compact(force=True)  # absorbs and purges every tombstone
    on_checkpoint("purge", seg.refresh(wait=False))
    for d in docs[220:232]:  # memtable only: live views overlay it
        seg.add_document(d)
    on_checkpoint("overlay", seg.snapshot())
    delete(1, 220)  # a sealed doc
    seg.delete_document(225)  # a memtable doc
    on_checkpoint("overlay-delete", seg.snapshot())
    on_checkpoint("seal", seg.refresh())


def _segments(view):
    return [(s.segment_id, s.doc_map, tuple(s.derived_from), s.is_live) for s in view.segments]


@pytest.fixture(scope="module")
def ref_pkg():
    if ref_ts is None:
        pytest.skip("the JAX reference package is not installed")


def _run(policy, with_services):
    """Both packages through the sequence; per checkpoint, the published
    views and, with services, every service's drain and stats."""
    jt, jl = _corpus(jax_generate_corpus)
    pt, pl = _corpus(generate_corpus)
    queries = sample_mixed_queries(pt, pl, 48, window=D, seed=9)
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {"queries": queries}
    for name, seg_cls, lex, table in (
            ("jax", JaxSegmentedIndex, jl, jt), ("port", SegmentedIndex, pl, pt)):
        seg = seg_cls(lex, max_distance=D, memtable_docs=MEMTABLE, tier_fanout=FANOUT,
                      policy=policy)
        services = {}
        for cname, (comp, mem, scalar) in (SERVICES.items() if with_services else ()):
            knobs = dict(KNOBS, compressed=comp, payload_cost_driven=False,
                         serve_memtable=mem, scalar_memtable=scalar)
            services[cname] = (JaxService(seg, mesh, JaxConfig(**knobs)) if name == "jax"
                               else SearchService(seg, ServeConfig(**knobs), device="cpu"))
        got = {"views": {}, "live": {}, "drains": {}, "stats": {}}

        def on_checkpoint(ckpt, view):
            got["views"][ckpt] = view
            got["live"][ckpt] = seg.live_view()
            for cname, svc in services.items():
                svc.refresh()
                for q in queries:
                    svc.submit(q)
                got["drains"][cname, ckpt] = svc.drain()
                got["stats"][cname, ckpt] = svc.stats_snapshot()

        _replay(seg, table.to_doc_lists(), on_checkpoint)
        got["index"] = seg
        out[name] = got
    return out


@pytest.fixture(scope="module")
def world(ref_pkg):
    return _run("size_tiered", with_services=True)


@pytest.fixture(scope="module")
def leveled(ref_pkg):
    return _run("leveled", with_services=False)


def _assert_arrays_equal(got: dict, want: dict, what=""):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
        assert got[k].dtype == want[k].dtype, (what, k)


def _assert_views_equal(pv, jv):
    assert _segments_meta(pv) == _segments_meta(jv)
    for ps, js in zip(pv.segments, jv.segments):
        np.testing.assert_array_equal(ps.doc_map, js.doc_map)
        assert ps.doc_map.dtype == js.doc_map.dtype
        _assert_arrays_equal(index_to_arrays(ps.index), jax_index_to_arrays(js.index),
                             f"segment {ps.segment_id}")
    np.testing.assert_array_equal(pv.tombstones, jv.tombstones)
    np.testing.assert_array_equal(pv.doc_lengths, jv.doc_lengths)
    np.testing.assert_array_equal(pv.live_doc_ids(), jv.live_doc_ids())
    assert pv.n_total_docs == jv.n_total_docs
    assert pv.size_report() == jv.size_report()


def _segments_meta(view):
    return [(i, d.tolist(), f, live) for i, d, f, live in _segments(view)]


def _assert_reads_equal(pv, jv, kind):
    if kind == "ordinary":
        keys = range(len(jv.lexicon.lemmas))
        read = lambda v, k: v.read_ordinary(k)  # noqa: E731
    elif kind == "nsw":
        keys = range(len(jv.lexicon.lemmas))
        read = lambda v, k: v.nsw.read(k)  # noqa: E731
    else:
        keys = sorted(getattr(jv, kind).keys())
        assert sorted(getattr(pv, kind).keys()) == keys
        read = lambda v, k: getattr(v, f"read_{kind}")(k)  # noqa: E731
    n = 0
    for k in keys:
        for a, b in zip(read(pv, k), read(jv, k)):
            np.testing.assert_array_equal(a, b, err_msg=f"{kind} {k}")
            assert a.dtype == b.dtype, (kind, k)
            n += int(a.size)
        if kind != "nsw":
            assert getattr(pv, kind).n_postings(k) == getattr(jv, kind).n_postings(k)
    assert n > 0


# -- the index: segments and merged reads --------------------------------------------
@pytest.mark.parametrize("ckpt", CHECKPOINTS)
def test_segments_equal_reference(world, ckpt):
    pv, jv = world["port"]["views"][ckpt], world["jax"]["views"][ckpt]
    _assert_views_equal(pv, jv)
    assert pv.epoch == jv.epoch


@pytest.mark.parametrize("ckpt", CHECKPOINTS)
def test_leveled_segments_equal_reference(leveled, ckpt):
    _assert_views_equal(leveled["port"]["views"][ckpt], leveled["jax"]["views"][ckpt])


@pytest.mark.parametrize("ckpt", ("delete", "overlay-delete", "seal"))
def test_live_views_equal_reference(world, ckpt):
    pv, jv = world["port"]["live"][ckpt], world["jax"]["live"][ckpt]
    _assert_views_equal(pv, jv)
    assert (pv.mem_overlay is not None) == (jv.mem_overlay is not None) \
        == (ckpt == "overlay-delete")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ckpt", ("delete", "purge", "overlay-delete"))
def test_merged_reads_equal_reference(world, ckpt, kind):
    """Every key's merged read (tombstones applied, local ids mapped,
    segment order kept) equals the reference's; the overlay case reads a
    live view."""
    src = "live" if ckpt == "overlay-delete" else "views"
    _assert_reads_equal(world["port"][src][ckpt], world["jax"][src][ckpt], kind)


@pytest.mark.parametrize("kind", KINDS)
def test_leveled_merged_reads_equal_reference(leveled, kind):
    _assert_reads_equal(leveled["port"]["views"]["add-merge"],
                        leveled["jax"]["views"]["add-merge"], kind)


def test_sequence_exercises_every_transition(world):
    port = world["port"]["index"]
    assert port.stats == world["jax"]["index"].stats
    assert port.stats["merges"] >= 3 and port.stats["docs_deleted"] == 14
    views = world["port"]["views"]
    assert views["pure-compaction"].segments[0].derived_from
    assert views["delete"].tombstones.size == 12
    assert views["purge"].tombstones.size == 0 and len(views["purge"].segments) == 1
    assert world["port"]["live"]["overlay"].mem_overlay.is_live


def test_build_index_is_one_sealed_segment(world):
    """The port's build_index routes through MemSegment.seal(0), as the
    reference's does."""
    pt, pl = _corpus(generate_corpus)
    mem = MemSegment(pl, max_distance=D)
    mem.add_table(pt)
    seg = mem.seal(segment_id=0)
    _assert_arrays_equal(index_to_arrays(build_index(pt, pl, max_distance=D)),
                         index_to_arrays(seg.index))
    np.testing.assert_array_equal(seg.doc_map, np.arange(pt.n_docs))


# -- serving across refreshes ---------------------------------------------------------
def _plan_fields(r):
    p = r.plan
    return (r.path, r.bucket) + (() if p is None else (p.route, p.fallback_reason, p.payload))


@pytest.mark.parametrize("ckpt", CHECKPOINTS)
@pytest.mark.parametrize("config", list(SERVICES))
def test_service_records_match_reference(world, config, ckpt):
    got, want = world["port"]["drains"][config, ckpt], world["jax"]["drains"][config, ckpt]
    assert len(got) == len(want) == len(world["queries"])
    hits = 0
    for q, g, w in zip(world["queries"], got, want):
        assert _plan_fields(g) == _plan_fields(w), q
        for col in ("doc", "start", "end", "score"):
            np.testing.assert_array_equal(g.results[col], w.results[col], err_msg=f"{q} {col}")
        hits += int(g.results["doc"].size)
    assert hits > 0


@pytest.mark.parametrize("ckpt", CHECKPOINTS)
@pytest.mark.parametrize("config", list(SERVICES))
def test_service_stats_match_reference(world, config, ckpt):
    """Routes, paths, refreshes and the row caches' counters (hits,
    misses, retained entries, invalidations, bytes) agree at each step."""
    ps, js = world["port"]["stats"][config, ckpt], world["jax"]["stats"][config, ckpt]
    for key in ("requests", "refreshes", "paths", "batches", "compressed_batches",
                "offset_fallbacks", "pack_cache", "compressed_cache"):
        assert ps[key] == js[key], key
    assert ps["plans"]["routes"] == js["plans"]["routes"]
    assert ps["plans"]["fallbacks"] == js["plans"]["fallbacks"]
    assert ps["refreshes"] == CHECKPOINTS.index(ckpt) + 1


def test_retention_and_live_routes_are_exercised(world):
    """The sequence reaches the transitions the cache retains across and
    the live-memtable route: retained entries after the add-only, pure
    compaction and purge refreshes, FB_LIVE_MEMTABLE only with
    scalar_memtable, and overlay records that include unsealed docs."""
    stats, drains = world["port"]["stats"], world["port"]["drains"]
    for config, (comp, _, _) in SERVICES.items():
        # compressed lookups hit the compressed-row cache first; the raw
        # cache behind it sees a new snapshot only on a compressed miss
        cache = "compressed_cache" if comp else "pack_cache"
        retained = [stats[config, c][cache]["retained"] for c in CHECKPOINTS]
        assert retained[1] > retained[0] and retained[2] > retained[1], (config, retained)
        assert retained[5] > retained[4], (config, retained)
    for config, (_, mem, scalar) in SERVICES.items():
        live = stats[config, "overlay"]["plans"]["fallbacks"].get(FB_LIVE_MEMTABLE, 0)
        assert (live > 0) == (mem and scalar), config
        served = {int(d) for r in drains[config, "overlay"] for d in r.results["doc"]}
        assert bool(served & set(range(220, 232))) == mem, config
        served = {int(d) for r in drains[config, "overlay-delete"] for d in r.results["doc"]}
        assert 225 not in served


def test_memtable_drains_equal_after_seal(world):
    """Once the memtable is sealed, every configuration serves the same
    records: the live view and the published snapshot hold the same docs."""
    drains = world["port"]["drains"]
    want = drains["raw", "seal"]
    for config in SERVICES:
        for g, w in zip(drains[config, "seal"], want):
            for col in ("doc", "start", "end", "score"):
                np.testing.assert_array_equal(g.results[col], w.results[col])


def test_packed_rows_take_doc_lengths_off_the_view(world):
    """Global ids with holes: the packers size g = doc * stride + pos from
    the view's doc_lengths (indexed by global id) exactly as the
    reference's do."""
    pv, jv = world["port"]["views"]["delete"], world["jax"]["views"]["delete"]
    assert port_ts.qt1_stride(pv) == ref_ts.qt1_stride(jv)
    assert pv.doc_lengths.size == pv.n_total_docs > pv.live_doc_ids().size
    for lemma in range(0, 40, 3):
        for a, b in zip(port_ts.pack_ord_key_rows(pv, lemma, 1024),
                        ref_ts.pack_ord_key_rows(jv, lemma, 1024)):
            np.testing.assert_array_equal(a, b)
    for key in sorted(jv.fst.keys())[:20]:
        for a, b in zip(port_ts.pack_fst_key_rows(pv, key, 1024),
                        ref_ts.pack_fst_key_rows(jv, key, 1024)):
            np.testing.assert_array_equal(a, b)


def test_packed_g_wraps_past_int32_like_reference(ref_pkg):
    """Pinned, not guarded: g = doc * stride + pos is computed in int64
    and stored into int32 rows, so a global doc id past 2**31 / stride
    wraps, in the reference as in the port (a long document sets the
    stride; ids with holes reach the wrap without that many live docs)."""
    counts = np.arange(40, 0, -1) * 100
    kw = dict(counts=counts, doc_freqs=np.minimum(counts, 3), n_docs=3, sw_count=4, fu_count=8)
    long_doc = [30] * 40_000  # an ordinary lemma: no fst/wv work
    stride = 40_000 + D + 2
    big = 2**31 // stride + 7
    rows = []
    for lex_cls, mem_cls, view_cls, ts in (
            (JaxLexicon, JaxMemSegment, JaxSegmentedView, ref_ts),
            (Lexicon, MemSegment, SegmentedView, port_ts)):
        lex = lex_cls.from_rank_counts(**kw)
        mem = mem_cls(lex, max_distance=D)
        for gid, doc in ((0, [0, 1, 2, 30]), (1, long_doc), (big, [0, 1, 2, 30])):
            mem.add_document(gid, doc)
        view = view_cls((mem.seal(0),), np.zeros(0, np.int64), lex, D, big + 1)
        assert ts.qt1_stride(view) == stride
        key = sorted(view.fst.keys())[0]
        rows.append((ts.pack_ord_key_rows(view, 0, 256)[0],
                     ts.pack_fst_key_rows(view, key, 256)[0]))
    for a, b in zip(*rows):
        np.testing.assert_array_equal(a, b)
    g_ord = rows[1][0]
    true_g = big * stride + 0  # lemma 0 at position 0 of the doc `big`
    assert true_g >= 2**31
    assert int(g_ord[1]) == int(np.int64(true_g).astype(np.int32)) < 0


# -- persistence and carrying across -------------------------------------------------
def _assert_index_state_equal(port_idx, jax_idx):
    assert port_idx._next_doc == jax_idx._next_doc
    assert port_idx._next_seg == jax_idx._next_seg
    assert port_idx._tombstones == jax_idx._tombstones
    assert (port_idx.memtable_docs, port_idx.tier_fanout, port_idx._flags) == (
        jax_idx.memtable_docs, jax_idx.tier_fanout, jax_idx._flags)
    _assert_views_equal(port_idx.snapshot(), jax_idx.snapshot())


def _drain_cpu(source, queries):
    svc = SearchService(source, ServeConfig(**KNOBS), device="cpu")
    for q in queries:
        svc.submit(q)
    return svc.drain()


def _assert_same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for col in ("doc", "start", "end", "score"):
            np.testing.assert_array_equal(g.results[col], w.results[col])


def _tree(path):
    """Every file under ``path``: JSON parsed, npz as arrays."""
    out = {}
    for f in sorted(path.rglob("*")):
        if f.is_file():
            rel = f.relative_to(path).as_posix()
            if f.suffix == ".json":
                out[rel] = json.loads(f.read_text())
            else:
                with np.load(f) as z:
                    out[rel] = {k: z[k] for k in z.files}
    return out


def _assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for rel in a:
        if rel.endswith(".json"):
            assert a[rel] == b[rel], rel
        else:
            _assert_arrays_equal(a[rel], b[rel], rel)


@pytest.mark.parametrize("direction", ["reference-to-port", "port-to-reference"])
def test_segmented_save_load_crosses(world, tmp_path, direction):
    """The on-disk layout is the reference's: a save by either package
    loads in the other with equal state, and both saves are the same
    files (manifest, lexicon, per-segment meta and npz)."""
    jidx, pidx = world["jax"]["index"], world["port"]["index"]
    jidx.save(tmp_path / "jax")
    pidx.save(tmp_path / "port")
    _assert_trees_equal(_tree(tmp_path / "jax"), _tree(tmp_path / "port"))
    if direction == "reference-to-port":
        loaded = SegmentedIndex.load(tmp_path / "jax")
        _assert_index_state_equal(loaded, jidx)
        _assert_same_records(_drain_cpu(loaded, world["queries"]),
                             world["jax"]["drains"]["raw", "seal"])
    else:
        loaded = JaxSegmentedIndex.load(tmp_path / "port")
        _assert_index_state_equal(pidx, loaded)
        _assert_same_records(world["port"]["drains"]["raw", "seal"],
                             _drain_cpu(SegmentedIndex.load(tmp_path / "port"),
                                        world["queries"]))


def test_plain_save_load_crosses(ref_pkg, tmp_path):
    jt, jl = _corpus(jax_generate_corpus)
    jidx = jax_build_index(jt, jl, max_distance=D)
    jax_save_index(jidx, tmp_path / "jax")
    pidx = load_index(tmp_path / "jax")
    _assert_arrays_equal(index_to_arrays(pidx), jax_index_to_arrays(jidx))
    save_index(pidx, tmp_path / "port")
    _assert_trees_equal(_tree(tmp_path / "jax"), _tree(tmp_path / "port"))
    _assert_arrays_equal(jax_index_to_arrays(jax_load_index(tmp_path / "port")),
                         jax_index_to_arrays(jidx))


def test_write_json_atomic_matches_reference(ref_pkg, tmp_path):
    obj = {"segments": ["seg_000001"], "next_doc": 7, "tombstones": [1, 5]}
    write_json_atomic(tmp_path / "port.json", obj)
    jax_write_json_atomic(tmp_path / "jax.json", obj)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    write_json_atomic(tmp_path / "port.json", {"v": 2})
    assert json.loads((tmp_path / "port.json").read_text()) == {"v": 2}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["jax.json", "port.json"]


def test_carry_segmented_index(world):
    jidx = world["jax"]["index"]
    carried = carry_index(jidx)
    assert isinstance(carried, SegmentedIndex) and carried.policy == jidx.policy
    _assert_index_state_equal(carried, jidx)
    _assert_same_records(_drain_cpu(carried, world["queries"]),
                         world["jax"]["drains"]["raw", "seal"])


@pytest.mark.parametrize("ckpt", ["pure-compaction", "overlay-delete"])
def test_carry_segmented_view(world, ckpt):
    jv = world["jax"]["live"][ckpt]
    carried = carry_index(jv)
    assert isinstance(carried, SegmentedView)
    _assert_views_equal(carried, jv)
    assert (carried.mem_overlay is None) == (jv.mem_overlay is None)
    for kind in KINDS:
        _assert_reads_equal(carried, jv, kind)


def test_carry_refuses_unsealed_memtable(ref_pkg):
    table, lex = _corpus(jax_generate_corpus)
    seg = JaxSegmentedIndex(lex, max_distance=D, memtable_docs=MEMTABLE)
    for d in table.to_doc_lists()[:30]:
        seg.add_document(d)
    with pytest.raises(ValueError, match="refresh"):
        carry_index(seg)
    seg.refresh()
    _assert_index_state_equal(carry_index(seg), seg)


# -- on a card -------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("compressed", [False, True])
def test_churned_source_on_card_equals_cpu(cuda, compressed):
    """A churned port source (background merges, deletes, an unsealed
    overlay) served on the card and on the CPU, refreshed at the same
    points: equal records at every step, and the window join launched."""
    table, lex = _corpus(generate_corpus)
    docs = table.to_doc_lists()
    queries = sample_mixed_queries(table, lex, 48, window=D, seed=9)
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=MEMTABLE, tier_fanout=FANOUT,
                         background=True)
    try:
        for d in docs[:160]:
            seg.add_document(d)
        knobs = dict(KNOBS, compressed=compressed, serve_memtable=True, scalar_memtable=False)
        card = SearchService(seg, ServeConfig(**knobs), device=cuda)
        cpu = SearchService(seg, ServeConfig(**knobs), device="cpu")
        before = window_join.launches
        for step in range(4):
            for d in docs[160 + 20 * step:180 + 20 * step]:
                seg.add_document(d)
            for g in range(step, 160, 17):
                seg.delete_document(g)
            seg.refresh(wait=step == 3, timeout=60)
            seg.add_document(docs[240 + step])  # unsealed: the overlay
            got = []
            for svc in (card, cpu):
                svc.refresh()
                for q in queries:
                    svc.submit(q)
                got.append(svc.drain())
            _assert_same_records(*got)
        assert window_join.launches > before
    finally:
        seg.close()


# -- the port's segmented index against a fresh rebuild ------------------------------
def _sample_query(ftable, lex, want, seed):
    rng = np.random.default_rng(seed)
    sw, fu = lex.sw_count, lex.fu_count
    for _ in range(4000):
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


@pytest.fixture(scope="module")
def churned():
    """90 docs streamed through small memtables; 12 deleted mid-stream;
    tiered merges along the way and a major compaction at the end; and a
    fresh port build over the surviving corpus."""
    table, lex = generate_corpus(n_docs=90, mean_doc_len=60, vocab_size=400, seed=3)
    lex.sw_count = 12
    lex.fu_count = 25
    docs = table.to_doc_lists()
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=10, tier_fanout=3)
    for d in docs[:60]:
        seg.add_document(d)
    seg.refresh()
    dead = sorted(np.random.default_rng(7).choice(60, size=12, replace=False).tolist())
    for g in dead:
        seg.delete_document(g)
    for d in docs[60:]:
        seg.add_document(d)
    seg.refresh()
    seg.compact(force=True)
    view = seg.refresh()
    live = view.live_doc_ids()
    ftable = TokenTable.from_docs([np.array(docs[int(g)], np.int32) for g in live])
    fresh = build_index(ftable, lex, max_distance=D)
    remap = {int(g): i for i, g in enumerate(live.tolist())}
    return view, lex, ftable, fresh, remap, set(dead)


@pytest.mark.parametrize("want", ["qt1", "qt2", "qt3", "qt4", "qt5"])
def test_churned_equals_fresh_rebuild(churned, want):
    """Segmented + compacted == fresh rebuild, full (ID, P, E, R) records."""
    view, lex, ftable, fresh, remap, dead = churned
    eng_seg = ProximitySearchEngine(view, top_k=10_000)
    eng_ref = ProximitySearchEngine(fresh, top_k=10_000)
    tested = 0
    for trial in range(4):
        q = _sample_query(ftable, lex, want, seed=100 + 31 * trial + ord(want[-1]))
        if q is None:
            continue
        r_seg, _ = eng_seg.search_ids(q)
        assert _records(eng_ref.search_ids(q)[0]) == _records(r_seg, remap), (want, q)
        assert not {int(x) for x in r_seg.doc} & dead
        tested += 1
    assert tested > 0


def test_refresh_visibility():
    """Adds are invisible until refresh(); snapshots are immutable."""
    table, lex = generate_corpus(n_docs=20, mean_doc_len=40, vocab_size=300, seed=11)
    lex.sw_count, lex.fu_count = 10, 20
    docs = table.to_doc_lists()
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=100)
    for d in docs[:10]:
        seg.add_document(d)
    v1 = seg.refresh()
    for d in docs[10:]:
        seg.add_document(d)
    assert seg.snapshot() is v1 and v1.live_doc_ids().size == 10
    assert seg.refresh().live_doc_ids().size == len(docs)
    assert v1.live_doc_ids().size == 10


def test_size_tiered_auto_compaction():
    table, lex = generate_corpus(n_docs=64, mean_doc_len=30, vocab_size=300, seed=13)
    lex.sw_count, lex.fu_count = 10, 20
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=4, tier_fanout=4)
    for d in table.to_doc_lists():
        seg.add_document(d)
    seg.refresh()
    assert seg.stats["seals"] == 16 and seg.stats["merges"] >= 1
    assert seg.n_segments < 16
    assert not size_tiered_plan(seg._segments, seg.tier_fanout)


def test_multi_tier_plan_merges_without_staleness():
    """Two tiers due at once: maybe_compact replans after each merge, so
    no stale index can duplicate a document."""
    _, lex = generate_corpus(n_docs=5, mean_doc_len=10, vocab_size=100, seed=1)
    lex.sw_count, lex.fu_count = 5, 10
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=10**9, tier_fanout=3)

    def seal_batch(docs):
        mem = seg._new_mem()
        base = seg._next_doc
        for i, t in enumerate(docs):
            mem.add_document(base + i, t)
        seg._next_doc = base + len(docs)
        seg._segments.append(mem.seal(seg._next_seg))
        seg._next_seg += 1

    for _ in range(3):
        seal_batch([[1, 2, 3]] * 2)  # small tier
    for _ in range(3):
        seal_batch([[k % 50 for k in range(400)]] * 2)  # big tier
    assert len(size_tiered_plan(seg._segments, 3)) >= 2
    seg.maybe_compact()
    view = seg.refresh()
    all_docs = np.concatenate([s.doc_map for s in seg._segments])
    assert np.unique(all_docs).size == all_docs.size == seg._next_doc
    assert view.live_doc_ids().size == seg._next_doc


def test_delete_idempotent_across_compaction():
    """Re-deleting a doc whose tombstone a compaction purged is a no-op."""
    table, lex = generate_corpus(n_docs=12, mean_doc_len=20, vocab_size=200, seed=2)
    lex.sw_count, lex.fu_count = 8, 16
    seg = SegmentedIndex(lex, max_distance=D, memtable_docs=4)
    gids = [seg.add_document(d) for d in table.to_doc_lists()]
    seg.refresh()
    seg.delete_document(gids[0])
    deleted = seg.stats["docs_deleted"]
    seg.compact(force=True)
    assert seg.refresh().tombstones.size == 0  # purged by the merge
    seg.delete_document(gids[0])
    seg.delete_document(gids[0])
    assert seg.refresh().tombstones.size == 0
    assert seg.stats["docs_deleted"] == deleted
    assert seg.refresh().live_doc_ids().size == len(gids) - 1
    with pytest.raises(KeyError):
        seg.delete_document(len(gids))
