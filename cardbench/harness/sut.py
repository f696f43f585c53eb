"""The system under test: the port's index, its ``SearchService`` and the
counters the per-layer metrics read. The only module of the benchmark that
imports the program (``repro_torch``)."""

from __future__ import annotations

from contextlib import contextmanager

from harness.corpus import Corpus


def build_index(corpus: Corpus, max_distance: int):
    """The program's own set-up: its token table, lexicon and index, built
    by ``core/index_builder.build_index`` from the benchmark's corpus."""
    from repro_torch.core.index_builder import build_index as port_build_index
    from repro_torch.core.lexicon import Lexicon
    from repro_torch.data.corpus import TokenTable

    table = TokenTable(corpus.doc_ids, corpus.positions, corpus.lemma_ids, corpus.doc_lengths)
    lex = Lexicon.from_rank_counts(counts=corpus.counts, doc_freqs=corpus.doc_freqs,
                                   n_docs=corpus.n_docs, sw_count=corpus.sw_count,
                                   fu_count=corpus.fu_count)
    return port_build_index(table, lex, max_distance=max_distance)


def make_service(index, serve: dict, device: str):
    """``SearchService(index, ServeConfig(**serve), device=device)``."""
    from repro_torch.serving import SearchService, ServeConfig

    knobs = dict(serve)
    if "buckets" in knobs:
        knobs["buckets"] = tuple(knobs["buckets"])
    return SearchService(index, ServeConfig(**knobs), device=device)


def warm(service, queries) -> int:
    """Every (step family, B, L) the traffic routes to, warmed at startup
    (the logic of the port's ``serving.load.warm_service``): one query of
    each compiled (family, L-bucket) group served at every B of the batch
    ladder. The groups come from the program's pure planner, so the
    service's plan memo holds only the queries served here. Returns the
    number of (kind, B, L) steps built."""
    from repro_torch.serving.planner import plan

    reps: dict[tuple, list] = {}
    for q in dict.fromkeys(tuple(q) for q in queries):
        p = plan(list(q), service.index, service.config)
        if p.is_compiled:
            reps.setdefault((p.step_family, p.bucket), list(q))
    mb = service.config.max_batch
    ladder, B = [], 1
    while B <= mb:
        ladder.append(B)
        B *= 2
    for q in reps.values():
        for B in ladder:
            for _ in range(B):
                service.submit(q)
            service.drain()
    return service.compiled.n_executables


def counters(service) -> dict:
    """The program's window-summable counters and sums, flat: requests by
    route, compiled batches, row-cache hits and misses, and the count and
    sum (us) of the warm ``serve.batch.*`` and ``serve.step.*`` histograms."""
    snap = service.stats_snapshot()
    out = {f"route.{r}": float(n) for r, n in snap["plans"]["routes"].items()}
    out["requests"] = float(snap["requests"])
    out["batches"] = float(snap["batches"])
    pack = snap.get("pack_cache") or {}
    out["pack.hits"] = float(pack.get("hits", 0))
    out["pack.misses"] = float(pack.get("misses", 0))
    for prefix in ("serve.batch.", "serve.step."):
        n = s = 0.0
        for name, h in service.metrics_snapshot(prefix).items():
            if name.endswith(".scalar"):  # one sample a scalar-route query, not a batch
                continue
            n += h["count"]
            s += h["sum"]
        out[prefix + "count"] = n
        out[prefix + "sum_us"] = s
    return out


def delta(after: dict, before: dict) -> dict:
    return {k: after.get(k, 0.0) - before.get(k, 0.0) for k in set(after) | set(before)}


@contextmanager
def annotated(service, launches: list):
    """While open, every span of the program's tracer is also a
    ``torch.profiler.record_function`` range named ``cardbench:<span>``
    (``:<kind>`` for spans that carry one, ``:<family>:B<B>:L<L>`` for a
    batch), and every launch of the window-join kernel appends
    ``(B, L, r_bytes)`` (anchor lanes, L-bucket, bytes of its multiplicity
    vectors) to ``launches``. The program is left as it
    was on exit."""
    import torch
    from repro_torch.kernels.nearest_r import ops

    tracer = service.tracer
    plain_span = tracer.span

    @contextmanager
    def span(name, cat="serve", **args):
        label = f"cardbench:{name}"
        if name == "batch":
            label += f":{args.get('family')}:B{args.get('B')}:L{args.get('bucket')}"
        elif "kind" in args:
            label += f":{args['kind']}"
        with torch.profiler.record_function(label):
            with plain_span(name, cat, **args) as live:
                yield live

    plain_launch = ops._window_join_cuda

    def launch(a_g, ns_g, ns_r, st_cnt, st_ext, st_r, **kw):
        B, L = a_g.shape
        r_bytes = ns_r.numel() * ns_r.element_size()
        if st_r is not None:
            r_bytes += st_r.numel() * st_r.element_size()
        launches.append((int(B), int(L), int(r_bytes)))
        return plain_launch(a_g, ns_g, ns_r, st_cnt, st_ext, st_r, **kw)

    tracer.span = span
    ops._window_join_cuda = launch
    try:
        yield
    finally:
        del tracer.span
        ops._window_join_cuda = plain_launch
