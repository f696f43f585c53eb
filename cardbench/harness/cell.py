"""One run of one cell: set-up, the window, the judge, the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``: a configuration in the file its
entry names, a mix in ``<bench>/traffic/<name>.json``, a metric's reader
in ``<bench>/metrics/<name>.py`` (a function ``read(run)`` that returns a
number, or None where the run holds nothing for it to read).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from harness import judge as judging
from harness import sut, traffic
from harness.corpus import generate_corpus
from harness.devtrace import Slice
from harness.window import Window, closed_loop, serve_prefix

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PER_ROUTE_SAMPLE = 64
TRACE_SECONDS = 3.0


class NoDevice(RuntimeError):
    """The cell asks for cards this machine does not have."""


@dataclass
class RunRecord:
    """What the metric readers read."""

    cell: dict
    config: dict
    traffic: dict
    platform: str
    setup_s: float
    window: Window
    counters: dict  # program counters over the window (less a traced slice)
    trace: dict | None = None
    launches: list = field(default_factory=list)

    @property
    def top_k(self) -> int:
        return int(self.config["serve"].get("top_k", 16))

    @property
    def max_batch(self) -> int:
        return int(self.config["serve"].get("max_batch", 64))


class Bench:
    """A checkout's benchmark: ``BENCHMARK.json`` at ``root``, its files
    under the first of its ``paths``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.spec["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return traffic.load(self.dir / "traffic" / f"{name}.json")

    def metrics(self, cell: str, per_layer: bool) -> list[dict]:
        entries = self.spec["per_layer" if per_layer else "end_to_end"]
        return [m for m in entries if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"cardbench_metric_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def seeds(seed: int) -> tuple[int, int, int]:
    """(corpus, stream, sample) seeds drawn from the run's seed: the
    configuration's corpus, the mix's stream of queries, and the judge's
    sample."""
    return tuple(int(x) for x in np.random.SeedSequence(int(seed)).generate_state(3))


def inputs(config: dict, mix: dict, seed: int):
    """The corpus (the configuration's) and the mix's stream of queries,
    both made from the run's seed."""
    corpus_seed, stream_seed, _ = seeds(seed)
    corpus = generate_corpus(config["n_docs"], config["mean_doc_len"], config["vocab_size"],
                             config["alpha"], corpus_seed)
    corpus.sw_count, corpus.fu_count = int(config["sw_count"]), int(config["fu_count"])
    return corpus, traffic.Stream(corpus, mix, stream_seed)


def _device_check(platform: str, chips: int) -> None:
    if platform != "cuda":
        return
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA device(s); "
                       f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")


def forbidden_modules() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, platform: str = "cuda", fault=None,
        log=lambda line: None) -> dict:
    """One run; returns the result line's object. ``platform="cpu"`` drives
    the port's CPU paths (a rehearsal: no device metric is written);
    ``fault(service)`` breaks the timed path after set-up (tests)."""
    bench = Bench(root)
    cell = bench.cell(workload)
    _device_check(platform, int(cell["chips"]))
    config = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    t = time.perf_counter()
    corpus, stream = inputs(config, mix, seed)
    t_data = time.perf_counter() - t
    t = time.perf_counter()
    index = sut.build_index(corpus, int(config["max_distance"]))
    t_index = time.perf_counter() - t
    t = time.perf_counter()
    service = sut.make_service(index, config["serve"], platform)
    steps = sut.warm(service, stream.queries)
    t_warm = time.perf_counter() - t
    t = time.perf_counter()
    prefix = serve_prefix(service, stream, int(mix["clients"]), float(mix["deadline_s"]),
                          int(mix.get("served_in_setup", 0)))
    t_prefix = time.perf_counter() - t
    # what set-up leaves (the index, the stream) is never garbage: keep
    # the window's collections from walking it, as a server does after start
    gc.collect()
    gc.freeze()
    log(f"setup: corpus {corpus.n_docs} docs / {corpus.n_tokens} tokens and {len(stream.queries)} "
        f"queries {t_data:.2f} s, index {t_index:.2f} s, warm-up of {steps} steps {t_warm:.2f} s, "
        f"{prefix} queries of the stream served {t_prefix:.2f} s")
    if fault is not None:
        fault(service)

    slice_ = Slice(root / "build" / "cardbench" / "trace.json") if trace and platform == "cuda" else None
    launches: list = []
    marks: dict = {}

    def on_turn(elapsed: float) -> bool:
        if slice_ is not None and "mid" not in marks and elapsed >= seconds - trace_s:
            marks["mid"] = sut.counters(service)
            marks["annotated"] = sut.annotated(service, launches)
            marks["annotated"].__enter__()
            slice_.start()
            return True
        return False

    trace_s = min(TRACE_SECONDS, seconds / 2)
    before = sut.counters(service)
    setup_s = time.time() - t_start
    window = closed_loop(service, stream, int(mix["clients"]), float(mix["deadline_s"]), seconds,
                         np.random.default_rng(seeds(seed)[2]), PER_ROUTE_SAMPLE, on_turn)
    summary = None
    if "mid" in marks:
        summary = slice_.stop()
        marks["annotated"].__exit__(None, None, None)
    after = sut.counters(service)
    counters = sut.delta(marks.get("mid", after), before)
    memory_peak = 0
    if platform == "cuda":
        import torch

        memory_peak = int(torch.cuda.max_memory_allocated())
    window_delta = sut.delta(after, before)
    log(f"window: {window.window_s:.4f} s, {window.drains} drains of {mix['clients']} clients, "
        f"{window.completed} answered of {window.attempted} ({stream.blocks} block(s) of the "
        f"stream drawn), deadline {mix['deadline_s']} s met by "
        f"{window.deadline_met / max(window.completed, 1):.4f}; answers a second by quarter "
        + " ".join(f"{r:.1f}" for r in window.quarter_rates()))
    log("routes: " + json.dumps({k[6:]: int(v) for k, v in sorted(window_delta.items())
                                  if k.startswith("route.") and v}))
    log(f"device memory peak: {memory_peak} bytes")

    gc.unfreeze()
    del service, index
    gc.collect()
    if platform == "cuda":
        import torch

        torch.cuda.empty_cache()

    from reference.search import Reference

    t = time.perf_counter()
    ref = Reference(corpus.doc_ids, corpus.positions, corpus.lemma_ids, corpus.doc_lengths,
                    corpus.doc_freqs, max_distance=int(config["max_distance"]),
                    sw_count=corpus.sw_count, fu_count=corpus.fu_count)
    verdict = judging.judge(ref, window.samples, int(config["serve"].get("top_k", 16)),
                            window.unanswered)
    log(f"reference: {sum(verdict['compared'].values())} answers compared "
        f"{json.dumps(verdict['compared'])} in {time.perf_counter() - t:.2f} s")
    if verdict["first_mismatch"] is not None:
        log("first mismatch: " + json.dumps(verdict["first_mismatch"]))

    record = RunRecord(cell=cell, config=config, traffic=mix, platform=platform, setup_s=setup_s,
                       window=window, counters=counters, trace=summary, launches=launches)
    metrics = {}
    for m in bench.metrics(workload, per_layer=trace):
        if platform != "cuda" and m["source"] == "device_trace":
            continue
        value = bench.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device = {"platform": "gpu" if platform == "cuda" else platform,
              "kind": _device_name(platform), "count": int(cell["chips"]) if platform == "cuda" else 0,
              "memory_peak_bytes": memory_peak}
    result = {"correct": judging.passed(verdict), "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics, "device": device}
    if summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": judging.LIMITS[k]}
                        for k, v in verdict["numbers"].items()}
    return result


def _device_name(platform: str) -> str:
    if platform != "cuda":
        return platform
    import torch

    return torch.cuda.get_device_name(0)
