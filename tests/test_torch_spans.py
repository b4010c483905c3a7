"""The port's span and counter recorder (``repro_torch.spans``) in the step
loop and the batching pipeline, on the CPU: nothing recorded and no
profiler range entered without a profiler, a span site's cost then one
flag read; under ``torch.profiler`` the step loop's spans in the
profiler's own events on the same clock, ``fetch_seconds`` equal to the
``w2v.fetch`` span and its children inside it; the per-batch counters
the same in the synchronous, thread and process pipelines, and the
draws unchanged by counting them."""
import json

import numpy as np
import pytest
import torch

from repro_torch import spans as spans_mod
from repro_torch.configs.w2v import smoke
from repro_torch.core.trainer import TrainSession
from repro_torch.data.batching import BatchingPipeline
from repro_torch.data.corpus import synthetic_zipf_corpus
from repro_torch.data.negatives import DrawTally, NegativeSampler
from repro_torch.data.prefetch import AsyncBatchingPipeline

# spans entered on the thread that runs the profiler
MAIN = ("w2v.fetch", "w2v.pipeline.wait", "w2v.lift.copy", "w2v.launch",
        "w2v.epoch.open", "w2v.epoch.close")
# spans kept by the recorder alone (other threads, or timed elsewhere)
OTHER = ("w2v.backpressure", "w2v.produce", "w2v.finalize",
         "w2v.negatives")
COUNTS = ("draw_rounds", "slots_drawn", "real_slots")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n_sentences=160):
    return synthetic_zipf_corpus(vocab_size=300, n_sentences=n_sentences,
                                 mean_len=12, seed=0)


def _cfg(**kw):
    return smoke(dim=16, sentences_per_batch=48, max_sentence_len=32,
             prefetch_workers=2, prefetch_depth=2, **kw)


def _session(workers=2):
    cfg = _cfg()
    pipe = (AsyncBatchingPipeline(_corpus(), cfg, workers=workers)
            if workers else BatchingPipeline(_corpus(), cfg))
    return TrainSession(pipe, cfg, device="cpu")


def test_without_a_profiler_nothing_is_recorded(monkeypatch):
    entered = []

    class Range:
        def __init__(self, name):
            entered.append(name)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Range)
    monkeypatch.setattr(torch.profiler, "record_function", Range)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Range)
    before = spans_mod.process_totals()
    sess = _session()
    ms = list(sess.stream(max_batches=4))
    assert len(ms) == 4
    assert entered == []
    assert sess.spans.spans == [] and sess.spans.counters == {}
    assert sess.pipeline.spans is sess.spans
    assert spans_mod.process_totals() == before
    # the always-on counters still count
    assert sess.pipeline.stats.words == sum(m.batch_words for m in ms)
    assert all(m.pipeline_wait_seconds <= m.fetch_seconds for m in ms)


def test_a_span_site_costs_one_flag_read(monkeypatch):
    reads = []

    class Profiler:
        @property
        def _is_profiler_enabled(self):
            reads.append(1)
            return False

    def no_clock():
        raise AssertionError("a span site read the clock")

    rec = spans_mod.SpanRecorder()
    monkeypatch.setattr(spans_mod, "_profiler", Profiler())
    with monkeypatch.context() as m:
        m.setattr(spans_mod.time, "time_ns", no_clock)
        assert rec.begin("w2v.fetch") is None
        assert len(reads) == 1
        with rec.span("w2v.launch"):
            pass
        assert len(reads) == 2
        rec.end(None)
        assert len(reads) == 2
    assert rec.spans == [] and rec.counters == {}


def _profile(workers):
    """A session streamed over one epoch under ``torch.profiler``:
    ``(session, metrics, {name: [(start_ns, end_ns)]} of the profiler's
    w2v.* events)``. A range entered first pays the profiler's own
    start-up, so one is entered before the stream."""
    sess = _session(workers)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("warm-up"):
            pass
        ms = list(sess.stream(epochs=1))
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("w2v."):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    kept = {}
    for s in sess.spans.spans:
        kept.setdefault(s.name, []).append(s)
    return sess, ms, events, kept


def test_threads_record_into_one_recorder(monkeypatch):
    """Recording threads switching every microsecond: no span or count
    is lost, in the recorder nor in the process totals, and each
    thread's spans nest under its own."""
    import sys
    import threading

    class Profiler:
        _is_profiler_enabled = True

    monkeypatch.setattr(spans_mod, "_profiler", Profiler())
    rec = spans_mod.SpanRecorder()
    before = spans_mod.process_totals()
    n_threads, n_spans = 4, 100

    def work():
        for _ in range(n_spans):
            with rec.span("t.outer") as outer:
                inner = rec.begin("t.inner")
                rec.end(inner)
                assert inner.parent is outer
            rec.count("t.count", 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    want = n_threads * n_spans
    got = rec.totals()
    assert got["spans"]["t.outer"]["count"] == want
    assert got["spans"]["t.inner"]["count"] == want
    assert got["counters"]["t.count"] == want
    after = spans_mod.process_totals()
    for name in ("t.outer", "t.inner"):
        was = before["spans"].get(name, {"count": 0})["count"]
        assert after["spans"][name]["count"] - was == want
    assert (after["counters"]["t.count"]
            - before["counters"].get("t.count", 0)) == want


@pytest.fixture(scope="module")
def profiled_sync():
    return _profile(0)


@pytest.fixture(scope="module")
def profiled_async():
    return _profile(2)


def test_main_thread_spans_reach_the_profiler(profiled_sync):
    """The step loop's spans are the profiler's ranges of the same name,
    start and end within 1 ms. The synchronous pipeline runs no other
    Python thread: with prefetch threads the step loop can wait for the
    GIL between its clock read and the profiler's own."""
    sess, ms, events, kept = profiled_sync
    names = ("w2v.fetch", "w2v.pipeline.wait", "w2v.lift.copy",
             "w2v.launch", "w2v.produce", "w2v.finalize", "w2v.negatives")
    assert set(kept) == set(names)
    for name in names[:4]:
        marks = events[name]
        for s in kept[name]:
            a, b = min(marks, key=lambda m: abs(m[0] - s.start_ns))
            assert abs(a - s.start_ns) < 1e6 and abs(b - s.end_ns) < 1e6, \
                (name, a - s.start_ns, b - s.end_ns)
    # produce and finalize ran in the step loop's thread, outside any
    # profiler range of their own: timed on the batch, kept here only
    assert not set(names[4:]) & set(events)
    assert len(kept["w2v.fetch"]) == len(ms) == len(kept["w2v.launch"])


def test_prefetch_spans_nest_by_thread(profiled_async):
    sess, ms, events, kept = profiled_async
    assert set(MAIN) | set(OTHER) == set(kept)
    assert set(MAIN) <= set(events)
    assert not set(OTHER) & set(events)      # torch.profiler: one thread
    assert len(kept["w2v.fetch"]) == len(ms) == len(kept["w2v.launch"])
    # the epoch's last take: a pipeline wait (closing the pool), no fetch
    assert len(kept["w2v.pipeline.wait"]) == len(ms) + 1
    for name in ("w2v.epoch.open", "w2v.epoch.close"):
        assert len(kept[name]) == 1
        assert all(s.parent.name == "w2v.pipeline.wait" for s in kept[name])
    main = {s.thread for s in kept["w2v.fetch"]}
    assert len(main) == 1
    assert {s.thread for s in kept["w2v.backpressure"]}.isdisjoint(main)
    assert {s.thread for s in kept["w2v.finalize"]}.isdisjoint(main)
    for s in kept["w2v.produce"] + kept["w2v.finalize"]:
        assert s.key is not None and s.end_ns >= s.start_ns > 0
    for s in kept["w2v.negatives"]:
        assert s.parent.name == "w2v.finalize" and s.parent.key == s.key
    counters = sess.spans.totals()["counters"]
    cfg = sess.cfg
    assert counters["w2v.positions.real"] == sess.pipeline.stats.words
    assert counters["w2v.positions.padded"] == len(ms) * (
        cfg.sentences_per_batch * cfg.max_sentence_len)
    assert counters["w2v.draw.slots"] >= counters["w2v.draw.real_slots"] > 0
    assert counters["w2v.draw.rounds"] >= len(ms)


@pytest.mark.parametrize("which", ["sync", "async"])
def test_fetch_seconds_is_the_fetch_span(which, request):
    sess, ms, _, kept = request.getfixturevalue(f"profiled_{which}")
    fetches = sorted(kept["w2v.fetch"], key=lambda s: s.start_ns)
    assert len(fetches) == len(ms)
    for m, f in zip(ms, fetches):
        assert m.fetch_seconds == f.seconds
        children = [s for s in sess.spans.spans if s.parent is f]
        assert {s.name for s in children} == {"w2v.pipeline.wait",
                                              "w2v.lift.copy"}
        assert all(s.key == f.key for s in children)
        assert sum(s.seconds for s in children) <= m.fetch_seconds
        wait, = [s for s in children if s.name == "w2v.pipeline.wait"]
        assert m.pipeline_wait_seconds == wait.seconds
    total = sess.spans.totals()["spans"]
    assert total["w2v.fetch"]["seconds"] == pytest.approx(
        sum(m.fetch_seconds for m in ms))


def _counts(batches):
    return [[b.index] + [getattr(b.counters, f) for f in COUNTS]
            for b in batches]


@pytest.mark.parametrize("tile", [1, 4])
def test_counters_the_same_in_every_pipeline(tile):
    cfg = _cfg(tile_windows=tile)
    sync = list(BatchingPipeline(_corpus(), cfg).batches(epoch=1))
    thread = list(AsyncBatchingPipeline(_corpus(), cfg, workers=3)
                  .batches(epoch=1))
    assert _counts(sync) == _counts(thread)
    for b in sync:
        c = b.counters
        S, L, N = b.negs.shape
        rows = int((b.lengths > 0).sum())     # the last batch's rows are
        per_round = rows * -(-L // tile) * N  # drawn before its padding
        assert c.slots_drawn == c.draw_rounds * per_round > 0
        sets = (b.lengths if tile == 1 else -(-b.lengths // tile)).sum()
        assert c.real_slots == int(sets) * N
        assert c.produce_seconds > 0 and c.finalize_seconds > 0


_PROCESS_CODE = """
import json
from repro_torch.configs.w2v import smoke
from repro_torch.data.corpus import synthetic_zipf_corpus
from repro_torch.data.prefetch import AsyncBatchingPipeline

corpus = synthetic_zipf_corpus(vocab_size=300, n_sentences={n},
                               mean_len=12, seed=0)
cfg = smoke(dim=16, sentences_per_batch=48, max_sentence_len=32,
            prefetch_workers=2, prefetch_depth=2)
pipe = AsyncBatchingPipeline(corpus, cfg, workers=1, mode="process")
print("COUNTS", json.dumps([[b.index] + [getattr(b.counters, f)
                                         for f in {counts!r}]
                            for b in pipe.batches(epoch=1)]))
"""


def test_counters_the_same_from_process_workers(subproc):
    """One worker process, on a corpus of two batches, in a process that
    imports no torch."""
    n = 60
    r = subproc(_PROCESS_CODE.format(n=n, counts=COUNTS), timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(r.stdout.split("COUNTS", 1)[1])
    want = _counts(BatchingPipeline(_corpus(n), _cfg()).batches(epoch=1))
    assert got == want and len(want) == 2


def test_counting_leaves_the_draws_alone():
    """Draw rounds and slots are counted on a vocabulary so small that
    the redraws cannot converge and the deterministic fill runs after
    the last round; the negatives are those drawn with no tally."""
    sampler = NegativeSampler(np.arange(1, 7, dtype=np.float64))
    targets = np.random.default_rng(1).integers(0, 6, size=(4, 9))
    tally = DrawTally()
    got = sampler.sample_batch(targets, 5, rng=np.random.default_rng(2),
                               tally=tally)
    want = sampler.sample_batch(targets, 5, rng=np.random.default_rng(2))
    assert np.array_equal(got, want)
    assert tally.draw_rounds == 17 and tally.slots_drawn == 17 * got.size
