"""The port's async host pipeline (``repro_torch.data.prefetch``) against
the reference's synchronous one: bit-identical streams (tokens, negatives,
lengths, tile plans and vocab-sharding exchange plans) at T=1, at T=4 and
with a placement, for thread workers 1 and 3 and process workers 2; the
``skip_batches`` suffix; the backpressure bound; clean shutdown; worker
failures; pool healing; a dead producer. Waits use events and bounded
polls, never a sleep that assumes a schedule; every join, queue get and
subprocess has its own timeout."""
import queue as queue_mod
import time

import numpy as np
import pytest

import repro.data.batching as ref_batching
from repro.configs.w2v import smoke as ref_smoke
from repro.distributed import vocab_placement as ref_vp
from repro_torch.configs.w2v import smoke
from repro_torch.data import prefetch as prefetch_mod
from repro_torch.data.batching import BatchingPipeline
from repro_torch.data.corpus import synthetic_zipf_corpus
from repro_torch.data.prefetch import (AsyncBatchingPipeline, PipelineFault,
                                       make_pipeline)
from repro_torch.distributed import vocab_placement as vp

JOIN_S = 30.0

CASES = {"T1": dict(), "T4": dict(tile_windows=4),
         "exchange": dict(tile_windows=4, vocab_shard=True)}


def _corpus(n=400):
    return synthetic_zipf_corpus(vocab_size=300, n_sentences=n, mean_len=12,
                                 seed=0)


def _kw(case):
    return dict(sentences_per_batch=64, max_sentence_len=32, **CASES[case])


def _reference_stream(corpus, case, epoch=0):
    """The reference's synchronous stream, with a 2-shard placement when
    the case shards the vocabulary (the plan covers any shard count)."""
    refp = ref_batching.BatchingPipeline(corpus, ref_smoke(**_kw(case)))
    if CASES[case].get("vocab_shard"):
        refp.placement = ref_vp.VocabPlacement.plan(refp.vocab.counts, 2,
                                                    hot_frac=0.2)
    return list(refp.batches(pad_len=32, epoch=epoch))


def _async(corpus, case, workers, mode="thread", depth=2):
    cfg = smoke(**_kw(case))
    pipe = AsyncBatchingPipeline(corpus, cfg, workers=workers, depth=depth,
                                 mode=mode)
    if CASES[case].get("vocab_shard"):
        pipe.placement = vp.VocabPlacement.plan(pipe.vocab.counts, 2,
                                                hot_frac=0.2)
    return pipe


_EXCHANGE = ("tokens", "negs", "lengths", "cold_ids", "bucket_ids",
             "bucket_pos", "plan_uniq", "plan_scatter", "plan_ucount",
             "plan_strict")


def _same_stream(got, want):
    assert len(got) == len(want) >= 3
    for a, b in zip(got, want):
        assert (a.epoch, a.index, a.n_words) == (b.epoch, b.index, b.n_words)
        for f in ("tokens", "negs", "lengths"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert (a.plan is None) == (b.plan is None)
        if a.plan is not None:
            for f in ("uniq", "scatter", "ucount", "strict"):
                assert np.array_equal(getattr(a.plan, f),
                                      getattr(b.plan, f)), f
        assert (a.exchange is None) == (b.exchange is None)
        if a.exchange is not None:
            assert a.exchange.placement.to_extra() == \
                b.exchange.placement.to_extra()
            assert a.exchange.n_distinct == b.exchange.n_distinct
            for f in _EXCHANGE:
                x, y = getattr(a.exchange, f), getattr(b.exchange, f)
                assert np.array_equal(x, y), f


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_thread_stream_bit_identical_to_reference_sync(case, workers):
    corpus = _corpus()
    got = list(_async(corpus, case, workers).batches(pad_len=32, epoch=0))
    _same_stream(got, _reference_stream(corpus, case))


_PROCESS_CODE = """
import numpy as np, sys
sys.path.insert(0, {tests!r})
import test_torch_prefetch as t

corpus = t._corpus()
pipe = t._async(corpus, {case!r}, 2, mode="process")
got = []
for i, b in enumerate(pipe.batches(pad_len=32, epoch=0)):
    got.append(b)
    if i == 0:
        seen = pipe._executor.submit(
            eval, "sorted(m for m in __import__('sys').modules "
                  "if m.split('.')[0] in ('torch', 'jax', 'repro'))"
        ).result(timeout=60)
        print("WORKER_MODULES", seen)
        if {kill!r}:
            import os, signal, time
            pid = pipe.worker_pids()[0]
            os.kill(pid, signal.SIGKILL)
            deadline = time.monotonic() + 60
            while pid in pipe.worker_pids():
                assert time.monotonic() < deadline, "worker never died"
                time.sleep(0.001)
t._same_stream(got, t._reference_stream(corpus, {case!r}))
print("HEALS", pipe.prefetch.heals)
print("PROCESS_OK")
"""


def _run_process_case(subproc, case, kill):
    import os
    tests = os.path.dirname(os.path.abspath(__file__))
    r = subproc(_PROCESS_CODE.format(tests=tests, case=case, kill=kill),
                timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "PROCESS_OK" in r.stdout, r.stdout
    # the worker's import path is torch-free (and never the reference)
    assert "WORKER_MODULES []" in r.stdout, r.stdout
    return int(r.stdout.split("HEALS")[1].split()[0])


@pytest.mark.parametrize("case", list(CASES))
def test_process_stream_bit_identical_to_reference_sync(subproc, case):
    """Two process workers (forked from a fork server, in a subprocess
    whose parent imports torch and the reference) emit the reference's
    synchronous stream bit for bit."""
    assert _run_process_case(subproc, case, kill=False) == 0


def test_killed_process_worker_heals_bit_identical(subproc):
    """SIGKILL a process worker after the first batch: the next submit
    finds the pool short of a worker, rebuilds it, and the stream stays
    the reference's bit for bit."""
    assert _run_process_case(subproc, "T4", kill=True) >= 1


def test_skip_batches_is_exact_suffix():
    corpus = _corpus()
    full = _reference_stream(corpus, "T4", epoch=3)
    part = list(_async(corpus, "T4", 2).batches(pad_len=32, epoch=3,
                                                skip_batches=2))
    assert len(part) == len(full) - 2
    _same_stream(part, full[2:])


def test_backpressure_bounds_in_flight_batches():
    """A consumer that holds its first batch: the producer fills the
    ``depth`` slots and stops there."""
    depth = 2
    pipe = _async(_corpus(800), "T1", 2, depth=depth)
    it = pipe.batches(pad_len=32, epoch=0)
    next(it)
    deadline = time.monotonic() + JOIN_S
    while pipe.prefetch.max_in_flight < depth:
        assert time.monotonic() < deadline, "producer never filled the slots"
        time.sleep(0.001)
    n = 1 + sum(1 for _ in it)
    assert n >= 6
    assert pipe.prefetch.max_in_flight == depth
    assert len(pipe.prefetch.depth_samples) == n
    assert 0.0 <= pipe.prefetch.mean_depth <= depth


def test_early_close_joins_producer():
    pipe = _async(_corpus(800), "T1", 2)
    it = pipe.batches(pad_len=32, epoch=0)
    next(it)
    next(it)
    it.close()
    pipe._producer.join(timeout=JOIN_S)
    assert not pipe._producer.is_alive()


def test_worker_exception_propagates_and_shuts_down(monkeypatch):
    real = prefetch_mod.finalize_packed

    def boom(packed, *args):
        if packed.index >= 2:
            raise RuntimeError("injected finalize failure")
        return real(packed, *args)

    monkeypatch.setattr(prefetch_mod, "finalize_packed", boom)
    pipe = _async(_corpus(), "T1", 2)
    with pytest.raises(RuntimeError, match="injected finalize failure"):
        list(pipe.batches(pad_len=32, epoch=0))
    pipe._producer.join(timeout=JOIN_S)
    assert not pipe._producer.is_alive()
    # the pipeline is reusable after a failed epoch
    monkeypatch.setattr(prefetch_mod, "finalize_packed", real)
    assert len(list(pipe.batches(pad_len=32, epoch=0))) >= 3


def test_dead_producer_surfaces_as_pipeline_fault(monkeypatch):
    """A producer that dies without its end-of-epoch sentinel surfaces as
    a PipelineFault within the consumer's bounded poll, never a hang."""

    class SentinelEatingQueue(queue_mod.Queue):
        def put(self, item, *a, **kw):
            if isinstance(item, prefetch_mod._EndOfEpoch):
                return
            super().put(item, *a, **kw)

    monkeypatch.setattr(prefetch_mod.queue, "Queue", SentinelEatingQueue)
    pipe = _async(_corpus(), "T1", 2)
    with pytest.raises(PipelineFault, match="producer"):
        list(pipe.batches(pad_len=32, epoch=0))
    pipe._producer.join(timeout=JOIN_S)
    assert not pipe._producer.is_alive()


def test_stats_clock_is_wall_based_steady_state():
    """``BatchingStats`` means the same in both pipelines: ``seconds`` is
    the taken batches' produce and finalize busy seconds, summed from
    their counters (never the consumer's wall time, which here includes a
    stall in the consumer), and the words are the batches' words, equal
    to the synchronous pipeline's."""
    pipe = _async(_corpus(), "T1", 2)
    batches = []
    for b in pipe.batches(pad_len=32, epoch=0):
        batches.append(b)
        time.sleep(0.02)                       # the consumer's own time
    assert batches
    busy = [b.counters.produce_seconds + b.counters.finalize_seconds
            for b in batches]
    assert all(t > 0 for t in busy)
    assert pipe.stats.seconds == pytest.approx(sum(busy), rel=1e-12)
    assert pipe.stats.words == sum(b.n_words for b in batches)
    assert np.isfinite(pipe.stats.words_per_sec)
    sync = BatchingPipeline(_corpus(), smoke(**_kw("T1")))
    want = list(sync.batches(pad_len=32, epoch=0))
    assert sync.stats.seconds == pytest.approx(
        sum(b.counters.produce_seconds + b.counters.finalize_seconds
            for b in want), rel=1e-12)
    assert pipe.stats.words == sync.stats.words


def test_process_pool_that_cannot_start_raises():
    """No quiet fallback to threads or to the synchronous pipeline: a pool
    whose workers cannot be started (here: initializer arguments that do
    not pickle) raises PipelineFault from the first ``next``."""
    pipe = _async(_corpus(), "T1", 2, mode="process")
    pipe.placement = lambda: None
    with pytest.raises(PipelineFault, match="could not start"):
        next(pipe.batches(pad_len=32, epoch=0))


def test_pool_parts_fail_loudly_without_the_pools_internals():
    """A heal tears a process pool down through two private parts of
    ``ProcessPoolExecutor`` (its worker map and the parent's end of its
    result pipe): a thread pool has none, a shut-down pool none left, and
    a pool that lacks them raises rather than heal without killing its
    workers."""
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    with ThreadPoolExecutor(1) as ex:
        assert prefetch_mod._pool_parts(ex) == ({}, None)
    ex = ProcessPoolExecutor(1)
    procs, writer = prefetch_mod._pool_parts(ex)
    assert procs == {} and not writer.closed
    ex.shutdown(wait=True)
    assert prefetch_mod._pool_parts(ex) == ({}, None)
    ex = ProcessPoolExecutor(1)
    try:
        real = ex._result_queue
        del ex._result_queue
        with pytest.raises(RuntimeError, match="lacks what a pool heal"):
            prefetch_mod._pool_parts(ex)
    finally:
        ex._result_queue = real
        ex.shutdown(wait=True)


def test_make_pipeline_selects_by_config():
    corpus = _corpus()
    assert type(make_pipeline(corpus, smoke())) is BatchingPipeline
    apipe = make_pipeline(corpus, smoke(prefetch_workers=3, prefetch_depth=5,
                                        prefetch_mode="process"))
    assert isinstance(apipe, AsyncBatchingPipeline)
    assert (apipe.workers, apipe.depth, apipe.mode) == (3, 5, "process")
    with pytest.raises(ValueError, match="prefetch_mode"):
        AsyncBatchingPipeline(corpus, smoke(), mode="fork")
