"""Training on one card: ``TrainSession.stream`` over the configuration's
corpus, as a user's training run drives it.

Set-up builds the corpus and the read vocabulary from the seed, the
program's batching pipeline (``make_pipeline``: the prefetch pool of the
traffic mix) and one ``TrainSession``, and drives that session's stream
through the check steps: they load the kernel library and warm every
shape, and their batches and tables are kept for the check. The window
then takes further steps of the same stream until ``seconds`` have
passed, and closes with ``torch.cuda.synchronize()``. Once the window has
closed and the device's peak memory is read, the session is freed and the
reference (``reference/``) works the check steps out again from the
corpus and the seed.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np

from w2vbench import check, corpus, counts, faults, trace, wordcount
from w2vbench.reference import batching as ref_batching
from w2vbench.reference import init as ref_init
from w2vbench.reference import sgns as ref_sgns


def program_config(cfg: dict, traffic: dict, seed: int, variant: str = ""):
    """The program's ``W2VConfig`` for a configuration and traffic mix."""
    from repro_torch.configs.w2v import W2VConfig

    kw = dict(dim=cfg["dim"], window=cfg["window"],
              negatives=cfg["negatives"], lr=cfg["lr"],
              min_lr_frac=cfg["min_lr_frac"], epochs=cfg["epochs"],
              min_count=cfg["min_count"], subsample_t=cfg["subsample_t"],
              max_sentence_len=cfg["max_sentence_len"],
              sentences_per_batch=cfg["sentences_per_batch"],
              tile_windows=cfg["tile_windows"],
              prefetch_workers=traffic["prefetch_workers"],
              prefetch_depth=traffic["prefetch_depth"],
              prefetch_mode=traffic["prefetch_mode"], seed=int(seed))
    kw.update(faults.config_overrides(variant))
    return W2VConfig(**kw)


def read_vocab(cfg: dict):
    """The program's ``Vocab`` from the read vocabulary's counts: word
    ``i`` is id ``i``."""
    from repro_torch.data.vocab import Vocab

    c = corpus.vocab_counts(cfg)
    return Vocab(ids=dict(zip(range(len(c)), range(len(c)))), counts=c,
                 total=int(c.sum())), c


class BatchTap:
    """Sees every batch the session's stream takes, in order: keeps the
    first ``keep`` batches' arrays for the check and, when ``hold``, a
    reference to every batch's arrays, whose operations and bytes
    (``counts``) are worked out once the window has closed: nothing is
    computed, and no thread runs, while the window runs."""

    def __init__(self, pipeline, keep: int, hold: bool):
        self.kept: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self.held: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        real = pipeline.batches

        def tapped(*a, **kw):
            gen = real(*a, **kw)
            try:
                for b in gen:
                    arrays = (b.tokens, b.negs, b.lengths)
                    if len(self.kept) < keep:
                        self.kept.append(arrays)
                    if hold:
                        self.held.append(arrays)
                    yield b
            finally:
                gen.close()
        pipeline.batches = tapped


def window_counts(held, dims: dict) -> Tuple[float, float]:
    """``(flops, least seconds)`` of the window's batches."""
    flops = least = 0.0
    for tok, neg, lens in held:
        f = counts.sgns_flops(lens, dims["w_f"], dims["n_neg"], dims["dim"])
        b = counts.sgns_bytes(tok, neg, lens, dims["vocab"], dims["dim"])
        flops += f
        least += counts.least_seconds(f, b)
    return flops, least


def _host(t) -> np.ndarray:
    """A float32 host copy of a table (never a view of it)."""
    import torch

    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def reference_tables(cfg: dict, sentences, vocab_counts: np.ndarray,
                     seed: int, k: int):
    """``(w0, lr1, batches, ref1, ref_k, timing)``: the start tables, the
    first step's learning rate, the first ``k`` batches, the tables after
    the first and the ``k``-th step, worked out by the reference, and the
    seconds its batching and its updates took."""
    w_f = (cfg["window"] + 1) // 2
    S = cfg["sentences_per_batch"]
    pad = min(cfg["max_sentence_len"], 1024)
    t0 = time.perf_counter()
    bats = ref_batching.batches(
        sentences, vocab_counts, seed=seed, epoch=0, n_batches=k, rows=S,
        pad_len=pad, max_len=cfg["max_sentence_len"],
        subsample_t=cfg["subsample_t"], n_neg=cfg["negatives"])
    t_batches = time.perf_counter() - t0
    w_in0, w_out0 = ref_init.tables(cfg["vocab_size"], cfg["dim"], seed)
    w0 = {"w_in": w_in0, "w_out": w_out0}
    cur = {n: w.astype(np.float64) for n, w in w0.items()}
    epoch_words = int(vocab_counts.sum())
    words, lr1, ref1 = 0, None, None
    for i, (tok, neg, lens) in enumerate(bats):
        lr = ref_init.lr_at(cfg, words, epoch_words)
        lr1 = lr if i == 0 else lr1
        ref_sgns.batch_step(cur["w_in"], cur["w_out"], tok, neg, lens, lr,
                            w_f)
        words += int(lens.sum())
        if i == 0:
            ref1 = {n: w.copy() for n, w in cur.items()}
    timing = {"batches_s": t_batches,
              "sgns_s": time.perf_counter() - t0 - t_batches}
    return w0, lr1, bats, ref1, cur, timing


def judge(cfg: dict, sentences, vocab_counts, seed: int, k: int,
          kept, prog1: Dict[str, np.ndarray], prog_k: Dict[str, np.ndarray]
          ) -> Tuple[dict, dict]:
    """The training numbers of ``check.train_numbers`` plus
    ``batch_mismatch``, and their detail."""
    w0, lr1, bats, ref1, ref_k, timing = reference_tables(
        cfg, sentences, vocab_counts, seed, k)
    numbers = {"batch_mismatch": float(check.batch_mismatches(kept, bats))}
    more, detail = check.train_numbers(w0, lr1, prog1, ref1, prog_k, ref_k)
    numbers.update(more)
    detail["reference"] = timing
    return numbers, detail


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
        traced: bool, t_start: float, device: str = "cuda",
        variant: str = "") -> dict:
    """One run of a single-card training cell; returns the record."""
    import torch

    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.corpus import Corpus
    from repro_torch.data.prefetch import make_pipeline

    k = int(traffic["check_steps"])
    sentences, _ = corpus.generate(cfg, seed)
    vocab, vocab_counts = read_vocab(cfg)
    pcfg = program_config(cfg, traffic, seed, variant)
    pipe = make_pipeline(Corpus(sentences, cfg["vocab_size"]), pcfg, vocab)
    tap = BatchTap(pipe, keep=k, hold=traced)
    sess = TrainSession(pipe, pcfg, backend="auto", device=device)
    stream = sess.stream()
    per_epoch: Dict[int, int] = {}
    steps_at: List[Tuple[int, int]] = []

    def take():
        m = next(stream, None)
        if m is None:
            raise RuntimeError("the corpus ran out before the window closed; "
                               "raise the configuration's epochs")
        steps_at.append((m.epoch, per_epoch.get(m.epoch, 0)))
        per_epoch[m.epoch] = per_epoch.get(m.epoch, 0) + 1
        return m

    prog1 = prog_k = None
    for i in range(k):
        take()
        if i == 0 or i == k - 1:
            sess.synchronize()
            snap = {n: _host(t) for n, t in sess.state.params().items()}
            prog1 = snap if i == 0 else prog1
            prog_k = snap
    sess.synchronize()
    gc.collect()
    gc.freeze()          # set-up's objects live the whole run
    setup_s = time.time() - t_start

    words = steps = 0
    fetch_s = 0.0        # waits inside the window: steps 2.. of it
    ends = []
    with trace.Trace(traced) as tr:
        t0 = time.perf_counter()
        while True:
            m = take()
            steps += 1
            words += m.batch_words
            if steps > 1:
                fetch_s += m.fetch_seconds
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        sess.synchronize()
        window_s = time.perf_counter() - t0
    gc.unfreeze()
    stream.close()
    cuda = device != "cpu"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = trace.summarize(tr)
    backend = sess.backend
    del stream, sess, pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    if traced:
        flops, least_s = window_counts(
            tap.held[k:k + steps],
            dict(w_f=(cfg["window"] + 1) // 2, n_neg=cfg["negatives"],
                 dim=cfg["dim"], vocab=cfg["vocab_size"]))
        tap.held.clear()

    t_check = time.perf_counter()
    window_steps = steps_at[k:k + steps]
    corpus_words = wordcount.window_words(
        sentences, vocab_counts, window_steps, seed=seed,
        rows=cfg["sentences_per_batch"], max_len=cfg["max_sentence_len"],
        subsample_t=cfg["subsample_t"])
    numbers, detail = judge(cfg, sentences, vocab_counts, seed, k,
                            tap.kept, prog1, prog_k)
    rec = dict(setup_s=setup_s, window_s=window_s, steps=steps,
               attempted=steps, failed=0, trained_words=words,
               corpus_words=corpus_words, fetch_s=fetch_s, backend=backend,
               memory_peak_bytes=int(peak), numbers=numbers, detail=detail,
               trace=summary, check_s=time.perf_counter() - t_check,
               diag=dict(steps=steps, trained_words=words,
                         step_s=[round(b - a, 4) for a, b in
                                 zip([0.0] + ends, ends)],
                         corpus_words=corpus_words, fetch_s=fetch_s,
                         backend=backend, detail=detail))
    if traced:
        rec["flops"], rec["least_s"] = flops, least_s
    return rec
