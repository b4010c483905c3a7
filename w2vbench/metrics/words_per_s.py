"""Corpus words of the batches the window completed (word2vec.c's count,
before subsampling) over the window's seconds, the clock ending in
``torch.cuda.synchronize()`` (host clock)."""


def read(rec):
    return rec["corpus_words"] / rec["window_s"]
