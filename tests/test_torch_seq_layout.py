"""The host side of the sequential kernels K1/K2 (``csrc/seq.cuh``): the
plain mirror of their shared-memory layout and of the choice of compiled
or runtime-shaped instantiation (``csrc/fullw2v.cu``'s ``seq_smem`` and
``seq_variant``; the card test ``test_seq_mirror_matches_the_library``
holds the two against each other), and ``init_state``'s device rule."""
import numpy as np
import pytest
import torch

from repro_torch.configs.w2v import W2VConfig, smoke
from repro_torch.core import trainer
from repro_torch.core.trainer import init_state
from repro_torch.kernels import fullw2v

H100_SMEM = 227 * 1024      # 232,448 bytes: what one block may opt into


def test_limit_is_the_h100_opt_in_limit():
    assert fullw2v.SMEM_LIMIT == H100_SMEM


@pytest.mark.parametrize("w_f,n_neg", fullw2v.SEQ_COMPILED)
def test_compiled_shapes_take_their_instantiation(w_f, n_neg):
    name = fullw2v.seq_instantiation(w_f, n_neg, 128, 64)
    assert name == f"wf{w_f}_n{n_neg}_d128"
    assert name in fullw2v.SEQ_INSTANTIATIONS
    # the same shape with unaligned tables takes the runtime body
    assert fullw2v.seq_instantiation(w_f, n_neg, 128, 64,
                                     aligned=False) == "runtime"


def test_main_shapes_compile_and_fit():
    """The trainer's shape (W=5 -> w_f=3, N=5, d=128) at chip_smoke's L=64
    and at the default config's L=1000 takes a compiled body and fits."""
    cfg = W2VConfig()
    assert (cfg.fixed_window, cfg.negatives, cfg.dim) == (3, 5, 128)
    for L in (64, cfg.resolved_pad_len):
        assert fullw2v.seq_instantiation(3, 5, 128, L) == "wf3_n5_d128"
        assert fullw2v.seq_smem_bytes(3, 5, 128, L)["total"] <= H100_SMEM


@pytest.mark.parametrize("w_f,n_neg,d", [(4, 7, 128), (3, 5, 96), (3, 5, 256),
                                         (1, 5, 128), (3, 4, 128),
                                         (2, 3, 32)])
def test_other_shapes_take_the_runtime_body(w_f, n_neg, d):
    assert fullw2v.seq_instantiation(w_f, n_neg, d, 64) == "runtime"


@pytest.mark.parametrize("w_f,n_neg,L", [(3, 5, 6000), (3, 30, 1024)])
def test_indices_read_in_place_when_staging_does_not_fit(w_f, n_neg, L):
    staged = fullw2v.seq_smem_bytes(w_f, n_neg, 128, L)
    assert staged["total"] > H100_SMEM
    assert fullw2v.seq_instantiation(w_f, n_neg, 128, L) == \
        "runtime_unstaged"
    in_place = fullw2v.seq_smem_bytes(w_f, n_neg, 128, L, staged=False)
    assert in_place["indices"] == 0 and in_place["total"] <= H100_SMEM


def test_layout_bytes_at_the_main_shape():
    """w_f=3, N=5, d=128, L=64: ring 8 rows, 2 x 6 output rows, g 36
    floats, the hazard mask's 4 words, two index buffers of
    pad4(64 + 320 + 1) = 388 ints."""
    got = fullw2v.seq_smem_bytes(3, 5, 128, 64)
    assert got == {"ring": 8 * 512, "out_rows": 12 * 512, "g": 36 * 4,
                   "flags": 16, "indices": 2 * 388 * 4,
                   "total": 20 * 512 + 36 * 4 + 16 + 2 * 388 * 4}
    # g pads to whole float4s; the ring always holds one row more than a
    # window spans (K2's prefetched leading row)
    assert fullw2v.seq_smem_bytes(1, 2, 128, 8)["g"] == 8 * 4
    assert fullw2v.seq_smem_bytes(5, 5, 128, 8)["ring"] == 12 * 512


def test_launch_counters_cover_every_instantiation():
    assert set(fullw2v.SEQ_LAUNCHES) == set(fullw2v.SEQ_INSTANTIATIONS)
    fullw2v.SEQ_LAUNCHES["runtime"] = 3
    fullw2v.LAUNCHES["cuda"] = 2
    fullw2v.reset_launch_counts()
    assert set(fullw2v.SEQ_LAUNCHES.values()) == {0}
    assert set(fullw2v.LAUNCHES.values()) == {0}


def test_init_state_without_device_raises_when_cuda_is_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(16, smoke(), 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(16, smoke(), 0, device="cuda")


def test_init_state_on_the_cpu_when_asked():
    """``device="cpu"`` gives the tables the CPU always got: U(-0.5/d,
    0.5/d) from a CPU generator seeded with ``seed``, and zeros."""
    cfg = smoke()
    st = init_state(40, cfg, 7, device="cpu")
    gen = torch.Generator().manual_seed(7)
    want = (torch.rand((40, cfg.dim), generator=gen,
                       dtype=torch.float32) - 0.5) / cfg.dim
    assert st.w_in.device.type == "cpu" and st.w_out.device.type == "cpu"
    assert torch.equal(st.w_in, want)
    assert torch.equal(st.w_out, torch.zeros_like(want))
    assert st.cold_in is None


def test_init_state_split_on_the_cpu_matches_the_full_tables():
    from repro_torch.distributed.vocab_placement import VocabPlacement

    cfg = smoke()
    counts = np.arange(40, 0, -1, dtype=np.int64)
    pl = VocabPlacement.plan(counts, 1, hot_frac=0.25)
    full = init_state(40, cfg, 3, device="cpu")
    st = init_state(40, cfg, 3, device="cpu", placement=pl)
    (hot_in, cold_in), (hot_out, cold_out) = (
        pl.split(t.numpy()) for t in (full.w_in, full.w_out))
    for got, want in ((st.w_in, hot_in), (st.cold_in, cold_in),
                      (st.w_out, hot_out), (st.cold_out, cold_out)):
        assert got.device.type == "cpu"
        assert np.array_equal(got.numpy(), want)


def test_session_passes_its_device_to_init_state(monkeypatch):
    seen = []
    real = trainer.init_state

    def spy(*args, **kw):
        seen.append(args[3] if len(args) > 3 else kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(trainer, "init_state", spy)
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.corpus import synthetic_cluster_corpus

    cfg = smoke(sentences_per_batch=8)
    corpus = synthetic_cluster_corpus(n_clusters=4, words_per_cluster=8,
                                      n_sentences=16, mean_len=6, seed=0)
    sess = trainer.TrainSession(BatchingPipeline(corpus, cfg), cfg,
                                device="cpu")
    assert [torch.device(d) for d in seen] == [torch.device("cpu")]
    assert sess.state.w_in.device.type == "cpu"
