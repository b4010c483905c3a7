"""Wrappers of the FULL-W2V CUDA kernels (sources in ``csrc/``).

The port's counterpart of ``repro.kernels.fullw2v``'s host entry points:

* :func:`fullw2v_cuda` — the sequential kernel (``pipeline=False``, backend
  ``cuda``, replacing ``_kernel``) or its prefetching form
  (``pipeline=True``, backend ``cuda_pipelined``, replacing
  ``_kernel_pipelined``); one body (``csrc/seq.cuh``), bit-identical to
  each other. The body is compiled for the shapes in :data:`SEQ_COMPILED`
  and once with runtime shapes for any other; :func:`seq_instantiation`
  says which a launch takes and :data:`SEQ_LAUNCHES` counts them.
* :func:`fullw2v_cuda_tiled` — the window-tiled kernel (backend
  ``cuda_tiled``, replacing ``_kernel_tiled``), driven by the host tile
  plan; bit-identical to the sequential kernel at T=1.
* :func:`fullw2v_cuda_tiled_fused` — the same tiled kernel on the split
  working table of a vocab-sharded step (K4, the ``update_fused`` of
  ``cuda_tiled``, replacing ``_kernel_tiled`` with ``hot_rows > 0`` as
  ``fullw2v_pallas_tiled_fused`` enters it); bit-identical to
  :func:`fullw2v_cuda_tiled` on ``concat(hot, got)``.

K3 and K4 are one body (``csrc/tiled.cuh``), compiled for the shapes in
:data:`TILED_COMPILED` and once with runtime shapes for any other;
:func:`tiled_instantiation` says which a launch takes and
:data:`TILED_LAUNCHES` counts them. Both prefetch the next tile's unique
rows as the reference's K4 does (:func:`prefetch_columns` counts the
columns on the host).

All update their tables **in place** (the reference donates its tables to
the same effect) and return them. They take tensors on one CUDA device,
launch the kernel on the current stream, and raise for anything else:
CPU tensors included, since the plain versions (``kernels.ref``) are
separate functions that the registry runs on the CPU (backends ``torch``
and ``torch_tiled``). Each launch adds one to its kernel's count in
:data:`LAUNCHES`.

PRECONDITION (as in the reference, guaranteed by
``repro_torch.data.negatives``): within one window the N negatives are
distinct from each other and from the target. With duplicates the kernels'
per-row write-back is last-write-wins while the plain version scatter-adds.
Token and negative ids must lie in ``[0, V)``; K1-K3 do not check, K4's
wrapper checks its working-table ids on the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.w2v import resolve_gemm_windows
from repro_torch.kernels import ref as _ref

# kernel launches per backend name; chip_smoke and the tests zero them
# before a run and read them after to prove the run went through the kernel
LAUNCHES: Dict[str, int] = {"cuda": 0, "cuda_pipelined": 0, "cuda_tiled": 0,
                            "cuda_tiled_fused": 0}

# K1/K2's instantiations, in the order of csrc/fullw2v.cu's seq_kernel_of:
# the compiled (w_f, N) shapes at d = SEQ_ROW_WIDTH, then the runtime-shaped
# body with the indices staged in shared memory and with them read in place
SEQ_COMPILED: Tuple[Tuple[int, int], ...] = ((2, 3), (2, 5), (3, 5), (5, 5))
SEQ_ROW_WIDTH = 128
SEQ_INSTANTIATIONS: Tuple[str, ...] = tuple(
    f"wf{w_f}_n{n}_d{SEQ_ROW_WIDTH}" for w_f, n in SEQ_COMPILED) + (
    "runtime", "runtime_unstaged")
# dynamic shared memory one block may opt into on an H100 (sm_90): 227 KB
SMEM_LIMIT = 232_448

# K1/K2 launches per instantiation (which body a run went through)
SEQ_LAUNCHES: Dict[str, int] = {name: 0 for name in SEQ_INSTANTIATIONS}

# K3/K4's instantiations, in the order of csrc/fullw2v.cu's tiled_kernel_of:
# the compiled (w_f, N, T, G) shapes at d = SEQ_ROW_WIDTH (the trainer's
# T=8 step, then T=1 at each K1/K2 shape), then the runtime-shaped body with
# the indices and tile plan staged in shared memory and read in place
TILED_COMPILED: Tuple[Tuple[int, int, int, int], ...] = (
    (3, 5, 8, 4), (2, 3, 1, 1), (2, 5, 1, 1), (3, 5, 1, 1), (5, 5, 1, 1))
TILED_INSTANTIATIONS: Tuple[str, ...] = tuple(
    f"wf{w_f}_n{n}_t{t}_g{g}_d{SEQ_ROW_WIDTH}"
    for w_f, n, t, g in TILED_COMPILED) + ("runtime", "runtime_unstaged")

# K3 and K4 launches per instantiation
TILED_LAUNCHES: Dict[str, int] = {name: 0 for name in TILED_INSTANTIATIONS}


def reset_launch_counts() -> None:
    """Zero every kernel's launch count and the per-instantiation counts."""
    for counts in (LAUNCHES, SEQ_LAUNCHES, TILED_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def seq_smem_bytes(w_f: int, n_neg: int, d: int, L: int,
                   staged: bool = True) -> dict:
    """K1/K2's dynamic shared memory in bytes, buffer by buffer (the
    mirror of ``seq_smem`` in ``csrc/fullw2v.cu``): the context ring of
    ``2*w_f + 2`` rows, two buffers of ``N+1`` output rows, ``g`` padded to a
    multiple of 4 floats, 4 words for the hazard mask and, when ``staged``,
    two buffers of one sentence's indices (tokens, negatives and length,
    padded to 4 ints)."""
    K, m = 2 * w_f, n_neg + 1
    out = {"ring": 4 * (K + 2) * d, "out_rows": 4 * 2 * m * d,
           "g": 4 * _pad4(K * m), "flags": 4 * 4,
           "indices": 4 * 2 * _pad4(L + L * n_neg + 1) if staged else 0}
    out["total"] = sum(out.values())
    return out


def seq_instantiation(w_f: int, n_neg: int, d: int, L: int,
                      aligned: bool = True, limit: int = SMEM_LIMIT) -> str:
    """The K1/K2 instantiation a launch takes (the mirror of
    ``seq_variant`` in ``csrc/fullw2v.cu``): the compiled shape when
    ``(w_f, n_neg)`` is in :data:`SEQ_COMPILED`, ``d`` is
    :data:`SEQ_ROW_WIDTH`, both tables are 16-byte aligned (``aligned``) and
    the staged layout fits in ``limit`` bytes; else the runtime-shaped body,
    with staged indices when they fit and read in place when not."""
    fits = seq_smem_bytes(w_f, n_neg, d, L)["total"] <= limit
    if d == SEQ_ROW_WIDTH and aligned and fits and \
            (w_f, n_neg) in SEQ_COMPILED:
        return SEQ_INSTANTIATIONS[SEQ_COMPILED.index((w_f, n_neg))]
    return "runtime" if fits else "runtime_unstaged"


def tiled_smem_bytes(w_f: int, n_neg: int, d: int, L: int, tile: int,
                     gemm_windows: int, staged: bool = True,
                     prefetch: bool = True) -> dict:
    """K3/K4's dynamic shared memory in bytes, buffer by buffer (the mirror
    of ``tiled_layout`` in ``csrc/tiled.cuh``): the context ring of
    ``2G + 2w_f`` rows, ``out_uniq`` of ``T(N+1)`` rows (two halves when
    ``prefetch``: tile i+1's rows stream into one while tile i uses the
    other), two buffers of a strict window's ``N+1`` rows, the runtime
    body's copy of a step's ``G + 2w_f`` context columns, ``g`` padded to 4
    floats, 8 flag words, one prefetch flag per tile column, the list of
    rows issued ahead (two ints a row, up to ``T(N+1) + G + N+1`` rows) and,
    when ``staged``, two buffers of one sentence's tokens, negatives,
    length and tile plan (``uniq``, ``scatter``, ``ucount``, ``strict``)."""
    G = resolve_gemm_windows(tile, gemm_windows)
    K, m = 2 * w_f, n_neg + 1
    MT, nt = tile * m, -(-L // tile)
    stage = _pad4(_pad4(L + L * n_neg + 1) + 2 * nt * MT + 2 * nt)
    out = {"ring": 4 * (2 * G + K) * d,
           "out_uniq": 4 * (2 if prefetch else 1) * MT * d,
           "out_rows": 4 * 2 * m * d, "columns": 4 * (G + K) * d,
           "g": 4 * _pad4(G * K * m), "flags": 4 * 8,
           "prefetch_flags": 4 * _pad4(MT),
           "copy_list": 4 * _pad4(2 * (MT + G + m)),
           "indices": 4 * 2 * stage if staged else 0}
    out["total"] = sum(out.values())
    return out


def tiled_choice(w_f: int, n_neg: int, d: int, L: int, tile: int,
                 gemm_windows: int = 0, aligned: bool = True,
                 prefetch: bool = True,
                 limit: int = SMEM_LIMIT) -> Tuple[str, bool]:
    """The K3/K4 instantiation a launch takes and whether it prefetches (the
    mirror of ``tiled_choice`` in ``csrc/fullw2v.cu``): the compiled shape
    when ``(w_f, n_neg, tile, G)`` is in :data:`TILED_COMPILED`, ``d`` is
    :data:`SEQ_ROW_WIDTH`, every table is 16-byte aligned and the staged
    layout fits in ``limit`` bytes; else the runtime-shaped body, staged
    when that fits and prefetching when the double-buffered ``out_uniq``
    fits too. ``prefetch=False`` turns the prefetch off."""
    G = resolve_gemm_windows(tile, gemm_windows)

    def fits(pf, staged):
        return tiled_smem_bytes(w_f, n_neg, d, L, tile, G, staged,
                                pf)["total"] <= limit

    if d == SEQ_ROW_WIDTH and aligned and fits(prefetch, True) and \
            (w_f, n_neg, tile, G) in TILED_COMPILED:
        return TILED_INSTANTIATIONS[TILED_COMPILED.index(
            (w_f, n_neg, tile, G))], prefetch
    for name, staged in (("runtime", True), ("runtime_unstaged", False)):
        for pf in (prefetch, False):
            if fits(pf, staged):
                return name, pf
    return "runtime_unstaged", False


def tiled_instantiation(w_f: int, n_neg: int, d: int, L: int, tile: int,
                        gemm_windows: int = 0, aligned: bool = True,
                        limit: int = SMEM_LIMIT) -> str:
    """The K3/K4 instantiation a launch takes (see :func:`tiled_choice`)."""
    return tiled_choice(w_f, n_neg, d, L, tile, gemm_windows, aligned,
                        limit=limit)[0]


def prefetch_columns(uniq: np.ndarray, ucount: np.ndarray,
                     strict: np.ndarray, lengths: np.ndarray,
                     tile: int) -> Tuple[int, int]:
    """(prefetched, rejected) columns of a batch's tile plan under the
    reference's ``was_prefetched`` (``fullw2v.py:617-636``): a column
    ``c < ucount`` of tile ``i >= 1`` inside the sentence, with tiles ``i``
    and ``i-1`` both fused, is prefetched during tile ``i-1`` unless its row
    is in tile ``i-1``'s write-back set (then it is rejected and loaded
    after that write-back). What the kernels count on the card."""
    S, nt, M = uniq.shape
    if nt < 2:
        return 0, 0
    cols = np.arange(M)
    taken = rejected = 0
    for s0 in range(0, S, 512):            # bounded memory at large S
        uq, uc = uniq[s0:s0 + 512], ucount[s0:s0 + 512]
        st, ln = strict[s0:s0 + 512], lengths[s0:s0 + 512]
        live = ((np.arange(1, nt)[None, :] * tile < ln[:, None])
                & (st[:, 1:] == 0) & (st[:, :-1] == 0))       # (S, nt-1)
        cur = cols[None, None, :] < uc[:, 1:, None]          # (S, nt-1, M)
        prev = cols[None, None, :] < uc[:, :-1, None]
        hit = ((uq[:, 1:, :, None] == uq[:, :-1, None, :])
               & prev[:, :, None, :]).any(-1)
        real = cur & live[:, :, None]
        rejected += int((real & hit).sum())
        taken += int((real & ~hit).sum())
    return taken, rejected


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_tables(*named) -> None:
    for name, t in named:
        _require(t.dtype == torch.float32 and t.dim() == 2,
                 f"{name} must be a 2-D float32 tensor, got {t.dtype} "
                 f"{tuple(t.shape)}")
        _require(t.is_contiguous(), f"{name} must be contiguous")


def _check_index(tokens, negs, lengths) -> Tuple[int, int, int]:
    """Validate the index arrays; return (S, L, N)."""
    _require(tokens.dim() == 2, f"tokens must be (S, L), got "
             f"{tuple(tokens.shape)}")
    S, L = tokens.shape
    _require(negs.dim() == 3 and tuple(negs.shape[:2]) == (S, L),
             f"negs must be (S, L, N) = ({S}, {L}, N), got "
             f"{tuple(negs.shape)}")
    _require(tuple(lengths.shape) == (S,),
             f"lengths must be ({S},), got {tuple(lengths.shape)}")
    for name, t in (("tokens", tokens), ("negs", negs), ("lengths", lengths)):
        _require(t.dtype == torch.int32, f"{name} must be int32, got "
                 f"{t.dtype}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    return S, L, negs.shape[2]


def _check_batch(w_in, w_out, tokens, negs, lengths) -> Tuple[int, ...]:
    """Validate the tables and index arrays; return (S, L, N, d)."""
    _check_tables(("w_in", w_in), ("w_out", w_out))
    _require(w_in.shape == w_out.shape,
             f"w_in {tuple(w_in.shape)} and w_out {tuple(w_out.shape)} "
             f"differ")
    return (*_check_index(tokens, negs, lengths), w_in.shape[1])


def _check_plan(S, L, N, tile, uniq, scatter, ucount, strict) -> None:
    _require(tile >= 1, f"tile must be >= 1, got {tile}")
    nt = -(-L // tile)
    M = tile * (N + 1)
    for name, t, shape in (("uniq", uniq, (S, nt, M)),
                           ("scatter", scatter, (S, nt, M)),
                           ("ucount", ucount, (S, nt)),
                           ("strict", strict, (S, nt))):
        _require(tuple(t.shape) == shape,
                 f"{name} must be {shape} for tile={tile}, got "
                 f"{tuple(t.shape)}")
        _require(t.dtype == torch.int32, f"{name} must be int32, got "
                 f"{t.dtype}")
        _require(t.is_contiguous(), f"{name} must be contiguous")


def _require_cuda(*tensors) -> None:
    """Every tensor must lie on one CUDA device; anything else raises. The
    kernels have no CPU mode, and a CPU tensor is not routed to the plain
    version: the registry runs the plain versions on the CPU."""
    devices = {t.device for t in tensors}
    _require(len(devices) == 1 and next(iter(devices)).type == "cuda",
             f"the CUDA kernels take tensors on one CUDA device, got "
             f"{sorted(map(str, devices))}; on the CPU run the plain "
             f"versions (repro_torch.kernels.ref, backends torch and "
             f"torch_tiled)")


def _raise_on_error(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: {lib.fullw2v_error_string(err).decode()}"
            f" (cudaError {err})")


def fullw2v_cuda(
    w_in: torch.Tensor,      # (V, d) f32, updated in place
    w_out: torch.Tensor,     # (V, d) f32, updated in place
    tokens: torch.Tensor,    # (S, L) int32
    negs: torch.Tensor,      # (S, L, N) int32
    lengths: torch.Tensor,   # (S,) int32
    lr,                      # float or 0-d tensor (read on the host)
    w_f: int,
    pipeline: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One FULL-W2V pass over a batch of sentences, in strict sentence and
    window order, updating ``w_in``/``w_out`` in place. ``pipeline``
    selects the prefetching kernel (same results, bit for bit). The launch
    counts in :data:`LAUNCHES` and, under the instantiation it took, in
    :data:`SEQ_LAUNCHES`."""
    S, L, N, d = _check_batch(w_in, w_out, tokens, negs, lengths)
    _require_cuda(w_in, w_out, tokens, negs, lengths)
    from repro_torch.kernels._build import load
    lib = load().lib
    name = "cuda_pipelined" if pipeline else "cuda"
    with torch.cuda.device(w_in.device):
        variant = lib.fullw2v_seq_variant(w_in.data_ptr(), w_out.data_ptr(),
                                          d, w_f, N, L)
        if variant < 0:
            raise RuntimeError(f"{name}: cannot query the device's shared "
                               f"memory limit")
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fullw2v_seq_launch(
            w_in.data_ptr(), w_out.data_ptr(), tokens.data_ptr(),
            negs.data_ptr(), lengths.data_ptr(), _ref.lr32(lr), S, L, N, d,
            w_f, int(pipeline), stream)
    _raise_on_error(lib, err, name)
    LAUNCHES[name] += 1
    SEQ_LAUNCHES[SEQ_INSTANTIATIONS[variant]] += 1
    return w_in, w_out


def fullw2v_cuda_tiled(
    w_in: torch.Tensor,      # (V, d) f32, updated in place
    w_out: torch.Tensor,     # (V, d) f32, updated in place
    tokens: torch.Tensor,    # (S, L) int32
    negs: torch.Tensor,      # (S, L, N) int32
    lengths: torch.Tensor,   # (S,) int32
    lr,                      # float or 0-d tensor (read on the host)
    w_f: int,
    tile: int,
    uniq: torch.Tensor,      # (S, nt, T*(N+1)) int32 — from plan_tiles
    scatter: torch.Tensor,   # (S, nt, T*(N+1)) int32
    ucount: torch.Tensor,    # (S, nt) int32
    strict: torch.Tensor,    # (S, nt) int32
    gemm_windows: int = 0,   # windows per GEMM group; 0 -> min(tile, 4)
    prefetch: bool = True,   # False: no cross-tile prefetch (same results)
    counters: Optional[torch.Tensor] = None,  # (2,) int64, += prefetched,
                                              # rejected columns
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window-tiled FULL-W2V pass (T windows per step, deltas applied in
    groups of G windows), updating ``w_in``/``w_out`` in place. The plan
    must come from ``repro_torch.data.batching.plan_tiles`` for the same
    batch. The launch counts in :data:`LAUNCHES` and, under the
    instantiation it took, in :data:`TILED_LAUNCHES`."""
    S, L, N, d = _check_batch(w_in, w_out, tokens, negs, lengths)
    _check_plan(S, L, N, tile, uniq, scatter, ucount, strict)
    G = resolve_gemm_windows(tile, gemm_windows)
    _require_cuda(w_in, w_out, tokens, negs, lengths, uniq, scatter, ucount,
                  strict, *_counter_list(counters))
    from repro_torch.kernels._build import load
    lib = load().lib
    with torch.cuda.device(w_in.device):
        name = _tiled_choice(lib, (w_in, w_out), d, w_f, N, L, tile, G,
                             prefetch, "cuda_tiled")
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fullw2v_tiled_launch(
            w_in.data_ptr(), w_out.data_ptr(), tokens.data_ptr(),
            negs.data_ptr(), lengths.data_ptr(), uniq.data_ptr(),
            scatter.data_ptr(), ucount.data_ptr(), strict.data_ptr(),
            _ref.lr32(lr), S, L, N, d, w_f, tile, G, int(prefetch),
            _counter_ptr(counters), stream)
    _raise_on_error(lib, err, "cuda_tiled")
    LAUNCHES["cuda_tiled"] += 1
    TILED_LAUNCHES[name] += 1
    return w_in, w_out


def _counter_list(counters):
    if counters is None:
        return []
    _require(counters.dtype == torch.int64 and tuple(counters.shape) == (2,)
             and counters.is_contiguous(),
             f"counters must be a contiguous (2,) int64 tensor, got "
             f"{counters.dtype} {tuple(counters.shape)}")
    return [counters]


def _counter_ptr(counters):
    return None if counters is None else counters.data_ptr()


def _tiled_choice(lib, tables, d, w_f, N, L, tile, G, prefetch,
                  name) -> str:
    """The K3/K4 instantiation the library takes for these tables."""
    ptrs = [t.data_ptr() for t in tables] + [None] * (4 - len(tables))
    got = lib.fullw2v_tiled_choice(*ptrs, d, w_f, N, L, tile, G,
                                   int(prefetch))
    if got < 0:
        raise RuntimeError(f"{name}: cannot query the device's shared "
                           f"memory limit")
    return TILED_INSTANTIATIONS[got >> 1]


def fullw2v_cuda_tiled_fused(
    hot_in: torch.Tensor,    # (hot, d) f32 — replicated hot head, in place
    hot_out: torch.Tensor,   # (hot, d) f32, in place
    got_in: torch.Tensor,    # (R, d) f32 — gathered cold block, in place
    got_out: torch.Tensor,   # (R, d) f32, in place
    tokens: torch.Tensor,    # (S, L) int32 — working-table ids (< hot + R)
    negs: torch.Tensor,      # (S, L, N) int32
    lengths: torch.Tensor,   # (S,) int32
    lr,                      # float or 0-d tensor (read on the host)
    w_f: int,
    tile: int,
    uniq: torch.Tensor,      # (S, nt, T*(N+1)) int32 — from plan_tiles
    scatter: torch.Tensor,   # (S, nt, T*(N+1)) int32
    ucount: torch.Tensor,    # (S, nt) int32
    strict: torch.Tensor,    # (S, nt) int32
    gemm_windows: int = 0,   # windows per GEMM group; 0 -> min(tile, 4)
    prefetch: bool = True,   # as in fullw2v_cuda_tiled
    counters: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The window-tiled pass on the split working table of a vocab-sharded
    step (K4): ids below ``hot`` address ``hot_*``, the rest ``got_*`` at
    ``id - hot``, so ``concat(hot, got)`` is never built. Same results,
    bit for bit, as :func:`fullw2v_cuda_tiled` on the concatenation.
    ``R`` may be 0 (an all-hot batch). Every token, negative and used plan
    id must lie in ``[0, hot + R)``; that is checked here, on the host."""
    _check_tables(("hot_in", hot_in), ("hot_out", hot_out),
                  ("got_in", got_in), ("got_out", got_out))
    _require(hot_in.shape == hot_out.shape,
             f"hot_in {tuple(hot_in.shape)} and hot_out "
             f"{tuple(hot_out.shape)} differ")
    _require(got_in.shape == got_out.shape,
             f"got_in {tuple(got_in.shape)} and got_out "
             f"{tuple(got_out.shape)} differ")
    hot, d = hot_in.shape
    _require(got_in.shape[1] == d,
             f"got_in has d={got_in.shape[1]}, the hot tables d={d}")
    _require(hot >= 1, "the hot head needs at least one row")
    S, L, N = _check_index(tokens, negs, lengths)
    _check_plan(S, L, N, tile, uniq, scatter, ucount, strict)
    G = resolve_gemm_windows(tile, gemm_windows)
    _require_cuda(hot_in, hot_out, got_in, got_out, tokens, negs, lengths,
                  uniq, scatter, ucount, strict, *_counter_list(counters))
    rows = hot + got_in.shape[0]
    # one host read for all three arrays (plan columns past ucount hold 0,
    # a hot row, so every entry can be checked)
    ends = torch.stack([torch.stack([t.min(), t.max()])
                        for t in (tokens, negs, uniq)])
    lo, hi = torch.stack([ends[:, 0].min(), ends[:, 1].max()]).tolist()
    _require(lo >= 0 and hi < rows,
             f"working-table ids must lie in [0, hot + R) = [0, {rows}), "
             f"got [{lo}, {hi}]")
    from repro_torch.kernels._build import load
    lib = load().lib
    with torch.cuda.device(hot_in.device):
        name = _tiled_choice(lib, (hot_in, hot_out, got_in, got_out), d, w_f,
                             N, L, tile, G, prefetch, "cuda_tiled_fused")
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fullw2v_tiled_fused_launch(
            hot_in.data_ptr(), hot_out.data_ptr(), got_in.data_ptr(),
            got_out.data_ptr(), hot, tokens.data_ptr(), negs.data_ptr(),
            lengths.data_ptr(), uniq.data_ptr(), scatter.data_ptr(),
            ucount.data_ptr(), strict.data_ptr(), _ref.lr32(lr), S, L, N, d,
            w_f, tile, G, int(prefetch), _counter_ptr(counters), stream)
    _raise_on_error(lib, err, "cuda_tiled_fused")
    LAUNCHES["cuda_tiled_fused"] += 1
    TILED_LAUNCHES[name] += 1
    return hot_in, hot_out, got_in, got_out
