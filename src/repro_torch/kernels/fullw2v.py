"""Wrappers of the FULL-W2V CUDA kernels (sources in ``csrc/``).

The port's counterpart of ``repro.kernels.fullw2v``'s host entry points:

* :func:`fullw2v_cuda` — the sequential kernel (``pipeline=False``, backend
  ``cuda``, replacing ``_kernel``) or its prefetching form
  (``pipeline=True``, backend ``cuda_pipelined``, replacing
  ``_kernel_pipelined``); bit-identical to each other.
* :func:`fullw2v_cuda_tiled` — the window-tiled kernel (backend
  ``cuda_tiled``, replacing ``_kernel_tiled``), driven by the host tile
  plan; bit-identical to the sequential kernel at T=1.

Both update ``w_in`` and ``w_out`` **in place** (the reference donates its
tables to the same effect) and return them. Tensors on the CPU run the
plain version (``kernels.ref``); CUDA tensors launch the kernel on the
current stream or raise — there is no fallback. Each launch adds one to
its kernel's count in :data:`LAUNCHES`.

PRECONDITION (as in the reference, guaranteed by
``repro_torch.data.negatives``): within one window the N negatives are
distinct from each other and from the target. With duplicates the kernels'
per-row write-back is last-write-wins while the plain version scatter-adds.
Token and negative ids must lie in ``[0, V)``; the kernels do not check.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.w2v import resolve_gemm_windows
from repro_torch.kernels import ref as _ref

# kernel launches per backend name; chip_smoke and the tests zero them
# before a run and read them after to prove the run went through the kernel
LAUNCHES: Dict[str, int] = {"cuda": 0, "cuda_pipelined": 0, "cuda_tiled": 0}

def reset_launch_counts() -> None:
    """Zero every kernel's launch count."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tiled_scratch_rows(tile: int, w_f: int, n_neg: int,
                       gemm_windows: int = 0) -> dict:
    """Shared-memory rows of the tiled kernel's buffers (each row is d
    floats; ``g`` counts floats): the counterpart of the reference's
    ``tiled_scratch_rows`` without the TPU's sublane padding. The strict
    path reuses ``ctx_tile``/``out_exp`` for its single window."""
    g = resolve_gemm_windows(tile, gemm_windows)
    m = n_neg + 1
    return {
        "ring": tile + 2 * w_f,
        "ctx_tile": g * 2 * w_f,
        "out_uniq": tile * m,
        "out_exp": g * m,
        "g": g * 2 * w_f * m,
    }


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_batch(w_in, w_out, tokens, negs, lengths) -> Tuple[int, ...]:
    """Validate the tables and index arrays; return (S, L, N, d)."""
    for name, t in (("w_in", w_in), ("w_out", w_out)):
        _require(t.dtype == torch.float32 and t.dim() == 2,
                 f"{name} must be a 2-D float32 tensor, got {t.dtype} "
                 f"{tuple(t.shape)}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(w_in.shape == w_out.shape,
             f"w_in {tuple(w_in.shape)} and w_out {tuple(w_out.shape)} "
             f"differ")
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
    return S, L, negs.shape[2], w_in.shape[1]


def _on_cuda(*tensors) -> bool:
    """True when every tensor is on one CUDA device, False when every
    tensor is on the CPU; anything else raises."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    _require(len(devices) == 1 and next(iter(devices)).type == "cuda",
             f"the kernel's tensors must share one CUDA device (or all lie "
             f"on the CPU for the plain version), got "
             f"{sorted(map(str, devices))}")
    return True


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
    selects the prefetching kernel (same results, bit for bit)."""
    S, L, N, d = _check_batch(w_in, w_out, tokens, negs, lengths)
    if not _on_cuda(w_in, w_out, tokens, negs, lengths):
        return _ref.batch_sgns_ref(w_in, w_out, tokens, negs, lengths, lr,
                                   w_f)
    from repro_torch.kernels._build import load
    lib = load().lib
    with torch.cuda.device(w_in.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fullw2v_seq_launch(
            w_in.data_ptr(), w_out.data_ptr(), tokens.data_ptr(),
            negs.data_ptr(), lengths.data_ptr(), _ref.lr32(lr), S, L, N, d,
            w_f, int(pipeline), stream)
    name = "cuda_pipelined" if pipeline else "cuda"
    _raise_on_error(lib, err, name)
    LAUNCHES[name] += 1
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window-tiled FULL-W2V pass (T windows per step, deltas applied in
    groups of G windows), updating ``w_in``/``w_out`` in place. The plan
    must come from ``repro_torch.data.batching.plan_tiles`` for the same
    batch."""
    S, L, N, d = _check_batch(w_in, w_out, tokens, negs, lengths)
    _require(tile >= 1, f"tile must be >= 1, got {tile}")
    G = resolve_gemm_windows(tile, gemm_windows)
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
    if not _on_cuda(w_in, w_out, tokens, negs, lengths, uniq, scatter,
                    ucount, strict):
        return _ref.batch_sgns_tiled_ref(w_in, w_out, tokens, negs, lengths,
                                         lr, w_f, tile, uniq, scatter, ucount,
                                         strict, gemm_windows=G)
    from repro_torch.kernels._build import load
    lib = load().lib
    with torch.cuda.device(w_in.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fullw2v_tiled_launch(
            w_in.data_ptr(), w_out.data_ptr(), tokens.data_ptr(),
            negs.data_ptr(), lengths.data_ptr(), uniq.data_ptr(),
            scatter.data_ptr(), ucount.data_ptr(), strict.data_ptr(),
            _ref.lr32(lr), S, L, N, d, w_f, tile, G, stream)
    _raise_on_error(lib, err, "cuda_tiled")
    LAUNCHES["cuda_tiled"] += 1
    return w_in, w_out
