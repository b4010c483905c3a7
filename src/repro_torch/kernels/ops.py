"""Public entry point for the FULL-W2V kernel family (engine API).

The port's counterpart of ``repro.kernels.ops``: backend registrations and
the one dispatch function :func:`step`. Registered backends:

* ``torch`` / ``torch_tiled`` — the plain versions (``kernels.ref``); what
  "auto" resolves to on the CPU.
* ``cuda`` / ``cuda_pipelined`` — the sequential CUDA kernel and its
  prefetching form (``kernels.fullw2v.fullw2v_cuda``); "auto" at T=1 on the
  GPU is ``cuda_pipelined``.
* ``cuda_tiled`` — the window-tiled CUDA kernel
  (``kernels.fullw2v.fullw2v_cuda_tiled``), consuming the host tile plan
  in ``StepInputs.plan_*``; "auto" at T>1 on the GPU.

This slice runs the single-replica f32 step. Data parallelism, vocab
sharding and mixed-precision storage raise until their slices land.
"""
from __future__ import annotations

from repro_torch.configs.w2v import W2VConfig, resolve_gemm_windows
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import registry
from repro_torch.kernels.fullw2v import fullw2v_cuda, fullw2v_cuda_tiled
from repro_torch.kernels.registry import (KernelBackend, KernelStatic,
                                          StepInputs, register)
from repro_torch.kernels.tables import Tables


# ---------------------------------------------------------------------------
# Backend update() implementations (in place on the tables)
# ---------------------------------------------------------------------------

def _seq_args(step: StepInputs):
    return step.tokens, step.negs, step.lengths, step.lr


def _tiled_args(step: StepInputs, static: KernelStatic):
    if not step.has_plan:
        raise ValueError("tiled backend requires StepInputs.plan_*")
    return (*_seq_args(step), static.w_f, static.tile, step.plan_uniq,
            step.plan_scatter, step.plan_ucount, step.plan_strict)


def _update_torch(w_in, w_out, step, static):
    return _ref.batch_sgns_ref(w_in, w_out, *_seq_args(step), static.w_f)


def _update_cuda(w_in, w_out, step, static):
    return fullw2v_cuda(w_in, w_out, *_seq_args(step), static.w_f)


def _update_cuda_pipelined(w_in, w_out, step, static):
    return fullw2v_cuda(w_in, w_out, *_seq_args(step), static.w_f,
                        pipeline=True)


def _update_torch_tiled(w_in, w_out, step, static):
    return _ref.batch_sgns_tiled_ref(w_in, w_out, *_tiled_args(step, static),
                                     gemm_windows=static.gemm_windows)


def _update_cuda_tiled(w_in, w_out, step, static):
    return fullw2v_cuda_tiled(w_in, w_out, *_tiled_args(step, static),
                              gemm_windows=static.gemm_windows)


# capabilities mirror the reference's descriptors (see registry docstring)
_ALL_DTYPES = ("float32", "bfloat16", "int8")
_NATIVE_DTYPES = ("float32", "bfloat16")
_FRONTENDS = ("static_ctx", "bags")

register(KernelBackend(
    name="torch", update=_update_torch,
    description="plain torch version (kernels.ref.batch_sgns_ref)",
    supports_tiling=True, supports_vocab_shard=True,
    supports_dtypes=_ALL_DTYPES, supports_frontends=_FRONTENDS,
    tiled_variant="torch_tiled"))
register(KernelBackend(
    name="cuda", update=_update_cuda,
    description="sequential CUDA kernel (K1)",
    requires_cuda=True, supports_tiling=True, supports_vocab_shard=True,
    supports_dtypes=_NATIVE_DTYPES, tiled_variant="cuda_tiled"))
# cuda_pipelined opts out of vocab sharding, as pallas_pipelined does
register(KernelBackend(
    name="cuda_pipelined", update=_update_cuda_pipelined,
    description="sequential CUDA kernel with §3.1 prefetch (K2)",
    requires_cuda=True, supports_pipeline=True, supports_tiling=True,
    supports_dtypes=_NATIVE_DTYPES, tiled_variant="cuda_tiled"))
register(KernelBackend(
    name="torch_tiled", update=_update_torch_tiled,
    description="window-tiled plain torch version "
                "(kernels.ref.batch_sgns_tiled_ref)",
    needs_plan=True, supports_vocab_shard=True,
    supports_dtypes=_ALL_DTYPES, supports_frontends=_FRONTENDS))
register(KernelBackend(
    name="cuda_tiled", update=_update_cuda_tiled,
    description="window-tiled CUDA kernel (K3)",
    needs_plan=True, requires_cuda=True, supports_vocab_shard=True,
    supports_dtypes=_NATIVE_DTYPES))


# ---------------------------------------------------------------------------
# The single dispatch entry point
# ---------------------------------------------------------------------------

def static_for(cfg: W2VConfig, tile: int = 1) -> KernelStatic:
    """The static kernel parameters for this config at tile size T."""
    return KernelStatic(
        w_f=cfg.fixed_window, tile=tile,
        gemm_windows=(resolve_gemm_windows(tile, cfg.tile_gemm_windows)
                      if tile > 1 else 0))


def step(tables: Tables, step: StepInputs, cfg: W2VConfig,
         backend: str = "auto", mesh=None) -> Tables:
    """Train one batch of sentences with FULL-W2V semantics, updating
    ``tables.w_in``/``tables.w_out`` in place (the reference's jit donates
    them); returns ``tables``.

    ``step.has_plan`` selects the window-tiled kernel family (bit-identical
    to the sequential one at T=1). The backend resolves against the tables'
    device: the CUDA kernels on the GPU, the plain versions on the CPU.
    """
    tables.check_runnable()
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel (mesh) steps arrive with a later slice of the "
            "torch port")
    be = registry.resolve(backend, tiled=step.has_plan,
                          platform=tables.w_in.device.type)
    be.update(tables.w_in, tables.w_out, step, static_for(cfg, step.tile))
    return tables
