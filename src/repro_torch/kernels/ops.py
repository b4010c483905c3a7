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
  in ``StepInputs.plan_*``; "auto" at T>1 on the GPU. Its
  ``update_fused`` is the split-table kernel K4
  (``fullw2v_cuda_tiled_fused``), which a vocab-sharded step runs.

:func:`step` runs the single-replica f32 step and the vocab-sharded f32
step on one shard (DESIGN.md §8: replicated hot head, cold tail, row
exchange planned on the host by ``repro_torch.distributed
.vocab_placement``). Data parallelism, more than one shard and
mixed-precision storage raise until their slices land.
"""
from __future__ import annotations

import torch

from repro_torch.configs.w2v import W2VConfig, resolve_gemm_windows
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import registry
from repro_torch.kernels.fullw2v import (fullw2v_cuda, fullw2v_cuda_tiled,
                                         fullw2v_cuda_tiled_fused)
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


def _update_fused_cuda_tiled(hot_in, hot_out, got_in, got_out, step, static):
    return fullw2v_cuda_tiled_fused(hot_in, hot_out, got_in, got_out,
                                    *_tiled_args(step, static),
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
# torch_tiled declares no update_fused, as jnp_tiled has none: CPU runs of
# a vocab-sharded step take the concat route of _VocabShardedRun.compute
register(KernelBackend(
    name="torch_tiled", update=_update_torch_tiled,
    description="window-tiled plain torch version "
                "(kernels.ref.batch_sgns_tiled_ref)",
    needs_plan=True, supports_vocab_shard=True,
    supports_dtypes=_ALL_DTYPES, supports_frontends=_FRONTENDS))
register(KernelBackend(
    name="cuda_tiled", update=_update_cuda_tiled,
    description="window-tiled CUDA kernel (K3; K4 on a split table)",
    needs_plan=True, requires_cuda=True, supports_vocab_shard=True,
    supports_dtypes=_NATIVE_DTYPES, update_fused=_update_fused_cuda_tiled))


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
    """Train one batch of sentences with FULL-W2V semantics, updating the
    tables in place (the reference's jit donates them); returns
    ``tables``.

    * ``tables.placement`` set → the vocab-sharded step (one shard): the
      step must carry an exchange plan (``step.cold_ids``/``bucket_*``
      from ``repro_torch.distributed.vocab_placement.plan_exchange``);
      ``tables.spec.exchange`` picks the request-exact or the dense
      exchange.
    * otherwise → the single-replica step on the full tables.

    ``step.has_plan`` selects the window-tiled kernel family in both cases
    (bit-identical to the sequential one at T=1). The backend resolves
    against the tables' device: the CUDA kernels on the GPU, the plain
    versions on the CPU.
    """
    tables.check_runnable()
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel (mesh) steps arrive with a later slice of the "
            "torch port")
    platform = tables.w_in.device.type
    dtypes = () if tables.spec.master_copy else tables.spec.dtypes
    static = static_for(cfg, step.tile)
    if tables.placement is not None:
        if not step.has_vocab_shard:
            raise ValueError(
                "Tables carry a VocabPlacement but StepInputs has no "
                "exchange plan (cold_ids); build the step via "
                "repro_torch.distributed.vocab_placement.plan_exchange")
        be = registry.resolve(backend, tiled=step.has_plan, vocab_shard=True,
                              dtypes=dtypes, platform=platform)
        _VocabShardedRun(be.name, static, tables.placement,
                         exchange=tables.spec.exchange)(
            tables.w_in, tables.w_out, tables.cold_in, tables.cold_out, step)
        return tables
    if step.has_vocab_shard:
        raise ValueError(
            "StepInputs carries a vocab-sharding exchange plan (cold_ids); "
            "this is the single-replica entry point. Run the step through "
            "a TrainSession with cfg.vocab_shard=True, or build the step "
            "without plan_exchange.")
    be = registry.resolve(backend, tiled=step.has_plan, dtypes=dtypes,
                          platform=platform)
    be.update(tables.w_in, tables.w_out, step, static)
    return tables


# ---------------------------------------------------------------------------
# Collectives over the vocab shards. One process holds one shard until the
# data-parallel slice (ROADMAP item 7) brings a process group; at one shard
# each is an exact identity, at more it raises.
# ---------------------------------------------------------------------------

def _one_shard(n: int, what: str) -> None:
    if n != 1:
        raise NotImplementedError(
            f"{what} over {n} vocab shards needs a process group, which "
            f"arrives with the data-parallel slice of the torch port "
            f"(ROADMAP item 7); one shard runs today")


def all_gather(x: torch.Tensor, n: int) -> torch.Tensor:
    """Every shard's ``x`` stacked on a new leading axis: ``(n, ...)``."""
    _one_shard(n, "all_gather")
    return x.unsqueeze(0)


def all_to_all(x: torch.Tensor, n: int) -> torch.Tensor:
    """Block ``x[o]`` goes to shard ``o``; returns the blocks addressed
    to this shard, ``(n, ...)`` by sender."""
    _one_shard(n, "all_to_all")
    return x


def psum_scatter(x: torch.Tensor, n: int) -> torch.Tensor:
    """Sum ``(n, ...)`` over shards and keep this shard's block
    ``(1, ...)`` (the reference's tiled ``psum_scatter`` on axis 0)."""
    _one_shard(n, "psum_scatter")
    return x


def pmean(x: torch.Tensor, n: int) -> torch.Tensor:
    """Mean of ``x`` over shards."""
    _one_shard(n, "pmean")
    return x


# ---------------------------------------------------------------------------
# Vocab-sharded runner (DESIGN.md §8): hot replica + cold shard exchange
# ---------------------------------------------------------------------------

class _VocabShardedRun:
    """The per-shard f32 update of vocab-sharded tables: the port of the
    reference's ``_vocab_sharded_run`` (``compute``, ``hogwild_mean``,
    ``run_dense_f32``, ``run_exact_f32``), in place.

    ``run(hot_in, hot_out, cold_in, cold_out, step)`` takes the replicated
    ``(hot, d)`` head tables, this shard's ``(cold_per_shard, d)`` block
    of the striped cold tail and a ``StepInputs`` built by
    ``plan_exchange``. One step does, on the device:

    1. **Gather** the cold rows the batch requests into a compact ``(R, d)``
       block in request order. ``exchange="exact"``: route the per-owner
       request buckets with ``all_to_all``, serve the owned rows, send them
       back and land each at its host-planned position. ``exchange="dense"``:
       ``all_gather`` every shard's request list and ``psum_scatter`` the
       served rows (the reference's parity path).
    2. **Compute**: a backend declaring ``update_fused`` (``cuda_tiled``:
       K4) gets the hot head and the gathered block as separate buffers;
       the rest run on ``concat(hot, got)``.
    3. **Write back**: ``pmean`` the hot head; route the updated request
       rows to their owners, scatter-add them and average each touched
       row over all ``n`` replicas (``hogwild_mean``); untouched rows keep
       their values.

    Gathers and scatter-adds are torch index ops on the tables' device
    (``index_select``, ``index_copy_``, ``index_add_``); a scratch row past
    the end of each target takes the padding slots the reference drops.
    The route (``route``), the gather (``gather``) and the write-back
    (``write_back``) are separate methods so a caller can time them.
    """

    def __init__(self, backend: str, static: KernelStatic, placement,
                 exchange: str = "exact"):
        be = registry.get(backend)
        if not be.supports_vocab_shard:
            raise ValueError(
                f"backend {backend!r} does not support vocab-sharded tables; "
                f"resolve with vocab_shard=True to get an actionable choice")
        if exchange not in ("exact", "dense"):
            raise ValueError(f"exchange must be 'exact' or 'dense', "
                             f"got {exchange!r}")
        _one_shard(placement.n_shards, "the vocab-sharded step")
        self.be, self.static, self.exchange = be, static, exchange
        self.hot = placement.hot
        self.cps = placement.cold_per_shard
        self.n = placement.n_shards
        self.me = 0      # this process's shard (one process per shard)

    def __call__(self, hot_in, hot_out, cold_in, cold_out,
                 step: StepInputs) -> None:
        route = self.route(step)
        got_in = self.gather(route, cold_in)
        got_out = self.gather(route, cold_out)
        self.compute(hot_in, hot_out, got_in, got_out, step)
        hot_in.copy_(pmean(hot_in, self.n))
        hot_out.copy_(pmean(hot_out, self.n))
        self.write_back(route, cold_in, got_in)
        self.write_back(route, cold_out, got_out)

    # -- compute ------------------------------------------------------------
    def compute(self, hot_in, hot_out, got_in, got_out, step) -> None:
        """Run the backend on the working table ``hot + got``, in place."""
        if self.be.supports_fused_gather:
            self.be.update_fused(hot_in, hot_out, got_in, got_out, step,
                                 self.static)
            return
        w_in = torch.cat([hot_in, got_in])
        w_out = torch.cat([hot_out, got_out])
        self.be.update(w_in, w_out, step, self.static)
        for part, new in ((hot_in, w_in[:self.hot]),
                          (hot_out, w_out[:self.hot]),
                          (got_in, w_in[self.hot:]),
                          (got_out, w_out[self.hot:])):
            part.copy_(new)

    # -- exchange -----------------------------------------------------------
    def route(self, step: StepInputs) -> dict:
        """The step's index plumbing, shared by both tables: which cold
        rows this shard serves, from which local rows, into which slots,
        and how many replicas touch each local row (``kcnt``)."""
        n, hot, cps = self.n, self.hot, self.cps
        if self.exchange == "exact":
            req = step.bucket_ids[self.me]              # (n, C) by owner
            pos = step.bucket_pos[self.me]              # (n, C), pad = R
            # swap requester<->owner axes: got_req[s] = the bucket shard s
            # addressed to me — the only rows I must serve
            got_req = all_to_all(req, n)
            serve = got_req >= 0
            lrow = torch.where(serve, torch.div(got_req - hot, n,
                                                rounding_mode="floor"), 0)
            reqv = req >= 0
            r = dict(serve=serve, lrow=lrow, pos=pos, reqv=reqv,
                     pos_c=torch.where(reqv, pos, 0))
        else:
            ids_all = all_gather(step.cold_ids[self.me], n)       # (n, R)
            valid = ids_all >= 0
            ci = torch.where(valid, ids_all - hot, 0)
            serve = valid & (torch.remainder(ci, n) == self.me)
            lrow = torch.where(serve, torch.div(ci, n, rounding_mode="floor"),
                               0)
            r = dict(serve=serve, lrow=lrow)
        r["width"] = step.cold_ids.shape[-1]                      # R
        tgt = torch.where(r["serve"], r["lrow"], cps).reshape(-1)
        r["tgt"] = tgt.long()                                     # cps: drop
        kcnt = torch.zeros(cps + 1, dtype=torch.float32, device=tgt.device)
        kcnt.index_add_(0, r["tgt"], r["serve"].reshape(-1).float())
        r["kcnt"] = kcnt[:cps]
        return r

    def gather(self, route: dict, cold: torch.Tensor) -> torch.Tensor:
        """This shard's ``(R, d)`` gathered block, in request order."""
        d = cold.shape[-1]
        serve, lrow = route["serve"], route["lrow"]
        rows = cold.index_select(0, lrow.reshape(-1).long())
        served = torch.where(serve.reshape(-1, 1), rows, 0.0).view(
            *serve.shape, d)
        if self.exchange == "dense":
            return psum_scatter(served, self.n)[0]
        vals = all_to_all(served, self.n)
        # vals[o, c] is the value of req[o, c]; land it at its first-seen
        # position in the gathered block (pads land in the scratch row R)
        width = route["width"]
        got = cold.new_zeros((width + 1, d))
        got.index_copy_(0, route["pos"].reshape(-1).long(),
                        vals.reshape(-1, d))
        return got[:width]

    def write_back(self, route: dict, cold: torch.Tensor,
                   new_rows: torch.Tensor) -> None:
        """Route the updated request rows to their owners and merge them
        into ``cold`` in place (owner-side Hogwild mean)."""
        n, d = self.n, cold.shape[-1]
        if self.exchange == "dense":
            upd_all = all_gather(new_rows, n)                     # (n, R, d)
            contrib = torch.where(route["serve"][..., None], upd_all, 0.0)
        else:
            reqv = route["reqv"]
            upd = new_rows.index_select(0, route["pos_c"].reshape(-1).long())
            upd = torch.where(reqv.reshape(-1, 1), upd, 0.0)
            # back[s] holds shard s's updated replicas of rows I own, in
            # the same slots as got_req[s]
            contrib = all_to_all(upd.view(*reqv.shape, d), n)
        acc = cold.new_zeros((self.cps + 1, d))
        acc.index_add_(0, route["tgt"], contrib.reshape(-1, d))
        cold.copy_(self.hogwild_mean(cold, acc[:self.cps], route["kcnt"]))

    def hogwild_mean(self, cold, acc, kcnt) -> torch.Tensor:
        """Owner-side merge: sum of the k updated replicas of each touched
        row plus (n - k) copies of the pre-step value, divided by n."""
        touched = kcnt[:, None] > 0
        return torch.where(touched,
                           (acc + (self.n - kcnt)[:, None] * cold) / self.n,
                           cold)
