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

:func:`step` runs the single-replica step, the Hogwild data-parallel
step (the reference's ``_jitted_dp_update``: each rank updates its
replica on its block of the batch, then the replicas average) and the
vocab-sharded step over any number of shards (DESIGN.md §8: replicated hot
head, cold tail striped over the ranks, row exchange planned on the host
by ``repro_torch.distributed.vocab_placement``). A mesh
(``repro_torch.launch.mesh.DataMesh``) is one rank of a
``torch.distributed`` group; the collectives are
``repro_torch.distributed.collectives``.

Mixed-precision storage (DESIGN.md §11): tables stored in ``bfloat16`` or
``int8`` decode to f32 working tensors, the unchanged f32 backend updates
those in place, and the results store back with keyed stochastic rounding
(``kernels.quant``; the key rides in ``StepInputs.round_key``). In the
exact exchange the cold rows travel in storage precision and the
write-back travels round-to-nearest quantized, as in the reference.
Backends that cannot take a storage dtype (the CUDA kernels and int8) run
it under the f32 master copy (``TableSpec.master_copy``): decode every
table, the f32 step, re-encode every row.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from repro_torch.configs.w2v import W2VConfig, resolve_gemm_windows
from repro_torch.distributed import collectives as coll
from repro_torch.kernels import quant
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import registry
from repro_torch.kernels.fullw2v import (fullw2v_cuda, fullw2v_cuda_tiled,
                                         fullw2v_cuda_tiled_fused)
from repro_torch.kernels.registry import (KernelBackend, KernelStatic,
                                          StepInputs, register)
from repro_torch.kernels.tables import Tables, TableSpec


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


def _frontend_args(step: StepInputs) -> dict:
    return dict(static_ids=step.static_ctx, bags=step.bags)


def _update_torch(w_in, w_out, step, static):
    return _ref.batch_sgns_ref(w_in, w_out, *_seq_args(step), static.w_f,
                               **_frontend_args(step))


def _update_cuda(w_in, w_out, step, static):
    return fullw2v_cuda(w_in, w_out, *_seq_args(step), static.w_f)


def _update_cuda_pipelined(w_in, w_out, step, static):
    return fullw2v_cuda(w_in, w_out, *_seq_args(step), static.w_f,
                        pipeline=True)


def _update_torch_tiled(w_in, w_out, step, static):
    return _ref.batch_sgns_tiled_ref(w_in, w_out, *_tiled_args(step, static),
                                     gemm_windows=static.gemm_windows,
                                     **_frontend_args(step))


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



def traceable_update(backend: str, static: KernelStatic):
    """The named backend's raw ``(w_in, w_out, step) -> (w_in, w_out)``
    update, in place — the function :func:`step` resolves and runs, for
    callers that embed it in their own step. No resolution and no
    fallback: a CUDA backend given CPU tensors raises, as the kernels'
    wrappers do."""
    be = registry.get(backend)

    def run(w_in: torch.Tensor, w_out: torch.Tensor, step: StepInputs):
        return be.update(w_in, w_out, step, static)

    return run


def step(tables: Tables, step: StepInputs, cfg: W2VConfig,
         backend: str = "auto", mesh=None) -> Tables:
    """Train one batch of sentences with FULL-W2V semantics, updating the
    tables in place (the reference's jit donates them); returns
    ``tables``.

    * ``tables.placement`` set → the vocab-sharded step: the step must
      carry an exchange plan (``step.cold_ids``/``bucket_*`` from
      ``repro_torch.distributed.vocab_placement.plan_exchange``, lifted
      for this rank); ``tables.spec.exchange`` picks the request-exact or
      the dense exchange. A placement over n > 1 shards needs a ``mesh``
      of n ranks; ``tables`` then hold this rank's cold stripe.
    * no placement, ``mesh`` given → Hogwild data parallelism: ``step``
      holds this rank's block of the batch, the backend updates this
      rank's replica, and the replicas average (``collectives.pmean``).
    * neither → the single-replica step on the full tables.

    ``step.has_plan`` selects the window-tiled kernel family in both cases
    (bit-identical to the sequential one at T=1). The backend resolves
    against the tables' device: the CUDA kernels on the GPU, the plain
    versions on the CPU. Sub-f32 storage in ``tables.spec`` needs
    ``step.round_key`` and a backend that takes the storage dtypes, unless
    ``spec.master_copy`` asks for the f32 master copy.
    """
    tables.check_runnable()
    spec = tables.spec
    if spec.is_mixed and step.round_key is None:
        raise ValueError(
            "TableSpec stores a table below f32 but StepInputs.round_key "
            "is None; attach quant.round_key(cfg.seed, epoch, batch_index) "
            "so stochastic rounding stays bit-deterministic")
    platform = tables.w_in.device.type
    dtypes = () if spec.master_copy else spec.dtypes
    static = static_for(cfg, step.tile)
    if tables.placement is not None:
        if not step.has_vocab_shard:
            raise ValueError(
                "Tables carry a VocabPlacement but StepInputs has no "
                "exchange plan (cold_ids); build the step via "
                "repro_torch.distributed.vocab_placement.plan_exchange")
        be = registry.resolve(backend, tiled=step.has_plan, vocab_shard=True,
                              dtypes=dtypes, frontends=step.frontends,
                              platform=platform)
        _VocabShardedRun(be.name, static, tables.placement,
                         exchange=spec.exchange, spec=spec,
                         mesh=mesh)(tables, step)
        return tables
    if step.has_vocab_shard:
        raise ValueError(
            "StepInputs carries a vocab-sharding exchange plan (cold_ids); "
            "this is the single-replica entry point. Run the step through "
            "a TrainSession with cfg.vocab_shard=True, or build the step "
            "without plan_exchange.")
    be = registry.resolve(backend, tiled=step.has_plan, dtypes=dtypes,
                          frontends=step.frontends, platform=platform)
    dt = spec.hot_dtype
    if dt == "float32":
        be.update(tables.w_in, tables.w_out, step, static)
        for w in (tables.w_in, tables.w_out):
            w.copy_(coll.pmean(w, mesh))      # identity without a mesh
        return tables
    # decode → the unchanged f32 update → (the replicas' mean) → keyed
    # stochastic re-encode: the key is the same on every rank, so every
    # rank stores the same bytes; values exact in the storage dtype
    # round-trip, so untouched rows stay
    w_in = quant.decode(tables.w_in, None, dt)
    w_out = quant.decode(tables.w_out, None, dt)
    be.update(w_in, w_out, step, static)
    for store, new, tag in ((tables.w_in, w_in, quant.TAG_FULL_IN),
                            (tables.w_out, w_out, quant.TAG_FULL_OUT)):
        store.copy_(quant.encode_stochastic(coll.pmean(new, mesh), dt,
                                            step.round_key, tag)[0])
    return tables


_step = step   # module-level alias: the shims' `step` parameter shadows it


# ---------------------------------------------------------------------------
# Vocab-sharded runner (DESIGN.md §8): hot replica + cold shard exchange
# ---------------------------------------------------------------------------

class _VocabShardedRun:
    """The per-shard update of vocab-sharded tables: the port of the
    reference's ``_vocab_sharded_run`` (``compute``, ``hogwild_mean``, the
    f32 paths ``run_dense_f32``/``run_exact_f32``, and for sub-f32
    storage ``run_dense_mixed``/``run_exact_mixed``/``run_master`` with
    ``requant_hot``/``requant_cold``), in place.

    ``run(tables, step)`` takes the replicated ``(hot, d)`` head tables,
    this shard's ``(cold_per_shard, d)`` block of the striped cold tail
    (and its int8 scales) and a ``StepInputs`` built by
    ``plan_exchange`` and lifted for this rank (its block of sentences,
    its ``(1, ...)`` rows of ``cold_ids``/``bucket_*``). Shard ``r`` is
    rank ``r`` of ``mesh`` (one shard: no mesh). One step does, on the
    device:

    1. **Gather** the cold rows the batch requests into a compact f32
       ``(R, d)`` block in request order. ``exchange="exact"``: route the
       per-owner request buckets with ``all_to_all``, serve the owned rows
       in storage precision (int8 payload and scale, bf16 or f32), send
       them back, decode, and land each at its host-planned position.
       ``exchange="dense"``: ``all_gather`` every shard's request list and
       ``psum_scatter`` the served rows, decoded (the reference's parity
       path).
    2. **Compute**: a backend declaring ``update_fused`` (``cuda_tiled``:
       K4) gets the hot head and the gathered block as separate buffers;
       the rest run on ``concat(hot, got)``. A bf16 head computes on an f32
       copy.
    3. **Write back**: ``pmean`` the hot head (a bf16 head then stores with
       keyed stochastic rounding); route the updated request rows to their
       owners (on the exact path of a sub-f32 tail quantized
       round-to-nearest for the transport), add them up sender by sender
       in rank order and average each touched row over all ``n``
       replicas (``hogwild_mean``); a
       sub-f32 tail re-encodes the touched rows with keyed stochastic
       rounding (the key folded with the tag and then this shard's index)
       and keeps the untouched rows' exact storage bytes.

    A backend that cannot take the storage dtypes runs the f32 path
    between a full decode and a full stochastic re-encode of every row
    (the master copy, ``TableSpec.master_copy``).

    Gathers and scatter-adds are torch index ops on the tables' device
    (``index_select``, ``index_copy_``, ``index_add_``); a scratch row past
    the end of each target takes the padding slots the reference drops.
    The route (``route``), the gather (``gather``) and the write-back
    (``write_back``, or ``merge`` for stored tails) are separate methods so
    a caller can time them.
    """

    def __init__(self, backend: str, static: KernelStatic, placement,
                 exchange: str = "exact",
                 spec: TableSpec = TableSpec(vocab_shard=True), mesh=None):
        be = registry.get(backend)
        if not be.supports_vocab_shard:
            raise ValueError(
                f"backend {backend!r} does not support vocab-sharded tables; "
                f"resolve with vocab_shard=True to get an actionable choice")
        if exchange not in ("exact", "dense"):
            raise ValueError(f"exchange must be 'exact' or 'dense', "
                             f"got {exchange!r}")
        ranks = 1 if mesh is None else mesh.size
        if placement.n_shards != ranks:
            raise ValueError(
                f"a placement over {placement.n_shards} vocab shards runs "
                f"on a mesh of {placement.n_shards} ranks, one shard each; "
                f"got {'no mesh' if mesh is None else f'{ranks} ranks'}")
        self.be, self.static, self.exchange = be, static, exchange
        self.mesh = mesh
        self.hot = placement.hot
        self.cps = placement.cold_per_shard
        self.n = placement.n_shards
        self.me = 0 if mesh is None else mesh.rank   # this rank's shard
        self.hot_dt, self.cold_dt = spec.hot_dtype, spec.cold_dtype
        self.mixed = spec.is_mixed
        self.native = all(d in be.supports_dtypes for d in spec.dtypes)

    def __call__(self, tables: Tables, step: StepInputs) -> None:
        t = tables
        if not self.mixed:
            self.run_f32(t.w_in, t.w_out, t.cold_in, t.cold_out, step)
        elif not self.native:
            self.run_master(t, step)
        else:
            self.run_mixed(t, step)

    def run_f32(self, hot_in, hot_out, cold_in, cold_out, step) -> None:
        """The f32 step on f32 tables, in place."""
        route = self.route(step)
        got_in = self.gather(route, cold_in)
        got_out = self.gather(route, cold_out)
        self.compute(hot_in, hot_out, got_in, got_out, step)
        hot_in.copy_(coll.pmean(hot_in, self.mesh))
        hot_out.copy_(coll.pmean(hot_out, self.mesh))
        self.write_back(route, cold_in, got_in)
        self.write_back(route, cold_out, got_out)

    def run_master(self, t: Tables, step) -> None:
        """The f32 master copy: decode every table, the f32 step, then
        re-encode every row (correct with any backend, but cold rows
        re-encode every step and the transport stays f32)."""
        dec = [quant.decode(t.w_in, None, self.hot_dt),
               quant.decode(t.w_out, None, self.hot_dt),
               quant.decode(t.cold_in, t.scale_in, self.cold_dt),
               quant.decode(t.cold_out, t.scale_out, self.cold_dt)]
        self.run_f32(*dec, step)
        self.store_hot(t, dec[0], dec[1], step.round_key)
        every = torch.ones(self.cps, dtype=torch.bool, device=t.w_in.device)
        self.store_cold(t.cold_in, t.scale_in, dec[2], every, step.round_key,
                        quant.TAG_COLD_IN)
        self.store_cold(t.cold_out, t.scale_out, dec[3], every,
                        step.round_key, quant.TAG_COLD_OUT)

    def run_mixed(self, t: Tables, step) -> None:
        """The native mixed step: the tail gathers in storage precision,
        the head computes on an f32 copy, touched rows re-encode."""
        route = self.route(step)
        got_in = self.gather(route, t.cold_in, t.scale_in)
        got_out = self.gather(route, t.cold_out, t.scale_out)
        hot_in = quant.decode(t.w_in, None, self.hot_dt)
        hot_out = quant.decode(t.w_out, None, self.hot_dt)
        self.compute(hot_in, hot_out, got_in, got_out, step)
        hot_in.copy_(coll.pmean(hot_in, self.mesh))
        hot_out.copy_(coll.pmean(hot_out, self.mesh))
        self.store_hot(t, hot_in, hot_out, step.round_key)
        touched = route["kcnt"] > 0
        quantize = self.exchange == "exact"
        for cold, scale, new_rows, tag in (
                (t.cold_in, t.scale_in, got_in, quant.TAG_COLD_IN),
                (t.cold_out, t.scale_out, got_out, quant.TAG_COLD_OUT)):
            merged = self.merge(route, quant.decode(cold, scale, self.cold_dt),
                                new_rows, quantize=quantize)
            self.store_cold(cold, scale, merged, touched, step.round_key, tag)

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
        if step.cold_ids.shape[0] != 1:
            raise ValueError(
                f"the step carries the exchange plans of "
                f"{step.cold_ids.shape[0]} requesters; lift this rank's "
                f"row (VocabExchange.step_inputs(..., mesh=mesh))")
        if self.exchange == "exact":
            req = step.bucket_ids[0]                    # (n, C) by owner
            pos = step.bucket_pos[0]                    # (n, C), pad = R
            # swap requester<->owner axes: got_req[s] = the bucket shard s
            # addressed to me — the only rows I must serve
            got_req = coll.all_to_all(req, self.mesh)
            serve = got_req >= 0
            lrow = torch.where(serve, torch.div(got_req - hot, n,
                                                rounding_mode="floor"), 0)
            reqv = req >= 0
            r = dict(serve=serve, lrow=lrow, pos=pos, reqv=reqv,
                     pos_c=torch.where(reqv, pos, 0))
        else:
            ids_all = coll.all_gather(step.cold_ids[0], self.mesh)  # (n, R)
            valid = ids_all >= 0
            ci = torch.where(valid, ids_all - hot, 0)
            serve = valid & (torch.remainder(ci, n) == self.me)
            lrow = torch.where(serve, torch.div(ci, n, rounding_mode="floor"),
                               0)
            r = dict(serve=serve, lrow=lrow)
        r["width"] = step.cold_ids.shape[-1]                      # R
        # (n, slots) by sender; pads and rows served elsewhere land in the
        # scratch row cps, which is dropped
        r["tgt"] = torch.where(r["serve"], r["lrow"], cps).long()
        kcnt = torch.zeros(cps + 1, dtype=torch.float32,
                           device=r["tgt"].device)
        self._by_sender(kcnt, r["tgt"], r["serve"].float())
        r["kcnt"] = kcnt[:cps]
        return r

    @staticmethod
    def _by_sender(acc: torch.Tensor, tgt: torch.Tensor,
                   rows: torch.Tensor) -> None:
        """``acc[tgt[s]] += rows[s]`` for each sender ``s`` in rank order,
        one ``index_add_`` per sender: a row gets up to one contribution
        from each sender (a requester's list holds distinct rows), so each
        launch adds to distinct rows and the sum runs in rank order, the
        same bits on every run (CUDA's ``index_add_`` adds repeated
        indices with atomics, in no fixed order)."""
        for s in range(tgt.shape[0]):
            acc.index_add_(0, tgt[s], rows[s])

    def gather(self, route: dict, cold: torch.Tensor,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """This shard's f32 ``(R, d)`` gathered block, in request order.
        ``cold`` is stored in the spec's cold dtype (``scale``: its int8
        scales); on the exact path the rows travel in that precision and
        decode on arrival."""
        d = cold.shape[-1]
        serve, lrow = route["serve"], route["lrow"]
        idx = lrow.reshape(-1).long()
        keep = serve.reshape(-1, 1)
        rows = cold.index_select(0, idx)
        rscale = None if scale is None else scale.index_select(0, idx)
        if self.exchange == "dense":
            rows = quant.decode(rows, rscale, self.cold_dt)
            served = torch.where(keep, rows, 0.0).view(*serve.shape, d)
            return coll.psum_scatter(served, self.mesh)[0]
        zero = 0 if rows.dtype == torch.int8 else 0.0
        sent = torch.where(keep, rows, zero).view(*serve.shape, d)
        vals = coll.all_to_all(sent, self.mesh)
        if rscale is not None:
            sent_s = torch.where(serve.reshape(-1), rscale, 0.0)
            vals = quant.int8_decode(vals, coll.all_to_all(sent_s.view(
                serve.shape), self.mesh))
        else:
            vals = vals.to(torch.float32)
        # vals[o, c] is the value of req[o, c]; land it at its first-seen
        # position in the gathered block (pads land in the scratch row R)
        width = route["width"]
        got = vals.new_zeros((width + 1, d))
        got.index_copy_(0, route["pos"].reshape(-1).long(),
                        vals.reshape(-1, d))
        return got[:width]

    def contributions(self, route: dict, new_rows: torch.Tensor,
                      quantize: bool = False) -> torch.Tensor:
        """The updated request rows as their owners receive them, one row
        per slot of ``route["tgt"]``: ``(n, slots, d)`` by sender.
        ``quantize``: the exact path's transport of a sub-f32 tail,
        round-to-nearest (an int8 row with its own scale of the values
        sent, or bf16)."""
        mesh, d = self.mesh, new_rows.shape[-1]
        if self.exchange == "dense":
            upd_all = coll.all_gather(new_rows, mesh)             # (n, R, d)
            return torch.where(route["serve"][..., None], upd_all, 0.0)
        reqv = route["reqv"]
        upd = new_rows.index_select(0, route["pos_c"].reshape(-1).long())
        upd = torch.where(reqv.reshape(-1, 1), upd, 0.0)
        # back[s] holds shard s's updated replicas of rows I own, in the
        # same slots as got_req[s]
        if quantize and self.cold_dt == "int8":
            ts = quant.int8_scale(upd)
            tq, _ = quant.int8_nearest(upd, ts)
            back = quant.int8_decode(
                coll.all_to_all(tq.view(*reqv.shape, d), mesh),
                coll.all_to_all(ts.view(reqv.shape), mesh))
        elif quantize and self.cold_dt == "bfloat16":
            back = coll.all_to_all(quant.bf16_nearest(upd).view(
                *reqv.shape, d), mesh).to(torch.float32)
        else:
            back = coll.all_to_all(upd.view(*reqv.shape, d), mesh)
        return back

    def merge(self, route: dict, cold: torch.Tensor, new_rows: torch.Tensor,
              quantize: bool = False) -> torch.Tensor:
        """The owner-side Hogwild mean of the f32 tail ``cold`` and the
        updated request rows (a new tensor)."""
        d = cold.shape[-1]
        acc = cold.new_zeros((self.cps + 1, d))
        self._by_sender(acc, route["tgt"],
                        self.contributions(route, new_rows, quantize))
        return self.hogwild_mean(cold, acc[:self.cps], route["kcnt"])

    def write_back(self, route: dict, cold: torch.Tensor,
                   new_rows: torch.Tensor) -> None:
        """Route the updated request rows to their owners and merge them
        into the f32 tail ``cold`` in place."""
        cold.copy_(self.merge(route, cold, new_rows))

    def hogwild_mean(self, cold, acc, kcnt) -> torch.Tensor:
        """Owner-side merge: sum of the k updated replicas of each touched
        row plus (n - k) copies of the pre-step value, divided by n."""
        touched = kcnt[:, None] > 0
        return torch.where(touched,
                           (acc + (self.n - kcnt)[:, None] * cold) / self.n,
                           cold)

    # -- storage (sub-f32 tables) -------------------------------------------
    def store_hot(self, t: Tables, hot_in, hot_out, key) -> None:
        """The f32 head back into its storage (``requant_hot``)."""
        for store, new, tag in ((t.w_in, hot_in, quant.TAG_HOT_IN),
                                (t.w_out, hot_out, quant.TAG_HOT_OUT)):
            if self.hot_dt == "bfloat16":
                store.copy_(quant.bf16_stochastic(
                    new, quant.fold_in(key, tag)))
            elif new is not store:
                store.copy_(new)

    def store_cold(self, cold, scale, merged, touched, key, tag) -> None:
        """The merged f32 tail back into its storage (``requant_cold``):
        touched rows re-encode with the key folded with ``tag`` and then
        this shard's index, untouched rows keep their exact bytes."""
        k = quant.fold_in(quant.fold_in(key, tag), self.me)
        if self.cold_dt == "int8":
            q, s = quant.int8_stochastic(merged, k)
            cold.copy_(torch.where(touched[:, None], q, cold))
            scale.copy_(torch.where(touched, s, scale))
        elif self.cold_dt == "bfloat16":
            cold.copy_(torch.where(touched[:, None],
                                   quant.bf16_stochastic(merged, k), cold))
        elif merged is not cold:
            cold.copy_(merged)


# ---------------------------------------------------------------------------
# Deprecated shims (warn and forward)
# ---------------------------------------------------------------------------

def sgns_update(
    w_in: torch.Tensor,   # (V, d) f32 — updated in place
    w_out: torch.Tensor,  # (V, d) f32 — updated in place
    step: StepInputs,     # tokens/negs/lengths/lr (+ tile plan if T > 1)
    cfg: W2VConfig,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deprecated: use :func:`step` with a plain f32 ``Tables``.

    Kept as a thin shim — warns and forwards to the unified entry point
    with ``Tables(w_in=w_in, w_out=w_out)`` (an f32 replicated spec), so
    existing callers keep their exact semantics, including the rejection
    of vocab-sharded steps. Returns the tables, updated in place.
    """
    warnings.warn(
        "ops.sgns_update is deprecated; use ops.step(Tables(w_in=..., "
        "w_out=...), step, cfg, backend=...) — the TableSpec-driven entry "
        "point that also covers sharded and mixed-precision tables",
        DeprecationWarning, stacklevel=2)
    out = _step(Tables(w_in=w_in, w_out=w_out), step, cfg, backend=backend)
    return out.w_in, out.w_out


def vocab_sharded_update(backend: str, static: KernelStatic, placement,
                         axis_name: str = "data", exchange: str = "exact"):
    """Deprecated: use :func:`step` with vocab-sharded ``Tables``.

    Kept as a thin shim — warns and returns the f32 runner with the
    pre-TableSpec ``(hot_in, hot_out, cold_in, cold_out, step) -> 4-tuple``
    signature over :meth:`_VocabShardedRun.run_f32`. One shard, no mesh
    (``axis_name`` names the reference's mesh axis and is unused): the
    runner updates the tables in place and returns them.
    """
    warnings.warn(
        "ops.vocab_sharded_update is deprecated; use ops.step with "
        "vocab-sharded Tables (spec/placement metadata select the "
        "exchange), or _VocabShardedRun for a raw per-shard runner",
        DeprecationWarning, stacklevel=2)
    run = _VocabShardedRun(backend, static, placement, exchange=exchange,
                           spec=TableSpec(vocab_shard=True))

    def run4(hot_in, hot_out, cold_in, cold_out, step):
        run.run_f32(hot_in, hot_out, cold_in, cold_out, step)
        return hot_in, hot_out, cold_in, cold_out

    return run4
