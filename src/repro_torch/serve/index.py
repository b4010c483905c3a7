"""Serving-side embedding index: checkpoint bytes → per-rank device buffers.

The port's counterpart of ``repro.serve.index``. :class:`EmbeddingIndex`
is the read-only counterpart of the trainer's split table state
(DESIGN.md §8): the replicated Zipf-hot head plus the striped cold tail,
pre-normalized row-wise on the device so every query is a pure
dot-product scan. Loading goes through the port's ``checkpoint.peek`` +
``checkpoint.restore`` (the reference's on-disk format, so either
package's checkpoints serve here) and touches **only the input table**
(``hot_in``/``cold_in``, never the output table, never a merged ``(V,
d)`` reassembly): a split checkpoint restores leaf by leaf, re-striping
the cold table when the serving rank count differs from the writing
run's (a permutation of the cold rows). Storage dtypes come from the
manifest: int8 rows re-stripe with their per-row scales riding the same
permutation, and dequantize exactly once, on the device, when the
snapshot stages.

Under a mesh of several ranks (one process per rank) each rank keeps the
hot head and only its own block of the cold tail (``cold_per_shard``
rows): the reference's ``device_put`` with ``vocab_shard_sharding``
becomes "slice your stripe". Every index carries a placement (one shard
at one rank), so the query path (:mod:`repro_torch.serve.query`) is
always the sharded code.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.distributed.vocab_placement import VocabPlacement

# Hot-head fraction used when a *replicated* checkpoint (no recorded
# placement) is split for serving: the vocabulary is frequency-sorted by
# construction, so a prefix head is still the Zipf-hot set even without
# the original corpus counts.
SERVE_HOT_FRAC = 0.1


def _normalize(rows: torch.Tensor) -> torch.Tensor:
    """L2-normalize rows (zero/padding rows stay zero)."""
    norm = torch.linalg.norm(rows, dim=-1, keepdim=True)
    return rows / torch.clamp(norm, min=1e-12)


def _restripe(cold: torch.Tensor, src: VocabPlacement,
              dst: VocabPlacement) -> torch.Tensor:
    """Permute a shard-major cold table (or its per-row scales) from
    ``src``'s stripe layout to ``dst``'s, in its own dtype and on its own
    device — train on N shards, serve on M, without reassembling the full
    table."""
    out = cold.new_zeros((dst.cold_pad,) + tuple(cold.shape[1:]))
    to = torch.from_numpy(dst._perm()[:dst.cold]).to(cold.device)
    frm = torch.from_numpy(src._perm()[:src.cold]).to(cold.device)
    out[to] = cold[frm]
    return out


def _prefix_placement(v: int, n: int, hot_frac: float) -> VocabPlacement:
    return VocabPlacement(
        vocab_size=v, hot=max(1, min(int(round(hot_frac * v)), v - 1)),
        n_shards=n)


def _size(mesh) -> int:
    return 1 if mesh is None else mesh.size


def _device(device, mesh, like=None) -> torch.device:
    """Where an index lives: ``device`` when given (resolved as a
    session's: the GPU unless the CPU is asked for by name, raising
    without one), else the mesh's device, else the tensor ``like``'s,
    else the GPU."""
    from repro_torch.core.trainer import resolve_device
    if device is None and mesh is not None:
        return mesh.device
    if device is None and isinstance(like, torch.Tensor):
        return like.device
    return resolve_device(device)


def _block(t, placement: VocabPlacement, mesh):
    """This rank's rows of a shard-major ``(cold_pad, ...)`` table; a
    table that already has ``cold_per_shard`` rows is the rank's block."""
    if t is None or _size(mesh) == 1 or \
            t.shape[0] == placement.cold_per_shard:
        return t
    cps = placement.cold_per_shard
    return t[mesh.rank * cps:(mesh.rank + 1) * cps]


def _on(t, device) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(device)
    return torch.as_tensor(np.asarray(t), device=device)


@dataclasses.dataclass
class EmbeddingIndex:
    """Pre-normalized, rank-resident input-embedding table + its layout.

    ``hot`` is the replicated normalized head ``(hot, d)``; ``cold`` this
    rank's normalized block of the shard-major cold table (``(cold_pad,
    d)`` at one rank, ``(cold_per_shard, d)`` under a mesh of several).
    ``mesh`` is the serving :class:`~repro_torch.launch.mesh.DataMesh`
    (``None``: one rank). ``step`` records which checkpoint step the index
    was built from — the snapshot identity the hot-swap protocol flips on.
    """

    placement: VocabPlacement
    hot: torch.Tensor               # (hot, d) f32, rows L2-normalized
    cold: torch.Tensor              # this rank's cold rows, f32, normalized
    mesh: object = None
    step: Optional[int] = None
    extra: Dict = dataclasses.field(default_factory=dict)

    @property
    def vocab_size(self) -> int:
        """V — real vocabulary rows served."""
        return self.placement.vocab_size

    @property
    def dim(self) -> int:
        """d — embedding width."""
        return int(self.hot.shape[1])

    @property
    def n_shards(self) -> int:
        """Serving shard count (the mesh's ranks)."""
        return self.placement.n_shards

    @property
    def device(self) -> torch.device:
        return self.hot.device

    # -- construction --------------------------------------------------------
    @classmethod
    def load(cls, ckpt_dir: str, step: Optional[int] = None,
             mesh=None, hot_frac: float = SERVE_HOT_FRAC,
             device=None) -> "EmbeddingIndex":
        """Build an index from a checkpoint directory, on ``device`` (the
        mesh's device under a mesh; the GPU unless ``device="cpu"``).

        ``peek`` decides the format: a split-table checkpoint restores
        ``hot_in``/``cold_in`` (and ``scale_in`` for an int8 tail),
        re-striped if the serving rank count differs from the writing
        run's; a replicated checkpoint restores ``w_in`` and splits it
        under a prefix-head placement (``hot_frac``). Raises
        ``FileNotFoundError`` with no usable checkpoint and
        ``CorruptCheckpoint``/``KeyError`` per the checkpoint layer's
        contract — the snapshot watcher catches these and keeps serving
        the previous snapshot.
        """
        from repro_torch.train import checkpoint as ckpt

        dev = _device(device, mesh)
        if step is None:
            step = ckpt.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        leaves, extra = ckpt.peek(ckpt_dir, step=step)
        n_serve = _size(mesh)

        def like(name):
            # the manifest is the dtype authority: int8/bf16 checkpoints
            # restore in their storage dtype, never assumed f32
            meta = leaves[name]
            return ckpt.ArraySpec(tuple(meta["shape"]), meta["dtype"])

        scale = None
        if "hot_in" in leaves:
            src = VocabPlacement.from_extra(extra["vocab_shard"])
            names = ["hot_in", "cold_in"]
            if "scale_in" in leaves:     # int8 cold tail: per-row scales
                names.append("scale_in")
            tree, _ = ckpt.restore(ckpt_dir, {n: like(n) for n in names},
                                   step=step, device=dev)
            hot, cold = tree["hot_in"], tree["cold_in"]
            scale = tree.get("scale_in")
            placement = src
            if n_serve != src.n_shards:
                placement = VocabPlacement(vocab_size=src.vocab_size,
                                           hot=src.hot, n_shards=n_serve)
                cold = _restripe(cold, src, placement)
                if scale is not None:
                    scale = _restripe(scale, src, placement)
        else:
            tree, _ = ckpt.restore(ckpt_dir, {"w_in": like("w_in")},
                                   step=step, device=dev)
            full = tree["w_in"].to(torch.float32)         # bf16 ckpts
            placement = _prefix_placement(full.shape[0], n_serve, hot_frac)
            hot, cold = _split(full, placement)
        return cls._stage(placement, hot, cold, mesh, step=step, extra=extra,
                          scale=scale, device=dev)

    @classmethod
    def from_session(cls, session, mesh=None,
                     hot_frac: float = SERVE_HOT_FRAC) -> "EmbeddingIndex":
        """Index the live input table of a port ``TrainSession``, on its
        device and mesh. A vocab-sharded session hands over its hot head
        and this rank's cold block in storage dtype (int8 with its
        scales), which dequantize once at staging — no gather across
        ranks; a replicated session's table is split under a prefix-head
        placement."""
        from repro_torch.kernels import quant

        st = session.state
        mesh = mesh if mesh is not None else session.mesh
        spec = session.spec
        hot = quant.decode(st.w_in, None, spec.hot_dtype)
        scale = None
        if session.placement is None:
            placement = _prefix_placement(hot.shape[0], _size(mesh),
                                          hot_frac)
            hot, cold = _split(hot, placement)
        else:
            placement = session.placement
            cold, scale = st.cold_in, st.scale_in
        return cls._stage(placement, hot, cold, mesh,
                          step=st.batches_seen, scale=scale,
                          device=st.w_in.device)

    @classmethod
    def _stage(cls, placement: VocabPlacement, hot, cold, mesh=None,
               step: Optional[int] = None, extra: Optional[Dict] = None,
               scale=None, device=None) -> "EmbeddingIndex":
        """Place + normalize the split tables on the device (the staging
        half of a hot swap: the new snapshot is resident before the
        serving pointer flips). ``hot``/``cold``/``scale`` are tensors or
        numpy; ``cold`` is the shard-major cold table or this rank's
        block of it. Quantized tables arrive in storage dtype (int8 cold
        rows with their per-row ``scale``, or bf16) and dequantize exactly
        once here, after the host-to-device copy, so the copy moves the
        small quantized bytes. On the GPU the staging work is waited for
        before this returns."""
        from repro_torch.kernels import quant

        if _size(mesh) != placement.n_shards:
            raise ValueError(f"placement has {placement.n_shards} shards, "
                             f"the mesh {_size(mesh)} ranks")
        dev = _device(device, mesh, hot)
        hot_dev = _on(hot, dev).to(torch.float32)
        cold_dev = _on(_block(cold, placement, mesh), dev)
        if scale is not None:
            scale_dev = _on(_block(scale, placement, mesh), dev)
            cold_dev = quant.int8_decode(cold_dev, scale_dev)
        # one buffer, the head then the block: the query scores both in
        # one product without copying them together
        h = placement.hot
        table = torch.empty((h + cold_dev.shape[0], hot_dev.shape[1]),
                            dtype=torch.float32, device=dev)
        table[:h] = _normalize(hot_dev)
        table[h:] = _normalize(cold_dev.to(torch.float32))
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()  # staged, not lazy
        return cls(placement=placement, hot=table[:h], cold=table[h:],
                   mesh=mesh, step=step, extra=dict(extra or {}))

    # -- oracle access -------------------------------------------------------
    def dense_embeddings(self) -> np.ndarray:
        """The merged normalized ``(V, d)`` table as numpy — **oracle/test
        path only** (parity reference for
        :func:`repro_torch.serve.query.dense_topk`); the serving path
        never materializes this. Under a mesh of several ranks it
        all-gathers the cold blocks: a collective every rank calls."""
        cold = self.cold
        if _size(self.mesh) > 1:
            from repro_torch.distributed import collectives as coll
            cold = coll.all_gather(cold, self.mesh).reshape(
                -1, cold.shape[1])
        return self.placement.merge(self.hot.cpu().numpy(),
                                    cold.cpu().numpy())


def _split(full: torch.Tensor, placement: VocabPlacement):
    """``placement.split`` for a tensor, on its device."""
    cold = torch.zeros((placement.cold_pad,) + tuple(full.shape[1:]),
                       dtype=full.dtype, device=full.device)
    pos = torch.from_numpy(placement._perm()[:placement.cold]).to(
        full.device)
    cold[pos] = full[placement.hot:]
    return full[:placement.hot], cold
