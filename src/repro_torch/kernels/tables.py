"""Precision-typed embedding tables: ``TableSpec`` + ``Tables``.

The port's counterpart of ``repro.kernels.tables``. ``TableSpec`` and the
``--tables`` grammar (:func:`parse`) are copied verbatim, so a spec string
means the same in both packages. The port runs every storage dtype,
replicated or vocab-sharded over any number of shards, one per rank;
:meth:`Tables.check_runnable` holds a rank's tables to the spec.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.quant import STORAGE_DTYPES, TORCH_DTYPES

_HOT_DTYPES = ("float32", "bfloat16")
_ALIASES = {"f32": "float32", "fp32": "float32", "float32": "float32",
            "bf16": "bfloat16", "bfloat16": "bfloat16",
            "int8": "int8", "i8": "int8"}


def _canon_dtype(name: str, *, hot: bool) -> str:
    dt = _ALIASES.get(name.strip().lower())
    allowed = _HOT_DTYPES if hot else STORAGE_DTYPES
    if dt is None or dt not in allowed:
        which = "hot" if hot else "cold"
        raise ValueError(
            f"unsupported {which}-table dtype {name!r}; choose from "
            f"{', '.join(allowed)} (int8 rows need per-row scales, which "
            f"only the striped cold tail carries)")
    return dt


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """How the embedding tables are stored and placed (static, hashable).

    ``hot_dtype`` covers the replicated tables — the full ``(V, d)`` pair
    of a replicated session, or the Zipf-hot head of a sharded one.
    ``cold_dtype`` covers the striped cold tail and therefore requires
    ``vocab_shard`` (int8 additionally carries per-row scales colocated
    with the cold shards). ``master_copy`` opts into the f32 master-copy
    fallback for backends whose kernels can't consume the storage dtype:
    tables dequantize to f32 around the *unmodified* f32 step and
    re-encode stochastically after — correct everywhere, but it forfeits
    the exchange-byte and working-set wins (the quantized form then only
    pays off in HBM capacity and checkpoints).
    """
    hot_dtype: str = "float32"
    cold_dtype: str = "float32"
    hot_frac: float = 0.0
    vocab_shard: bool = False
    exchange: str = "exact"
    master_copy: bool = False
    shards: int = 0        # CLI device-count hint; 0 = mesh/legacy flag

    def __post_init__(self):
        """Validate dtype/placement/exchange combinations eagerly."""
        if self.hot_dtype not in _HOT_DTYPES:
            raise ValueError(
                f"hot_dtype {self.hot_dtype!r} not in {_HOT_DTYPES}")
        if self.cold_dtype not in STORAGE_DTYPES:
            raise ValueError(
                f"cold_dtype {self.cold_dtype!r} not in {STORAGE_DTYPES}")
        if self.exchange not in ("exact", "dense"):
            raise ValueError(
                f"exchange must be 'exact' or 'dense', got {self.exchange!r}")
        if self.cold_dtype != "float32" and not self.vocab_shard:
            raise ValueError(
                f"cold_dtype={self.cold_dtype!r} requires vocab_shard=True: "
                f"the cold tail (and its per-row scales) only exists under "
                f"a vocab-sharded placement — pass shards in --tables "
                f"(e.g. 'cold=int8,shards=4') or set cfg.vocab_shard")

    # -- derived views -------------------------------------------------------
    @property
    def is_mixed(self) -> bool:
        """Any table stored below f32 (round keys + requant paths on)."""
        return self.hot_dtype != "float32" or self.cold_dtype != "float32"

    @property
    def dtypes(self) -> Tuple[str, ...]:
        """Distinct storage dtypes, for registry capability resolution."""
        out = [self.hot_dtype]
        if self.vocab_shard and self.cold_dtype not in out:
            out.append(self.cold_dtype)
        return tuple(out)

    @property
    def needs_scales(self) -> bool:
        """Whether per-row int8 scales ride with the cold shards."""
        return self.vocab_shard and self.cold_dtype == "int8"

    # -- checkpoint metadata -------------------------------------------------
    def to_extra(self) -> Dict:
        """Checkpoint-manifest metadata (see ``from_extra``)."""
        return {"hot_dtype": self.hot_dtype, "cold_dtype": self.cold_dtype,
                "hot_frac": self.hot_frac, "vocab_shard": self.vocab_shard,
                "exchange": self.exchange, "master_copy": self.master_copy}

    @classmethod
    def from_extra(cls, extra: Dict) -> "TableSpec":
        """Rebuild the writing run's spec from checkpoint metadata
        (missing keys default to f32 — legacy checkpoints)."""
        return cls(hot_dtype=str(extra.get("hot_dtype", "float32")),
                   cold_dtype=str(extra.get("cold_dtype", "float32")),
                   hot_frac=float(extra.get("hot_frac", 0.0)),
                   vocab_shard=bool(extra.get("vocab_shard", False)),
                   exchange=str(extra.get("exchange", "exact")),
                   master_copy=bool(extra.get("master_copy", False)))


def parse(spec: str, *, vocab_shard: bool = False,
          hot_frac: float = 0.0) -> TableSpec:
    """Parse the ``--tables`` surface into a :class:`TableSpec`.

    Grammar: comma-separated clauses, each ``key=value`` with optional
    colon-joined sub-options — e.g. ``hot=bf16:frac=0.1,cold=int8``,
    ``cold=int8,shards=4,exchange=dense``, ``hot=bf16:master=1``.
    Recognized clauses: ``hot=<f32|bf16>[:frac=F][:master=0|1]``,
    ``cold=<f32|bf16|int8>`` (implies vocab sharding), ``shards=N``,
    ``exchange=<exact|dense>``, ``master=0|1``. ``vocab_shard`` /
    ``hot_frac`` seed the defaults from the legacy config knobs so
    ``--vocab-shard``/``--hot-vocab-frac`` keep working underneath.
    """
    kw = dict(vocab_shard=vocab_shard, hot_frac=hot_frac)
    for clause in filter(None, (c.strip() for c in spec.split(","))):
        key, sep, rest = clause.partition("=")
        key = key.strip().lower()
        if not sep:
            raise ValueError(f"--tables clause {clause!r} is not key=value "
                             f"(expected e.g. hot=bf16:frac=0.1,cold=int8)")
        value, *opts = rest.split(":")
        if key == "hot":
            kw["hot_dtype"] = _canon_dtype(value, hot=True)
        elif key == "cold":
            kw["cold_dtype"] = _canon_dtype(value, hot=False)
            kw["vocab_shard"] = True
        elif key == "shards":
            kw["shards"] = int(value)
            kw["vocab_shard"] = kw["shards"] >= 1
        elif key == "exchange":
            kw["exchange"] = value.strip().lower()
        elif key == "master":
            kw["master_copy"] = value.strip() not in ("0", "false", "")
        else:
            raise ValueError(
                f"unknown --tables clause {key!r}; recognized: hot, cold, "
                f"shards, exchange, master")
        for opt in opts:
            okey, _, oval = opt.partition("=")
            okey = okey.strip().lower()
            if key == "hot" and okey == "frac":
                kw["hot_frac"] = float(oval)
            elif okey == "master":
                kw["master_copy"] = oval.strip() not in ("0", "false", "")
            else:
                raise ValueError(
                    f"unknown --tables sub-option {opt!r} on {key}= "
                    f"(recognized: frac= on hot=, master=)")
    return TableSpec(**kw)


def from_config(cfg) -> TableSpec:
    """The session's TableSpec: ``cfg.tables`` when set (legacy
    ``vocab_shard``/``hot_vocab_frac`` knobs seed its defaults), else a
    pure-f32 spec derived from the legacy knobs."""
    if getattr(cfg, "tables", ""):
        return parse(cfg.tables, vocab_shard=cfg.vocab_shard,
                     hot_frac=cfg.hot_vocab_frac)
    return TableSpec(vocab_shard=cfg.vocab_shard,
                     hot_frac=cfg.hot_vocab_frac)


@dataclasses.dataclass
class Tables:
    """The table tensors one engine step updates in place.

    Replicated sessions hold the full ``(V, d)`` pair in ``w_in``/
    ``w_out``, stored in ``spec.hot_dtype``. Vocab-sharded sessions hold
    the replicated hot head there instead and the striped ``(cold_pad,
    d)`` tail in ``cold_in``/``cold_out`` (stored in ``spec.cold_dtype``),
    and for an int8 tail its per-row f32 scales in ``scale_in``/
    ``scale_out``, striped like the cold rows); ``placement`` (a
    ``repro_torch.distributed.vocab_placement.VocabPlacement``) describes
    the split. A rank of a sharded mesh holds its stripe of the tail,
    ``placement.cold_per_shard`` rows (one shard: all ``cold_pad``)."""
    w_in: torch.Tensor
    w_out: torch.Tensor
    cold_in: Optional[torch.Tensor] = None
    cold_out: Optional[torch.Tensor] = None
    scale_in: Optional[torch.Tensor] = None
    scale_out: Optional[torch.Tensor] = None
    spec: TableSpec = TableSpec()
    placement: Optional[object] = None

    def check_runnable(self) -> None:
        """Raise unless the port can run ``spec``: tables in the spec's
        storage dtypes, replicated, or vocab-sharded with the placement
        and this shard's stripe of the cold tail (and its int8 scales):
        ``placement.cold_per_shard`` rows."""
        sharded = self.placement is not None
        has_cold = self.cold_in is not None and self.cold_out is not None
        if self.spec.vocab_shard != sharded or has_cold != sharded:
            raise ValueError(
                f"TableSpec.vocab_shard={self.spec.vocab_shard} but the "
                f"tables carry placement={self.placement!r} and "
                f"{'cold tables' if has_cold else 'no cold tables'}; a "
                f"vocab-sharded spec needs both, a replicated one neither")
        has_scales = self.scale_in is not None and self.scale_out is not None
        if has_scales != self.spec.needs_scales:
            raise ValueError(
                f"TableSpec(cold_dtype={self.spec.cold_dtype!r}) "
                f"{'needs' if self.spec.needs_scales else 'takes no'} "
                f"per-row int8 scales, but the tables carry "
                f"{'them' if has_scales else 'none'}")
        if sharded:
            cps = self.placement.cold_per_shard
            for name in ("cold_in", "cold_out", "scale_in", "scale_out"):
                t = getattr(self, name)
                if t is not None and t.shape[0] != cps:
                    raise ValueError(
                        f"{name} has {t.shape[0]} rows but a shard of a "
                        f"placement over {self.placement.n_shards} holds "
                        f"cold_per_shard={cps}")
        want = {"w_in": self.spec.hot_dtype, "w_out": self.spec.hot_dtype,
                "cold_in": self.spec.cold_dtype,
                "cold_out": self.spec.cold_dtype,
                "scale_in": "float32", "scale_out": "float32"}
        for name, dtype in want.items():
            t = getattr(self, name)
            if t is not None and t.dtype != TORCH_DTYPES[dtype]:
                raise ValueError(f"{name} is stored as {t.dtype} but the "
                                 f"TableSpec stores it as {dtype}")
