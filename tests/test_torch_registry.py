"""The port's backend registry resolves like the reference's, with the GPU
in place of the TPU and the names mapped: torch<->jnp,
torch_tiled<->jnp_tiled, cuda<->pallas, cuda_pipelined<->pallas_pipelined,
cuda_tiled<->pallas_tiled. The ``--tables`` grammar parses alike."""
import dataclasses
import itertools
import warnings

import pytest

from repro.kernels import registry as ref_registry
from repro.kernels import tables as ref_tables
from repro_torch.kernels import registry, tables

TO_REF = {"torch": "jnp", "torch_tiled": "jnp_tiled", "cuda": "pallas",
          "cuda_pipelined": "pallas_pipelined", "cuda_tiled": "pallas_tiled",
          "auto": "auto"}
PLATFORMS = {"cuda": "tpu", "cpu": "cpu"}
DTYPES = [(), ("float32",), ("bfloat16",), ("int8",), ("float32", "int8")]
FRONTENDS = [(), ("static_ctx",), ("bags",), ("static_ctx", "bags")]


def _outcome(resolve, name, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            got = resolve(name, **kw).name
        except ValueError:
            got = "ValueError"
    return got, bool(caught)


@pytest.mark.parametrize("name", sorted(TO_REF))
def test_resolve_accepts_and_rejects_like_reference(name):
    for tiled, vshard, dtypes, fe, plat in itertools.product(
            (False, True), (False, True), DTYPES, FRONTENDS, PLATFORMS):
        kw = dict(tiled=tiled, vocab_shard=vshard, dtypes=dtypes,
                  frontends=fe)
        got, warned = _outcome(registry.resolve, name, platform=plat, **kw)
        want, ref_warned = _outcome(ref_registry.resolve, TO_REF[name],
                                    platform=PLATFORMS[plat], **kw)
        mapped = TO_REF.get(got, got)
        assert (mapped, warned) == (want, ref_warned), (name, kw, plat)


def test_auto_on_cpu_is_the_plain_versions():
    assert registry.resolve("auto", platform="cpu").name == "torch"
    assert registry.resolve("auto", tiled=True,
                            platform="cpu").name == "torch_tiled"


def test_auto_on_the_gpu_is_the_kernels():
    assert registry.resolve("auto", platform="cuda").name == "cuda_pipelined"
    assert registry.resolve("auto", tiled=True,
                            platform="cuda").name == "cuda_tiled"
    assert registry.resolve("auto", vocab_shard=True,
                            platform="cuda").name == "cuda"


@pytest.mark.parametrize("name", ["cuda", "cuda_pipelined", "cuda_tiled"])
def test_cuda_backends_raise_on_cpu(name):
    with pytest.raises(ValueError, match="only on the GPU"):
        registry.resolve(name, tiled=name == "cuda_tiled", platform="cpu")


def test_names_and_cli_choices():
    assert registry.names() == ["torch", "cuda", "cuda_pipelined",
                                "torch_tiled", "cuda_tiled"]
    assert registry.cli_choices() == ["auto"] + registry.names()
    with pytest.raises(ValueError, match="unknown backend"):
        registry.get("pallas")


@pytest.mark.parametrize("spec", [
    "", "hot=bf16:frac=0.1,cold=int8", "cold=int8,shards=4,exchange=dense",
    "hot=bf16:master=1", "shards=2", "hot=f32", "master=1", "bogus=1",
    "hot=int8", "cold=bf16:frac=0.1", "hot", "exchange=weird"])
def test_table_spec_grammar_matches_reference(spec):
    def parsed(mod):
        try:
            return dataclasses.asdict(mod.parse(spec))
        except ValueError:
            return "ValueError"

    assert parsed(tables) == parsed(ref_tables)
