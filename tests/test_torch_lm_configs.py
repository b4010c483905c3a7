"""The port's LM configs (``repro_torch.configs``) against the reference's
(``repro.configs``): the registry, the dry-run cells, every arch's full and
smoke config field by field, and the analytic parameter counts."""
import dataclasses

import pytest

import repro.configs as ref_configs
import repro.configs.base as ref_base
import repro_torch.configs as configs
from repro_torch.configs import base

ARCHS = ref_configs.list_archs()


def test_registry_and_cells_equal_the_reference():
    assert configs.list_archs() == ARCHS and len(ARCHS) == 10
    assert configs.cells() == ref_configs.cells()
    assert configs.cells(True) == ref_configs.cells(True)
    assert len(configs.cells(True)) > len(configs.cells())
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}


def test_defaults_equal_the_reference():
    """Every config class has the reference's fields and defaults."""
    for name in ("MoEConfig", "SSMConfig", "ArchConfig", "InputShape"):
        ours = [(f.name, f.default) for f in
                dataclasses.fields(getattr(base, name))]
        theirs = [(f.name, f.default) for f in
                  dataclasses.fields(getattr(ref_base, name))]
        assert ours == theirs, name


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_the_reference(arch, smoke):
    """The full and the smoke config field by field, their layer kinds and
    their analytic parameter counts (total and active)."""
    get, ref_get = ((configs.get_smoke, ref_configs.get_smoke) if smoke
                    else (configs.get_arch, ref_configs.get_arch))
    cfg, ref = get(arch), ref_get(arch)
    assert type(cfg).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.layer_kinds() == ref.layer_kinds()
    assert cfg.resolved_head_dim() == ref.resolved_head_dim()
    assert cfg.supports_long_context() == ref.supports_long_context()
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert 0 < cfg.active_param_count() <= cfg.param_count()
