"""The port's configs are the JAX package's, field for field."""

import dataclasses

import pytest
import torch

from repro import configs as jcfg
from repro_torch import configs as tcfg

ARCH_NAMES = sorted(jcfg.ARCHS)


def test_same_archs_and_shapes():
    assert sorted(tcfg.ARCHS) == ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_fields_equal(arch, smoke):
    name = arch + ("-smoke" if smoke else "")
    assert dataclasses.asdict(tcfg.get_arch(name)) == dataclasses.asdict(
        jcfg.get_arch(name))
    assert tcfg.get_arch(name).param_count() == jcfg.get_arch(name).param_count()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_applicable_equal(arch):
    for shape in jcfg.SHAPES:
        assert tcfg.applicable(tcfg.get_arch(arch), tcfg.get_shape(shape)) == \
            jcfg.applicable(jcfg.get_arch(arch), jcfg.get_shape(shape))


def test_torch_dtype():
    assert tcfg.get_arch("minitron-4b").torch_dtype == torch.bfloat16
    assert tcfg.get_arch("minitron-4b-smoke").torch_dtype == torch.float32
    with pytest.raises(KeyError):
        tcfg.get_arch("no-such-arch")
