"""The plain reference's frontend finds a detector other than SURF by name, as
a file of its own, and matches ORB and AKAZE by Hamming distance as the
port does."""

import sys
import types

import pytest
import torch

from ergo_uvo_tpu_torch.config import MonoVOConfig
from ergo_uvo_tpu_torch.features import frontend as port_frontend
from uvo_bench.reference import config as ref_config
from uvo_bench.reference.features import frontend

AKAZE = "uvo_bench.reference.features.akaze"


def test_a_detector_other_than_surf_reaches_its_own_file(monkeypatch):
    calls = []
    stub = types.ModuleType(AKAZE)
    stub.detect_and_describe_cfg = lambda img, cfg: calls.append((img, cfg)) or "found"
    monkeypatch.setitem(sys.modules, AKAZE, stub)
    cfg = ref_config.MonoVOConfig(feature_detector="AKAZE")
    img = torch.zeros(8, 8)
    assert frontend.detect_and_describe_cfg(img, cfg) == "found"
    assert calls == [(img, cfg)]
    assert frontend.is_binary(cfg)


def test_a_detector_without_its_file_raises_naming_it(monkeypatch):
    monkeypatch.delitem(sys.modules, AKAZE, raising=False)
    cfg = ref_config.MonoVOConfig(feature_detector="akaze")
    with pytest.raises(NotImplementedError, match="akaze.py"):
        frontend.detect_and_describe_cfg(torch.zeros(8, 8), cfg)


@pytest.mark.parametrize("name", ["SURF", "SIFT", "ORB", "AKAZE", "orb"])
def test_is_binary_follows_the_ports_rule(name):
    assert frontend.is_binary(ref_config.MonoVOConfig(feature_detector=name)) == \
        port_frontend.is_binary(MonoVOConfig(feature_detector=name))
