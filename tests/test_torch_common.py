"""The port's host-side decoder structures equal the reference's on every
library code: TannerGraph, layerize, build_layers (F, L, S, and the
cross-wired layer_compat layers), and DecoderConfig's fields."""

import dataclasses

import numpy as np
import pytest

from qldpcsim_tpu.codes import CODE_REGISTRY, get_code
from qldpcsim_tpu.decoders import common as ref

from qldpcsim_torch.decoders import common as port

CODES = sorted(CODE_REGISTRY)


def _same_dataclass(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert va.dtype == vb.dtype and va.shape == vb.shape, f.name
        assert np.array_equal(va, vb), f.name


@pytest.mark.parametrize("name", CODES)
def test_tanner_graph_and_layers_equal_reference(name):
    code = get_code(name)
    Hx, Hz = np.asarray(code.Hx) % 2, np.asarray(code.Hz) % 2
    for H in (Hx, Hz):
        _same_dataclass(ref.TannerGraph.build(H), port.TannerGraph.build(H))
        for serial in (False, True):
            a, b = ref.layerize(H, serial=serial), port.layerize(H, serial=serial)
            assert len(a) == len(b)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for sched in ("F", "L", "S"):
        for H_dec, H_lay in ((Hz, None), (Hx, None), (Hz, Hx), (Hx, Hz)):
            _same_dataclass(ref.build_layers(H_dec, sched, H_layerize=H_lay),
                            port.build_layers(H_dec, sched, H_layerize=H_lay))


def test_build_layers_rejects_unknown_schedule():
    with pytest.raises(ValueError):
        port.build_layers(np.eye(4, dtype=np.int8), "X")


def test_decoder_config_defaults_match_reference():
    r, p = ref.DecoderConfig(), port.DecoderConfig()
    port_fields = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    for name, value in port_fields.items():
        assert getattr(r, name) == value, name
