"""The trace reduction on hand-made profiler events: busy time is the
union of the device's intervals, copies are not launches, and an idle
gap is named by the innermost informative host event running in it."""

import pytest
from torch.autograd import DeviceType

from chipbench.trace import reduce_events, short_name


class _Event:
    def __init__(self, start, end, name, device):
        self._start, self._end, self._name = start, end, name
        self._device = device

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def name(self):
        return self._name

    def device_type(self):
        return self._device


def test_reduce_events():
    gpu, cpu = DeviceType.CUDA, DeviceType.CPU
    s = reduce_events([
        _Event(0, 100, "void k1<2>(int*)", gpu),
        _Event(50, 150, "void k1<2>(int*)", gpu),
        _Event(300, 400, "Memcpy DtoD (Device -> Device)", gpu),
        _Event(140, 320, "aten::where", cpu),
        _Event(145, 330, "aten::add", cpu),
        _Event(160, 170, "cudaLaunchKernel", cpu),
        _Event(500, 600, "void k2(float*)", gpu),
    ], wall_s=1e-6)
    assert s["busy_s"] == pytest.approx(350e-9)
    assert s["device_ops"] == 4 and s["launches"] == 3
    assert s["by_name"]["void k1<2>(int*)"] == {"count": 2,
                                                "seconds": 200e-9}
    assert s["top_device_ops"][0] == ["k1<2>", 200e-9]
    assert dict(s["idle_gaps"]) == pytest.approx(
        {"aten::add": 150e-9, "host between ops (Python)": 100e-9})


def test_short_name():
    assert short_name("void (anonymous namespace)::fused_place_kernel<2, "
                      "16, 4>(float*, int)") == "fused_place_kernel<2, 16, 4>"
    assert short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
