"""Step metering: step time, throughput and MFU over a sliding window.

Port of StepMeter in kubeflow_tpu/runtime/metrics.py with the port's own
peak table. A device not in the table gets no MFU (None): there is no
default peak, so an unknown card is never measured against another's.
"""

from __future__ import annotations

import time
from collections import deque

# Dense bf16 tensor-core peak FLOP/s by torch.cuda.get_device_name()
# prefix (NVIDIA H100 data sheet, without sparsity): the SXM part
# reports as "NVIDIA H100 80GB HBM3".
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H100 SXM": 989e12,
    "NVIDIA H100 PCIe": 756e12,
}


def peak_flops(device_kind: str) -> float | None:
    for prefix, val in sorted(PEAK_FLOPS.items(), key=lambda kv: -len(kv[0])):
        if device_kind.startswith(prefix):
            return val
    return None


class StepMeter:
    """Step wall time, examples/sec and MFU over the last `window` steps,
    on one device. The caller synchronizes the device before stop()."""

    def __init__(self, flops_per_step: float, device_kind: str = "",
                 window: int = 20):
        self.flops_per_step = float(flops_per_step)
        self.peak = peak_flops(device_kind)
        self._times: deque[float] = deque(maxlen=window)
        self._t0: float | None = None
        self.steps = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        self.steps += 1
        self._t0 = None
        return dt

    @property
    def step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    def throughput(self, examples_per_step: int) -> float:
        return examples_per_step / self.step_time

    @property
    def achieved_flops(self) -> float:
        return self.flops_per_step / self.step_time

    @property
    def mfu(self) -> float | None:
        return self.achieved_flops / self.peak if self.peak else None
