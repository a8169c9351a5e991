"""The device side of one step, by ``torch.profiler``: shared by the
``profile_*`` tools.

``device_profile(step, top)`` runs ``step()`` once under the profiler,
bracketed by ``torch.cuda.synchronize``, and returns ``step``'s result
and a report: the step's wall time, the device-busy time (the sum of the
CUDA kernels' and copies' device time), the device's idle share of the
wall time, and the ``top`` entries with the most device time.  Where the
profiler records no device event, the busy time and the idle share read
"not measured".  Needs a CUDA card.
"""

from __future__ import annotations

import collections
import time

import torch


def device_profile(step, top: int):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kern[e.name][0] += e.time_range.elapsed_us() / 1e3
            kern[e.name][1] += 1
    busy = sum(v[0] for v in kern.values())
    ranked = sorted(kern.items(), key=lambda kv: -kv[1][0])[:top]
    return out, {
        "wall_ms": round(wall, 3),
        "device_busy_ms": round(busy, 4) if kern else "not measured",
        "idle_share": round(1 - busy / wall, 5) if kern else "not measured",
        "kernels": {name[:60]: {"ms": round(ms, 4), "count": c}
                    for name, (ms, c) in ranked},
    }
