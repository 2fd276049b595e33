"""The 95th percentile of every request's latency in the window: from the
request's issue until its picks are in host memory, on the device's clock
(CUDA events)."""

import numpy as np


def read(w):
    if not w.latencies_ms:
        return None
    return float(np.percentile(np.asarray(w.latencies_ms), 95))
