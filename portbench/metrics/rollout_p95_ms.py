"""``rollout_p95_ms``: the 95th percentile of the latency of every call
in the window, from the call to its ``torch.cuda.synchronize()``."""

import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile(ctx.latencies, 95))
