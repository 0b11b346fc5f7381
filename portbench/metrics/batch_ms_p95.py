"""95th percentile of the batch period in ms: the host clock from one call
of the model's ``step`` to the next (the last batch: to the window's end),
over every batch of the window (numpy's linear percentile)."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.periods_s, 95)) * 1e3
