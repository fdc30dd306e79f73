"""Host serving: how long a caller waits where the host paces it, the
95th percentile (linear interpolation) of every request's time from its
dispatch to its answer over the traced window; a request is one batch
(host clock). The end-to-end tail of a cell whose card is busy for at
least half the window would be an end-to-end metric of its own."""

import numpy as np


def read(run):
    lat = [r[3] for r in run.served]
    if not lat:
        return None
    return float(np.percentile(np.array(lat) * 1e3, 95))
