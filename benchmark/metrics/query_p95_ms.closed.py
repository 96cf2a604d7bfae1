"""The 95th percentile of the window's query times (encode and search, on
the client's clock), in ms. Under a closed loop this is mostly queueing
behind the other clients, so it reads the service's batching, not a
user's wait at a fixed rate."""

import numpy as np


def read(run):
    lat = run.data.get("latencies_s")
    if not lat:
        return None
    return 1e3 * float(np.percentile(lat, 95))
