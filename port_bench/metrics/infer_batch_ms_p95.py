"""The 95th percentile (nearest rank) of every batch's latency in the
window: from the call until its top-5 classes are on the host."""
import math


def read(ctx):
    lat = sorted(ctx["window"]["latencies_ms"])
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
