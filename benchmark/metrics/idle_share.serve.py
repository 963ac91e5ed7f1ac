"""Share of a request's time in which no operation ran on the device: 1 minus
the device's busy time a request (the union of the device rows' intervals
over the profiled requests, a mean a request) over the mean latency of the
window's requests, which run without the profiler (the profiler stretches
the host's time, and so the idle share, of the requests it traces)."""


def read(run):
    prof, lat = run["profile"], run["window"].get("latency_ms")
    if not prof or not prof.get("requests") or prof.get("busy_s", 0) <= 0 or not lat:
        return None
    busy_ms = 1e3 * prof["busy_s"] / prof["requests"]
    return 100.0 * (1.0 - busy_ms / (sum(lat) / len(lat)))
