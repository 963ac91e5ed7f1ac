"""Device operations launched a request (kernels, copies and fills), counted
in torch.profiler's device rows over the profiled requests."""


def read(run):
    prof = run["profile"]
    if not prof or not prof.get("requests") or not prof["launches"]:
        return None
    return prof["launches"] / prof["requests"]
