"""Host seconds of ``TrustDomain.seal_params`` over the weights, ending
in a device synchronize."""


def read(run):
    return run.timings.get("seal_s")
