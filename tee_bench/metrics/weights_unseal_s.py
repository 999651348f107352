"""Host seconds of ``TrustDomain.load_sealed`` (MAC, decrypt, unpack on
the card), ending in a device synchronize."""


def read(run):
    return run.timings.get("unseal_s")
