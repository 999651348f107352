"""Set-up: from the process's start to the window's opening (weights
made, sealed, unsealed, attested; the engine built and warmed; the
pre-roll of arrivals)."""


def read(run):
    return run.setup_s
