"""$/Mtoken cost model over a hardware and pricing catalog (port of
``repro.costs``)."""
