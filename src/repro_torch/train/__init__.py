"""Training (port of ``repro.train``): AdamW, the train step with
microbatch accumulation, the loop, and sealable checkpoints that restore
in either package."""
