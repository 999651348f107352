"""whisper-small [audio]: enc-dec, 12L(+12L dec) d_model=768 12H d_ff=3072
vocab=51865. Conv frontend is a STUB: input_specs feed precomputed frame
embeddings. [arXiv:2212.04356; unverified]"""

from repro_torch.configs import base


@base.register("whisper-small")
def config() -> base.ModelConfig:
    return base.ModelConfig(
        name="whisper-small",
        family="encdec",
        num_layers=12,
        encoder_layers=12,
        decoder_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        max_target_len=448,
        embedding_inputs=True,     # encoder consumes precomputed frames
        rope_theta=10000.0,        # (whisper uses sinusoidal; rope as stand-in)
        sub_quadratic=False,
        source="arXiv:2212.04356; unverified",
    )
