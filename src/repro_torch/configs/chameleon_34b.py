"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536, early-fusion VQ image tokens (frontend stub: image tokens arrive
as ids in the shared vocab), qk-norm. [arXiv:2405.09818; unverified]"""

from repro_torch.configs import base


@base.register("chameleon-34b")
def config() -> base.ModelConfig:
    return base.ModelConfig(
        name="chameleon-34b",
        family="vlm",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65536,
        qk_norm=True,
        parallel=base.ParallelConfig(fsdp=True),
        source="arXiv:2405.09818; unverified",
    )
