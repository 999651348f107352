"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba+attn 1:7 interleave, MoE 16e top-2 every other layer.
Sub-quadratic (4/32 attention layers) -> long_500k RUNS. [arXiv:2403.19887; hf]"""

from repro_torch.configs import base


@base.register("jamba-v0.1-52b")
def config() -> base.ModelConfig:
    return base.ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        attn_period=8,   # layer i is attention iff i % 8 == 7 (1:7 ratio)
        moe_period=2,    # MoE FFN every 2nd layer
        moe=base.MoESpec(num_experts=16, top_k=2, d_ff_expert=14336),
        ssm=base.SSMSpec(kind="mamba", d_state=16, d_conv=4, expand=2),
        sub_quadratic=True,
        parallel=base.ParallelConfig(fsdp=True),
        source="arXiv:2403.19887; hf",
    )
