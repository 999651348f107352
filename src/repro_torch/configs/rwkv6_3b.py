"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536.
Finch data-dependent decay. Constant state -> long_500k RUNS.
[arXiv:2404.05892; hf]"""

from repro_torch.configs import base


@base.register("rwkv6-3b")
def config() -> base.ModelConfig:
    return base.ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        num_layers=32,
        d_model=2560,
        num_heads=40,          # 2560 / 64 rwkv heads
        num_kv_heads=40,
        d_ff=8960,
        vocab_size=65536,
        ssm=base.SSMSpec(kind="rwkv6", head_dim=64, lora_rank=64),
        sub_quadratic=True,
        source="arXiv:2404.05892; hf",
    )
