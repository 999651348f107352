"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama-arch. [arXiv:2401.02954; hf]"""

import dataclasses

from repro_torch.configs import base


@base.register("deepseek-67b")
def config() -> base.ModelConfig:
    return base.ModelConfig(
        name="deepseek-67b",
        family="dense",
        num_layers=95,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=102400,
        parallel=base.ParallelConfig(fsdp=True),
        source="arXiv:2401.02954; hf",
    )
