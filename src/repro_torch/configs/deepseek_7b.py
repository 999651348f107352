"""deepseek-7b [dense]: 30L d_model=4096 32H (kv=32) d_ff=11008 vocab=102400,
llama-arch. [arXiv:2401.02954; hf]"""

from repro_torch.configs import base


@base.register("deepseek-7b")
def config() -> base.ModelConfig:
    return base.ModelConfig(
        name="deepseek-7b",
        family="dense",
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=11008,
        vocab_size=102400,
        source="arXiv:2401.02954; hf",
    )
