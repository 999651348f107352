"""The paper's own models: Llama2 7B / 13B / 70B (Touvron et al. 2023).

These are what the paper actually ran inside TDX/SGX/cGPU; the benchmark
layer measures reduced-scale versions of these, and the dry-run can lower the
full ones like any assigned arch.
"""

from repro_torch.configs import base


@base.register("llama2-7b")
def llama2_7b() -> base.ModelConfig:
    return base.ModelConfig(
        name="llama2-7b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
        d_ff=11008, vocab_size=32000,
        source="arXiv:2307.09288; hf",
    )


@base.register("llama2-13b")
def llama2_13b() -> base.ModelConfig:
    return base.ModelConfig(
        name="llama2-13b", family="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=40,
        d_ff=13824, vocab_size=32000,
        source="arXiv:2307.09288; hf",
    )


@base.register("llama2-70b")
def llama2_70b() -> base.ModelConfig:
    return base.ModelConfig(
        name="llama2-70b", family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=28672, vocab_size=32000,
        parallel=base.ParallelConfig(fsdp=True),
        source="arXiv:2307.09288; hf",
    )
