"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16e top-4 fine-grained. [hf:databricks/dbrx-base; unverified]"""

from repro_torch.configs import base


@base.register("dbrx-132b")
def config() -> base.ModelConfig:
    return base.ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab_size=100352,
        moe=base.MoESpec(num_experts=16, top_k=4, d_ff_expert=10752),
        parallel=base.ParallelConfig(fsdp=True),
        source="hf:databricks/dbrx-base; unverified",
    )
