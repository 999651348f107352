"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(dense ffn first 3L,
then MoE 1 shared + 256 routed top-8, expert d_ff=2048), vocab=129280, MLA.
MTP head omitted from serve path (DESIGN.md §8). [arXiv:2412.19437; hf]"""

from repro_torch.configs import base


@base.register("deepseek-v3-671b")
def config() -> base.ModelConfig:
    return base.ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=2048,
        vocab_size=129280,
        moe=base.MoESpec(num_experts=256, top_k=8, d_ff_expert=2048,
                         num_shared_experts=1, gating="sigmoid",
                         first_k_dense=3),
        mla=base.MLASpec(q_lora_rank=1536, kv_lora_rank=512, rope_dim=64,
                         nope_dim=128, v_head_dim=128),
        parallel=base.ParallelConfig(fsdp=True, optimizer_dtype="bfloat16"),
        source="arXiv:2412.19437; hf",
    )
