"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060, hf]."""
from repro_torch.configs.base import LayerGroup, LayerSpec, ModelConfig

ARCH = "olmoe-1b-7b"


def config() -> ModelConfig:
    spec = LayerSpec(mixer="attn", ffn="moe")
    return ModelConfig(
        name=ARCH,
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=0,
        d_ff_expert=1024,
        n_experts=64,
        top_k=8,
        vocab_size=50304,
        groups=(LayerGroup((spec,), 16),),
        fsdp_params=True,
        moe_impl="ep",       # gather impl costs ~1.1 TB/dev temp at this scale
        moe_token_chunks=4,
        loss_chunk=1024,
        optimizer="adamw",
        learning_rate=4e-4,
    )


def reduced() -> ModelConfig:
    spec = LayerSpec(mixer="attn", ffn="moe")
    return config().replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff_expert=32,
        n_experts=8,
        top_k=2,
        vocab_size=512,
        groups=(LayerGroup((spec,), 2),),
        fsdp_params=False,
        loss_chunk=0,
        remat="none",
        compute_dtype="float32",
    )
