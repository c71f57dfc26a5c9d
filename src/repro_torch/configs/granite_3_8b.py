"""granite-3-8b [dense] — GQA kv=8 [hf:ibm-granite/granite-3.0]."""
from repro_torch.configs.base import LayerGroup, LayerSpec, ModelConfig

ARCH = "granite-3-8b"


def config() -> ModelConfig:
    spec = LayerSpec(mixer="attn", ffn="dense")
    return ModelConfig(
        name=ARCH,
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
        groups=(LayerGroup((spec,), 40),),
        param_dtype="bfloat16",
        fsdp_params=True,
        act_seq_shard=True,
        loss_chunk=1024,
        optimizer="adamw",
        learning_rate=1.5e-4,
    )


def reduced() -> ModelConfig:
    spec = LayerSpec(mixer="attn", ffn="dense")
    return config().replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        groups=(LayerGroup((spec,), 2),),
        param_dtype="float32",
        fsdp_params=False,
        act_seq_shard=False,
        loss_chunk=0,
        remat="none",
        compute_dtype="float32",
    )
