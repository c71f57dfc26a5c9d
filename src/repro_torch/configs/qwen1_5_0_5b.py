"""qwen1.5-0.5b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import LayerGroup, LayerSpec, ModelConfig

ARCH = "qwen1.5-0.5b"


def config() -> ModelConfig:
    spec = LayerSpec(mixer="attn", ffn="dense")
    return ModelConfig(
        name=ARCH,
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        groups=(LayerGroup((spec,), 24),),
        loss_chunk=1024,
        optimizer="adamw",
        learning_rate=3e-4,
    )


def reduced() -> ModelConfig:
    spec = LayerSpec(mixer="attn", ffn="dense")
    return config().replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        groups=(LayerGroup((spec,), 2),),
        loss_chunk=0,
        remat="none",
        compute_dtype="float32",
    )
