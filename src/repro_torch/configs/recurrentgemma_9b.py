"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2 [arXiv:2402.19427].

38 layers = 12 × (RG-LRU, RG-LRU, local-attn w=2048) + 2 trailing RG-LRU.
MQA (kv=1).  Constant-state recurrent layers + ring-buffer local attention
make this a long_500k arch.
"""
from repro_torch.configs.base import LayerGroup, LayerSpec, ModelConfig

ARCH = "recurrentgemma-9b"

WINDOW = 2048


def config() -> ModelConfig:
    rec = LayerSpec(mixer="rglru", ffn="dense")
    attn = LayerSpec(mixer="attn", ffn="dense", window=WINDOW)
    return ModelConfig(
        name=ARCH,
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab_size=256000,
        lru_width=4096,
        groups=(
            LayerGroup((rec, rec, attn), 12),
            LayerGroup((rec, rec), 1),
        ),
        param_dtype="bfloat16",
        fsdp_params=True,
        act_seq_shard=True,
        loss_chunk=512,
        optimizer="adamw",
        learning_rate=1.5e-4,
    )


def reduced() -> ModelConfig:
    rec = LayerSpec(mixer="rglru", ffn="dense")
    attn = LayerSpec(mixer="attn", ffn="dense", window=8)
    return config().replace(
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        lru_width=64,
        groups=(LayerGroup((rec, rec, attn), 1),),
        param_dtype="float32",
        fsdp_params=False,
        act_seq_shard=False,
        loss_chunk=0,
        remat="none",
        compute_dtype="float32",
    )
