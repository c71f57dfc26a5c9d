"""gemma3-27b [dense] — 5:1 local:global attention, 128k ctx [hf:google/gemma-3].

62 layers = 10 × (5 local(w=1024) + 1 global) + 2 trailing local layers.
The local majority is why this arch runs the long_500k cell: windowed layers
keep ring caches of 1024 regardless of context length.
"""
from repro_torch.configs.base import LayerGroup, LayerSpec, ModelConfig

ARCH = "gemma3-27b"

WINDOW = 1024


def config() -> ModelConfig:
    local = LayerSpec(mixer="attn", ffn="dense", window=WINDOW)
    glob = LayerSpec(mixer="attn", ffn="dense", window=None)
    return ModelConfig(
        name=ARCH,
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_ff=21504,
        vocab_size=262144,
        groups=(
            LayerGroup((local, local, local, local, local, glob), 10),
            LayerGroup((local, local), 1),
        ),
        param_dtype="bfloat16",
        fsdp_params=True,
        act_seq_shard=True,
        loss_chunk=512,
        optimizer="adamw",
        learning_rate=1e-4,
    )


def reduced() -> ModelConfig:
    local = LayerSpec(mixer="attn", ffn="dense", window=8)
    glob = LayerSpec(mixer="attn", ffn="dense", window=None)
    return config().replace(
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        groups=(LayerGroup((local, glob), 2),),
        param_dtype="float32",
        fsdp_params=False,
        act_seq_shard=False,
        loss_chunk=0,
        remat="none",
        compute_dtype="float32",
    )
