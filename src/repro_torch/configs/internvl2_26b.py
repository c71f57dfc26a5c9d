"""internvl2-26b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

The ViT frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed patch embeddings (B, 256, d_model); a learned projector maps
them into the LM stream.  The graded backbone is the 48L InternLM2 trunk.
"""
from repro_torch.configs.base import LayerGroup, LayerSpec, ModelConfig

ARCH = "internvl2-26b"


def config() -> ModelConfig:
    spec = LayerSpec(mixer="attn", ffn="dense")
    return ModelConfig(
        name=ARCH,
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=92553,
        n_vision_tokens=256,
        groups=(LayerGroup((spec,), 48),),
        param_dtype="bfloat16",
        fsdp_params=True,
        act_seq_shard=True,
        loss_chunk=512,
        optimizer="adamw",
        learning_rate=1e-4,
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
        n_vision_tokens=4,
        groups=(LayerGroup((spec,), 2),),
        param_dtype="float32",
        fsdp_params=False,
        act_seq_shard=False,
        loss_chunk=0,
        remat="none",
        compute_dtype="float32",
    )
