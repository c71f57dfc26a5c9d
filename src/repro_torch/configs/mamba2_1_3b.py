"""mamba2-1.3b [ssm] — SSD, attention-free [arXiv:2405.21060].

48L d_model=2048, no FFN (the Mamba-2 block is the whole layer),
vocab=50280, ssm_state=128, expand=2 (d_inner 4096, 64 heads × P=64).
"""
from repro_torch.configs.base import LayerGroup, LayerSpec, ModelConfig

ARCH = "mamba2-1.3b"


def config() -> ModelConfig:
    spec = LayerSpec(mixer="mamba2", ffn="none")
    return ModelConfig(
        name=ARCH,
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=32,          # unused by the SSD mixer
        n_kv_heads=32,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_groups=1,
        ssm_chunk=256,
        groups=(LayerGroup((spec,), 48),),
        loss_chunk=1024,
        optimizer="adamw",
        learning_rate=2e-4,
    )


def reduced() -> ModelConfig:
    spec = LayerSpec(mixer="mamba2", ffn="none")
    return config().replace(
        n_layers=2,
        d_model=64,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=16,
        groups=(LayerGroup((spec,), 2),),
        loss_chunk=0,
        remat="none",
        compute_dtype="float32",
    )
