"""whisper-base [audio] — encoder-decoder, conv frontend stubbed [arXiv:2212.04356].

6 encoder + 6 decoder layers, d_model=512, 8 heads, GELU MLP, sinusoidal
positions (no RoPE).  ``input_specs()`` provides precomputed frame
embeddings — the two stride-2 convs live outside the graded backbone.
long_500k is skipped (full-attention decoder).
"""
from repro_torch.configs.base import LayerGroup, LayerSpec, ModelConfig

ARCH = "whisper-base"


def config() -> ModelConfig:
    dec = LayerSpec(mixer="attn", ffn="dense", cross_attn=True)
    return ModelConfig(
        name=ARCH,
        family="audio",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        mlp_act="gelu",
        use_rope=False,
        is_encdec=True,
        n_enc_layers=6,
        groups=(LayerGroup((dec,), 6),),
        use_tp=False,        # 70M params: TP collectives dwarf compute (§Perf B1)
        act_seq_shard=True,  # idle model axis shards activations (§Perf B2p)
        loss_chunk=1024,
        optimizer="adamw",
        learning_rate=5e-4,
    )


def reduced() -> ModelConfig:
    dec = LayerSpec(mixer="attn", ffn="dense", cross_attn=True)
    return config().replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        n_enc_layers=2,
        groups=(LayerGroup((dec,), 2),),
        loss_chunk=0,
        remat="none",
        compute_dtype="float32",
    )
