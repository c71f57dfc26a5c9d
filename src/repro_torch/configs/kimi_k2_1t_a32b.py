"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE (Kimi K2 paper table).

61L d_model=7168, 64H GQA kv=8 (per assignment; the paper's MLA is replaced
by GQA as specified), per-expert d_ff=2048, vocab=163840, 384 experts top-8.

Memory plan for the 512-chip dry-run: bf16 params + Adafactor (factored
second moment) + ZeRO-3 over (pod, data) + sequence-sharded activations —
~1.03T params ⇒ ~8 GB/chip for weights+grads at 512 chips.
"""
from repro_torch.configs.base import LayerGroup, LayerSpec, ModelConfig

ARCH = "kimi-k2-1t-a32b"


def config() -> ModelConfig:
    spec = LayerSpec(mixer="attn", ffn="moe")
    return ModelConfig(
        name=ARCH,
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=0,
        d_ff_expert=2048,
        n_experts=384,
        top_k=8,
        vocab_size=163840,
        groups=(LayerGroup((spec,), 61),),
        param_dtype="bfloat16",
        fsdp_params=True,
        act_seq_shard=True,
        loss_chunk=512,
        remat="full",
        moe_impl="ep",  # expert-parallel: the ZeRO-3 gather impl would
                        # materialize 34 GB/layer of expert weights per chip
        moe_token_chunks=8,  # bound EP dispatch buffers (217 -> ~51 GB temp)
        decode_cache_seq_shard=True,  # split-KV decode (§Perf A3: 17x less wire)
        optimizer="adafactor",
        learning_rate=2e-4,
    )


def reduced() -> ModelConfig:
    spec = LayerSpec(mixer="attn", ffn="moe")
    return config().replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff_expert=32,
        n_experts=8,
        top_k=2,
        vocab_size=512,
        groups=(LayerGroup((spec,), 2),),
        param_dtype="float32",
        fsdp_params=False,
        act_seq_shard=False,
        loss_chunk=0,
        remat="none",
        compute_dtype="float32",
    )
