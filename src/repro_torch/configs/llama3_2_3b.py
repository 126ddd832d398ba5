"""llama3.2-3b [hf:meta-llama/Llama-3.2-1B family].

28L, d_model=3072, 24H (GQA kv=8), d_ff=8192, vocab=128256.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    rope_theta=500000.0,
    long_context_window=8192,  # SWA variant used only for long_500k decode
    source="hf:meta-llama/Llama-3.2-1B",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="llama3.2-smoke",
        n_layers=2,
        d_model=192,
        n_heads=6,
        n_kv_heads=2,
        d_ff=512,
        vocab=512,
        long_context_window=0,
    )


def bench_config() -> ModelConfig:
    """Reduced-shape variant of the REAL config for the training
    throughput benchmark (benchmarks/train_throughput.py): same family,
    GQA ratio, and ff multiple as llama3.2, sized so a multi-step
    window finishes in CPU-benchmark time while model compute still
    dominates the robust aggregation — the regime the <10% overhead
    gate is about."""
    return dataclasses.replace(
        CONFIG,
        name="llama3.2-bench",
        n_layers=4,
        d_model=256,
        n_heads=8,
        n_kv_heads=4,
        d_ff=688,
        vocab=2048,
        long_context_window=0,
    )
