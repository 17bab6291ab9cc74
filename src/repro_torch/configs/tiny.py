"""tiny — the small dense config of the end-to-end examples and tests."""

from repro_torch.models.config import ModelConfig


def config(**kw) -> ModelConfig:
    return ModelConfig(
        name="tiny", arch_type="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=384, block_size=16, **kw)


def smoke_config(**kw) -> ModelConfig:
    return config(**kw)
