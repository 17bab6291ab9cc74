"""sdar-8b — the paper's own backbone family (SDAR-8B-Chat,
arXiv:2510.06303; Qwen3-8B-derived blockwise dLLM), diffusion block 4."""

from repro_torch.models.config import ModelConfig


def config(**kw) -> ModelConfig:
    return ModelConfig(
        name="sdar-8b", arch_type="dense", source="arXiv:2510.06303",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=12288, vocab_size=151936,
        rope_theta=1e6, tie_embeddings=False, block_size=4,
        **kw)


def smoke_config(**kw) -> ModelConfig:
    return config().replace(
        name="sdar-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        block_size=4, **kw)
