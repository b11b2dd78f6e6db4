"""llava-next-mistral-7b [vlm] — Mistral-7B backbone + anyres tiling stub
(counterpart of ``repro/configs/llava_next_mistral_7b.py``, same numbers).

Source: [hf:llava-hf/llava-v1.6-mistral-7b-hf].
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, head_dim=128.
The vision tower and mm projector are a stub: batches carry pre-projected
patch embeddings, anyres = base image plus 4 tiles of 576 patches each
(2880 image tokens), in place of the sequence's first token embeddings.
"""
from repro_torch.configs.base import ModelConfig, VisionStubConfig

CITATION = "hf:llava-hf/llava-v1.6-mistral-7b-hf"


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        citation=CITATION,
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32_000,
        pattern=(("attn", "dense"),),
        rope_theta=1_000_000.0,
        vision=VisionStubConfig(n_tiles=5, patches_per_tile=576,
                                embed_dim=4096),
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-reduced",
        family="vlm",
        citation=CITATION,
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        pattern=(("attn", "dense"),),
        vision=VisionStubConfig(n_tiles=2, patches_per_tile=16,
                                embed_dim=256),
    ).validate()
