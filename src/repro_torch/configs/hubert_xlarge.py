"""hubert-xlarge [audio] — encoder-only transformer (wav2vec2 arch)
(counterpart of ``repro/configs/hubert_xlarge.py``, same numbers).

Source: HuBERT [arXiv:2106.07447].
48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 (k-means codebook
units).  The conv frontend is a stub: batches carry 20 ms frame
embeddings (``data.synthetic``); the objective is masked prediction over
the 504 units.  Encoder-only, so it has no decode path.
"""
from repro_torch.configs.base import AudioStubConfig, ModelConfig

CITATION = "arXiv:2106.07447 (HuBERT)"


def full_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="encoder",
        citation=CITATION,
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        pattern=(("attn", "dense"),),
        causal=False,
        audio=AudioStubConfig(frame_dim=1280),
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-reduced",
        family="encoder",
        citation=CITATION,
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=504,
        pattern=(("attn", "dense"),),
        causal=False,
        audio=AudioStubConfig(frame_dim=256),
    ).validate()
