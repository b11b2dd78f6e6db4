"""xlstm-125m — sLSTM + mLSTM blocks (counterpart of
``repro/configs/xlstm_125m.py``, same numbers).

Source: xLSTM [arXiv:2405.04517].  12L d_model=768, no FFN (the
projections live inside the blocks), vocab=50304, tied embeddings.  The
pattern (mLSTM ×5, sLSTM) × 2 puts sLSTM at layers 5 and 11.  mLSTM: inner
width 1536, 8 heads of qk dim 96 and v dim 192, chunk 64; sLSTM: 4 heads
of 192.  By its init shapes that is 128,642,464 parameters.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CITATION = "arXiv:2405.04517 (xLSTM)"


def full_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        citation=CITATION,
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab_size=50_304,
        pattern=(("mlstm", "none"),) * 5 + (("slstm", "none"),),
        ssm=SSMConfig(mlstm_head_dim=96, mlstm_expand=2, slstm_heads=4,
                      mlstm_chunk=64),
        tie_embeddings=True,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-reduced",
        family="ssm",
        citation=CITATION,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=0,
        vocab_size=512,
        pattern=(("mlstm", "none"), ("slstm", "none")),
        ssm=SSMConfig(mlstm_head_dim=32, mlstm_expand=2, slstm_heads=4,
                      mlstm_chunk=16),
        tie_embeddings=True,
    ).validate()
