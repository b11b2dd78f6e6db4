"""bert-large — the paper's own language-modeling workload (§5.3)
(counterpart of ``repro/configs/bert_large.py``, same numbers).

Source: BERT [arXiv:1810.04805]; the paper trains BERT-Large phase 1 with
LAMB.  Encoder-only, masked-LM objective: non-causal attention, GELU in
the gated MLP, masked positions replaced by ``mask_emb`` and the loss
taken over them only.  As the reference defines it (untied embeddings,
gated MLP) a replica holds 465,213,440 parameters.
"""
from repro_torch.configs.base import ModelConfig

CITATION = "arXiv:1810.04805 (BERT); paper §5.3 workload"


def full_config() -> ModelConfig:
    return ModelConfig(
        name="bert-large",
        family="encoder",
        citation=CITATION,
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=30_522,
        pattern=(("attn", "dense"),),
        causal=False,
    ).validate()


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="bert-large-reduced",
        family="encoder",
        citation=CITATION,
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        pattern=(("attn", "dense"),),
        causal=False,
    ).validate()
