"""CBOW word2vec (``paddle_tpu/models/word2vec.py``).

Reference parity: tests/book/test_word2vec.py and the dist_word2vec.py
fixture (a shared embedding averaged over the context, a softmax head).
"""
from __future__ import annotations

from ..nn.layer_base import Layer
from ..nn.layers import Embedding, Linear

__all__ = ["Word2Vec"]


class Word2Vec(Layer):
    """CBOW: predict the middle word from ``context`` context words."""

    def __init__(self, vocab_size, embed_dim=32, context=4, generator=None):
        super().__init__()
        self.embedding = Embedding(vocab_size, embed_dim, generator=generator)
        self.fc = Linear(embed_dim, vocab_size, generator=generator)
        self.context = context

    def forward(self, context_ids):
        # context_ids: [B, context]
        emb = self.embedding(context_ids)  # [B, C, E]
        return self.fc(emb.mean(dim=1))
