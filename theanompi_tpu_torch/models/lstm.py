"""LSTM sentiment classifier on IMDB.

Port of ``theanompi_tpu/models/lstm.py`` (reference:
``theanompi/models/lasagne_model_zoo/lstm.py`` — the Lasagne LSTM on
IMDB, the reference's GoSGD demo): Embedding -> masked LSTM -> masked
mean pool -> Dropout -> FC(2).  It runs under all three rules.  Token
ids stay integers through ``prep_input``: the classifier's generic
input path casts to the compute dtype (bf16 cannot hold every id above
256) and permutes image batches to NCHW.
"""

from __future__ import annotations

import torch

from theanompi_tpu_torch.models.base import ClassifierModel
from theanompi_tpu_torch.models.data.imdb import N_CLASSES, PAD_ID, ImdbData
from theanompi_tpu_torch.ops.layers import FC, Dropout, Layer
from theanompi_tpu_torch.ops.recurrent import LSTM as LSTMLayer
from theanompi_tpu_torch.ops.recurrent import Embedding


class _ImdbNet(Layer):
    """Embedding -> LSTM -> pool -> dropout -> FC with the pad mask
    threaded through (``Sequential`` passes no mask between layers).
    Its JAX trees are ``{"embed": {"w"}, "lstm": {"wx", "wh", "b"},
    "fc": {"w", "b"}}``."""

    def __init__(self, vocab, emb_dim, hidden, dropout, compute_dtype):
        super().__init__()
        self.embed = Embedding(vocab, emb_dim, out_dtype=compute_dtype)
        self.lstm = LSTMLayer(hidden, pool="mean")
        self.drop = Dropout(dropout)
        self.fc = FC(N_CLASSES)

    def init(self, gen, in_shape):
        shape = self.embed.init(gen, in_shape)
        shape = self.lstm.init(gen, shape)
        return self.fc.init(gen, shape)

    def forward(self, x, train=False, gen=None):
        h = self.lstm(self.embed(x), mask=(x != PAD_ID))
        h = self.drop(h, train=train, gen=gen)
        return self.fc(h)


class LSTM(ClassifierModel):
    """IMDB sentiment LSTM under the model contract.  Defaults are the
    published width: vocab 10000, embedding 128, hidden 128, maxlen
    100, batch 32, dropout 0.5, lr 0.1, weight decay 0, 15 epochs."""

    def __init__(self, config: dict | None = None, device=None):
        config = dict(config or {})
        config.setdefault("lr", 0.1)
        config.setdefault("weight_decay", 0.0)
        config.setdefault("n_epochs", 15)
        config.setdefault("batch_size", 32)
        super().__init__(config, device)
        self.vocab = int(config.get("vocab", 10000))
        self.emb_dim = int(config.get("emb_dim", 128))
        self.hidden = int(config.get("hidden", 128))
        self.dropout = float(config.get("dropout", 0.5))
        self.maxlen = int(config.get("maxlen", 100))

    def prep_input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.int32)   # token ids are not cast to the bf16

    def build_model(self, n_replicas: int = 1) -> None:
        self.net = _ImdbNet(self.vocab, self.emb_dim, self.hidden,
                            self.dropout, self.compute_dtype)
        self.input_shape = (self.maxlen,)
        self.data = ImdbData(
            batch_size=self.config.get("batch_size", 32),
            n_replicas=n_replicas,
            maxlen=self.maxlen,
            vocab=self.vocab,
            seed=self.seed,
            n_train=self.config.get("n_train"),
            n_val=self.config.get("n_val"),
        )
        self._init_params()
