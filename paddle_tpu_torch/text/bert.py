"""BERT model family (counterpart: ``paddle_tpu/text/bert.py``): the
post-LN encoder of ``text/ernie.py`` without the task-type embedding,
with the reference's heads (sequence and token classification, question
answering, and pretraining's masked LM plus next-sentence prediction).
``BertForSequenceClassification`` is the model of BERT-base finetuning.

What ``text/ernie.py`` says of attention, masks, the tied masked-LM
decoder, fp32 losses, seeds and devices holds here too; the encoder
layer, the padding mask, the pooler and the masked-LM head are ERNIE's.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, Linear, generator_from
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import TransformerEncoder
from ..ops.math import add
from .ernie import (ErnieLMHead, ErniePooler, encoder_layer, mlm_loss,
                    padding_mask)
from ..nn.layer.layers import Layer

BertPooler = ErniePooler


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, pad_token_id=0,
                 layer_norm_eps=1e-12, num_labels=2):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.pad_token_id = pad_token_id
        self.layer_norm_eps = layer_norm_eps
        self.num_labels = num_labels


class BertEmbeddings(Layer):
    """Word + position + token-type embeddings, then LayerNorm and
    dropout."""

    def __init__(self, cfg, device=None, dtype=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype, generator=generator,
                  init_std=cfg.initializer_range)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    device=device, dtype=dtype)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = add(add(self.word_embeddings(input_ids),
                    self.position_embeddings(position_ids)),
                self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertModel(Layer):
    """PaddleNLP's ``BertModel`` surface: (sequence_output,
    pooled_output)."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = generator_from(seed)
        self.config = config
        self.embeddings = BertEmbeddings(config, device, dtype, gen)
        self.encoder = TransformerEncoder(
            encoder_layer(config, device, dtype, gen),
            config.num_hidden_layers)
        self.pooler = BertPooler(config, device, dtype, gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        seq = self.encoder(x, src_mask=padding_mask(attention_mask))
        return seq, self.pooler(seq)


class BertForSequenceClassification(Layer):
    """The finetuning model: a classifier over the pooled output."""

    def __init__(self, config, num_classes=None, dropout=None, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        device, gen = resolve_device(device), generator_from(seed)
        self.bert = BertModel(config, device, dtype, gen)
        self.num_classes = num_classes or config.num_labels
        self.dropout = Dropout(dropout if dropout is not None
                               else config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, self.num_classes,
                                 device=device, dtype=dtype, generator=gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return logits, F.cross_entropy(logits.float(), labels)
        return logits


class BertForTokenClassification(Layer):
    def __init__(self, config, num_classes=None, dropout=None, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        device, gen = resolve_device(device), generator_from(seed)
        self.bert = BertModel(config, device, dtype, gen)
        self.num_classes = num_classes or config.num_labels
        self.dropout = Dropout(dropout if dropout is not None
                               else config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, self.num_classes,
                                 device=device, dtype=dtype, generator=gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, labels=None):
        seq, _ = self.bert(input_ids, token_type_ids, position_ids,
                           attention_mask)
        logits = self.classifier(self.dropout(seq))
        if labels is not None:
            loss = F.cross_entropy(
                logits.reshape(-1, self.num_classes).float(),
                labels.reshape(-1))
            return logits, loss
        return logits


class BertForQuestionAnswering(Layer):
    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device, gen = resolve_device(device), generator_from(seed)
        self.bert = BertModel(config, device, dtype, gen)
        self.qa_outputs = Linear(config.hidden_size, 2, device=device,
                                 dtype=dtype, generator=gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, _ = self.bert(input_ids, token_type_ids, position_ids,
                           attention_mask)
        logits = self.qa_outputs(seq)
        return logits[..., 0], logits[..., 1]


class BertPretrainingHeads(ErnieLMHead):
    """The masked-LM head (tied decoder) and the next-sentence classifier
    over the pooled output."""

    def __init__(self, cfg, embedding, device=None, dtype=None,
                 generator=None):
        super().__init__(cfg, embedding, device, dtype, generator)
        self.seq_relationship = Linear(
            cfg.hidden_size, 2, device=resolve_device(device), dtype=dtype,
            generator=generator)

    def forward(self, sequence_output, pooled_output):
        return (super().forward(sequence_output),
                self.seq_relationship(pooled_output))


class BertForPretraining(Layer):
    """Masked LM plus next-sentence prediction."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device, gen = resolve_device(device), generator_from(seed)
        self.bert = BertModel(config, device, dtype, gen)
        self.cls = BertPretrainingHeads(
            config, self.bert.embeddings.word_embeddings, device, dtype, gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, masked_lm_labels=None,
                next_sentence_label=None):
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask)
        prediction, relationship = self.cls(seq, pooled)
        if masked_lm_labels is not None:
            loss = mlm_loss(prediction, masked_lm_labels)
            if next_sentence_label is not None:
                loss = loss + F.cross_entropy(
                    relationship.float(), next_sentence_label.reshape(-1))
            return prediction, relationship, loss
        return prediction, relationship


def bert_base(**kw):
    return BertConfig(hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, intermediate_size=3072, **kw)


def bert_large(**kw):
    return BertConfig(hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096, **kw)
