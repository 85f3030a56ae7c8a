"""ERNIE model family (counterpart: ``paddle_tpu/text/ernie.py``): post-LN
transformer encoders with ERNIE 3.0's task-type embedding beside the
word, position and token-type ones, built on the port's
``nn.TransformerEncoder``. ``ErnieForPretraining`` (= ``ErnieForMaskedLM``)
is the model of ERNIE-3.0 pretraining, the repo's north-star workload.

Attention runs through ``nn.functional.scaled_dot_product_attention``:
with no ``attention_mask`` and sequence lengths that are multiples of
128, the flash kernels, non-causal (K2 forward, K3 backward); with a
mask, the dense path, as in the reference. A 2-D [b, s] mask becomes an
additive fp32 [b, 1, 1, s] mask of -1e4 at padded keys, so under O2 the
bf16 scores plus the mask are fp32 in both packages.

The masked-LM head multiplies by the word embedding's weight (tied, not
a second parameter). It holds the embedding layer, not its weight, and
reads the weight on every call, so a weight swapped in for the call
(``CompiledTrainStep``'s O2 cast through ``torch.func.functional_call``)
reaches both uses, and the weight's gradient is the sum of both.

Losses take the logits in fp32, as the port's GPT does (the reference's
loss works in the logits' dtype, bf16 under O2; ROADMAP C).

Weights are random, drawn from ``seed`` (an int or a ``torch.Generator``)
on the CPU as the layers are built: embeddings normal(0,
``initializer_range``), other weights Xavier-uniform, biases zero, norms
one and zero. The encoder's layers start equal, deep copies of one layer
as in the reference. Load reference weights with
``convert.load_jax_state``; the parameter names are the reference's.
``device`` follows the port's rule: "cuda" unless ``device="cpu"`` is
passed. PaddleNLP's knowledge masking, which picks the masked tokens, is
a data concern and not here.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..nn import functional as F
from ..nn.layer.activation import GELU, Tanh
from ..nn.layer.common import Dropout, Embedding, Linear, generator_from
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import TransformerEncoder, TransformerEncoderLayer
from ..ops.math import add, matmul
from ..nn.layer.layers import Layer


class ErnieConfig:
    def __init__(self, vocab_size=40000, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=2048, type_vocab_size=4,
                 task_type_vocab_size=3, use_task_id=True,
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
        self.task_type_vocab_size = task_type_vocab_size
        self.use_task_id = use_task_id
        self.initializer_range = initializer_range
        self.pad_token_id = pad_token_id
        self.layer_norm_eps = layer_norm_eps
        self.num_labels = num_labels


def padding_mask(attention_mask):
    """A [b, s] keep mask (1 keeps) as the additive fp32 [b, 1, 1, s]
    mask of -1e4 at padded keys; any other mask as it is."""
    if attention_mask is not None and attention_mask.ndim == 2:
        m = attention_mask[:, None, None, :].float()
        return (1.0 - m) * -1e4
    return attention_mask


def encoder_layer(config, device, dtype, generator):
    """The post-LN encoder layer both ERNIE and BERT stack: the config's
    widths and activation, no dropout after the activation, and
    ``TransformerEncoderLayer``'s own LayerNorm eps (1e-5), as in the
    reference."""
    return TransformerEncoderLayer(
        config.hidden_size, config.num_attention_heads,
        config.intermediate_size, dropout=config.hidden_dropout_prob,
        activation=config.hidden_act,
        attn_dropout=config.attention_probs_dropout_prob, act_dropout=0.0,
        normalize_before=False, device=device, dtype=dtype,
        generator=generator)


def mlm_loss(prediction, labels):
    """Cross-entropy of the [..., vocab] logits in fp32 against labels,
    -100 ignored."""
    return F.cross_entropy(
        prediction.reshape(-1, prediction.shape[-1]).float(),
        labels.reshape(-1), ignore_index=-100)


class ErnieEmbeddings(Layer):
    """Word + position + token-type (+ task-type) embeddings, then
    LayerNorm and dropout."""

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
        self.use_task_id = cfg.use_task_id
        if cfg.use_task_id:
            self.task_type_embeddings = Embedding(
                cfg.task_type_vocab_size, cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    device=device, dtype=dtype)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = add(add(self.word_embeddings(input_ids),
                    self.position_embeddings(position_ids)),
                self.token_type_embeddings(token_type_ids))
        if self.use_task_id:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            x = add(x, self.task_type_embeddings(task_type_ids))
        return self.dropout(self.layer_norm(x))


class ErniePooler(Layer):
    """tanh(dense(first token's hidden state))."""

    def __init__(self, cfg, device=None, dtype=None, generator=None):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size, device=device,
                            dtype=dtype, generator=generator)
        self.activation = Tanh()

    def forward(self, hidden_states):
        return self.activation(self.dense(hidden_states[:, 0]))


class ErnieModel(Layer):
    """PaddleNLP's ``ErnieModel`` surface: (sequence_output,
    pooled_output)."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = generator_from(seed)
        self.config = config
        self.embeddings = ErnieEmbeddings(config, device, dtype, gen)
        self.encoder = TransformerEncoder(
            encoder_layer(config, device, dtype, gen),
            config.num_hidden_layers)
        self.pooler = ErniePooler(config, device, dtype, gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            task_type_ids)
        seq = self.encoder(x, src_mask=padding_mask(attention_mask))
        return seq, self.pooler(seq)


class ErnieForSequenceClassification(Layer):
    def __init__(self, config, num_classes=None, dropout=None, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        device, gen = resolve_device(device), generator_from(seed)
        self.ernie = ErnieModel(config, device, dtype, gen)
        self.num_classes = num_classes or config.num_labels
        self.dropout = Dropout(dropout if dropout is not None
                               else config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, self.num_classes,
                                 device=device, dtype=dtype, generator=gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, labels=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return logits, F.cross_entropy(logits.float(), labels)
        return logits


class ErnieForTokenClassification(Layer):
    def __init__(self, config, num_classes=None, dropout=None, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        device, gen = resolve_device(device), generator_from(seed)
        self.ernie = ErnieModel(config, device, dtype, gen)
        self.num_classes = num_classes or config.num_labels
        self.dropout = Dropout(dropout if dropout is not None
                               else config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, self.num_classes,
                                 device=device, dtype=dtype, generator=gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, labels=None):
        seq, _ = self.ernie(input_ids, token_type_ids, position_ids,
                            attention_mask)
        logits = self.classifier(self.dropout(seq))
        if labels is not None:
            loss = F.cross_entropy(
                logits.reshape(-1, self.num_classes).float(),
                labels.reshape(-1))
            return logits, loss
        return logits


class ErnieForQuestionAnswering(Layer):
    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device, gen = resolve_device(device), generator_from(seed)
        self.ernie = ErnieModel(config, device, dtype, gen)
        self.classifier = Linear(config.hidden_size, 2, device=device,
                                 dtype=dtype, generator=gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, _ = self.ernie(input_ids, token_type_ids, position_ids,
                            attention_mask)
        logits = self.classifier(seq)
        return logits[..., 0], logits[..., 1]


class ErnieLMHead(Layer):
    """Masked-LM head: transform, GELU, LayerNorm, then the tied decoder
    (``x @ embedding.weight^T + decoder_bias``). ``embedding`` is the
    word-embedding layer, whose weight is read on every call."""

    def __init__(self, cfg, embedding, device=None, dtype=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                device=device, dtype=dtype,
                                generator=generator)
        self.activation = GELU()
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    device=device, dtype=dtype)
        # in __dict__, not registered: the weight stays one parameter,
        # named where the embedding layer holds it
        self.__dict__["_embedding"] = embedding
        self.decoder_bias = nn.Parameter(torch.zeros(
            cfg.vocab_size, device=device, dtype=dtype or torch.float32))

    def forward(self, sequence_output):
        x = self.layer_norm(self.activation(self.transform(sequence_output)))
        return add(matmul(x, self._embedding.weight, transpose_y=True),
                   self.decoder_bias)


class ErnieForMaskedLM(Layer):
    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device, gen = resolve_device(device), generator_from(seed)
        self.ernie = ErnieModel(config, device, dtype, gen)
        self.cls = ErnieLMHead(config, self.ernie.embeddings.word_embeddings,
                               device, dtype, gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, labels=None):
        seq, _ = self.ernie(input_ids, token_type_ids, position_ids,
                            attention_mask)
        prediction = self.cls(seq)
        if labels is not None:
            return prediction, mlm_loss(prediction, labels)
        return prediction


# the pretraining objective (MLM over the masked positions)
ErnieForPretraining = ErnieForMaskedLM


def ernie_3_0_base(**kw):
    return ErnieConfig(hidden_size=768, num_hidden_layers=12,
                       num_attention_heads=12, intermediate_size=3072, **kw)


def ernie_3_0_medium(**kw):
    return ErnieConfig(hidden_size=768, num_hidden_layers=6,
                       num_attention_heads=12, intermediate_size=3072, **kw)


def ernie_3_0_mini(**kw):
    return ErnieConfig(hidden_size=384, num_hidden_layers=6,
                       num_attention_heads=12, intermediate_size=1536, **kw)
