"""A BERT encoder for BERTScore.

The JAX package's BERTScore runs a ``transformers.FlaxBertModel``; this is
its counterpart as a plain ``torch.nn.Module``, so the port needs no
``transformers`` on the card. :class:`BertModel` takes the widths of a
``transformers.BertConfig`` (:class:`BertConfig`, BERT-base by default),
uses ``layer_norm_eps=1e-12`` and the exact-erf GELU, and returns every
hidden state (the embeddings' output, then one per layer), as
``output_hidden_states=True`` does. Its submodules carry
``transformers.BertModel``'s names (``embeddings.word_embeddings``,
``encoder.layer.N.attention.self.query``, ..., ``pooler.dense``), so a torch
BERT state dict loads with ``load_state_dict`` as it is, and
:func:`metrics_tpu_torch.convert.bert_from_flax` maps a Flax BERT's
parameter tree onto it.

The products are ``F.linear`` and ``torch.matmul`` and the attention a
plain softmax, as the JAX package computes them outside any Pallas kernel.
A masked key gets the dtype's most negative value added to its score, as
Flax BERT does. On the card :func:`bert_forward` runs the encoder at full
float32 (no TF32, :func:`metrics_tpu_torch.models.full_float32_convs`).
"""
import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from metrics_tpu_torch.models import full_float32_convs

Tensor = torch.Tensor


@dataclass
class BertConfig:
    """The widths of ``transformers.BertConfig`` (BERT-base by default)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02


class BertOutput(NamedTuple):
    last_hidden_state: Tensor
    pooler_output: Tensor
    hidden_states: Tuple[Tensor, ...]


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.word_embeddings = nn.Embedding(config.vocab_size, config.hidden_size)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings, config.hidden_size)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, input_ids: Tensor, token_type_ids: Optional[Tensor] = None) -> Tensor:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        hidden = self.word_embeddings(input_ids) + self.token_type_embeddings(token_type_ids)
        hidden = hidden + self.position_embeddings(positions)[None]
        return self.LayerNorm(hidden)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.query = nn.Linear(config.hidden_size, config.hidden_size)
        self.key = nn.Linear(config.hidden_size, config.hidden_size)
        self.value = nn.Linear(config.hidden_size, config.hidden_size)

    def _heads(self, x: Tensor) -> Tensor:
        b, s, _ = x.shape
        return x.view(b, s, self.num_heads, self.head_dim).transpose(1, 2)  # [B, H, S, d]

    def forward(self, hidden: Tensor, bias: Tensor) -> Tensor:
        q = self._heads(self.query(hidden))
        k = self._heads(self.key(hidden))
        v = self._heads(self.value(hidden))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(self.head_dim) + bias
        context = torch.matmul(F.softmax(scores, dim=-1), v)  # [B, H, S, d]
        b, _, s, _ = context.shape
        return context.transpose(1, 2).reshape(b, s, self.num_heads * self.head_dim)


class BertSelfOutput(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, hidden: Tensor, residual: Tensor) -> Tensor:
        return self.LayerNorm(self.dense(hidden) + residual)


class BertAttention(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.self = BertSelfAttention(config)
        self.output = BertSelfOutput(config)

    def forward(self, hidden: Tensor, bias: Tensor) -> Tensor:
        return self.output(self.self(hidden, bias), hidden)


class BertIntermediate(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.intermediate_size)

    def forward(self, hidden: Tensor) -> Tensor:
        return F.gelu(self.dense(hidden))  # exact erf


class BertLayerOutput(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.dense = nn.Linear(config.intermediate_size, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, hidden: Tensor, residual: Tensor) -> Tensor:
        return self.LayerNorm(self.dense(hidden) + residual)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.attention = BertAttention(config)
        self.intermediate = BertIntermediate(config)
        self.output = BertLayerOutput(config)

    def forward(self, hidden: Tensor, bias: Tensor) -> Tensor:
        attended = self.attention(hidden, bias)
        return self.output(self.intermediate(attended), attended)


class BertEncoder(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(config) for _ in range(config.num_hidden_layers))


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, hidden: Tensor) -> Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """BERT encoder with ``transformers.BertModel``'s module names.

    ``forward(input_ids, attention_mask=None, token_type_ids=None)`` returns
    :class:`BertOutput`, whose ``hidden_states`` holds
    ``num_hidden_layers + 1`` tensors ``[B, S, hidden_size]``: index 0 is
    the embeddings' output.
    """

    def __init__(self, config: Optional[BertConfig] = None) -> None:
        super().__init__()
        self.config = config or BertConfig()
        self.embeddings = BertEmbeddings(self.config)
        self.encoder = BertEncoder(self.config)
        self.pooler = BertPooler(self.config)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BertModel":
        """``transformers``' initialisation drawn from ``generator``: normal
        (0, ``initializer_range``) weights for every linear and embedding
        layer, zero biases, unit LayerNorm scales. The draws are made on the
        generator's device, in the order of ``named_parameters``."""
        std = self.config.initializer_range
        for name, param in self.named_parameters():
            if "LayerNorm" in name:
                param.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                param.zero_()
            else:
                draw = torch.empty(param.shape, dtype=param.dtype, device=generator.device)
                param.copy_(draw.normal_(0.0, std, generator=generator))
        return self

    def forward(
        self,
        input_ids: Tensor,
        attention_mask: Optional[Tensor] = None,
        token_type_ids: Optional[Tensor] = None,
        output_hidden_states: bool = True,
    ) -> BertOutput:
        input_ids = input_ids.long()
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is not None:
            token_type_ids = token_type_ids.long()
        hidden = self.embeddings(input_ids, token_type_ids)
        dtype = hidden.dtype
        bias = torch.where(
            attention_mask[:, None, None, :] > 0,
            torch.zeros((), dtype=dtype, device=hidden.device),
            torch.full((), torch.finfo(dtype).min, dtype=dtype, device=hidden.device),
        )
        states: List[Tensor] = [hidden]
        for layer in self.encoder.layer:
            hidden = layer(hidden, bias)
            states.append(hidden)
        return BertOutput(hidden, self.pooler(hidden), tuple(states))


def build_bert(
    config: Optional[BertConfig] = None, seed: int = 0, device: Optional[torch.device] = None
) -> BertModel:
    """A :class:`BertModel` on ``device`` (default: the card) in eval mode,
    its weights drawn by :meth:`BertModel.init_weights` from a generator on
    that device seeded with ``seed``."""
    device = torch.device("cuda" if device is None else device)
    with torch.device(device):
        model = BertModel(config)
    generator = torch.Generator(device=device).manual_seed(seed)
    return model.init_weights(generator).eval()


def bert_forward(model: nn.Module, input_ids: Tensor, attention_mask: Tensor) -> Tuple[Tensor, ...]:
    """Every hidden state of ``model`` (this module's BERT or a
    ``transformers`` torch model) on a batch, without autograd and, on the
    card, at full float32."""
    with torch.no_grad(), full_float32_convs(input_ids.device):
        out = model(input_ids=input_ids, attention_mask=attention_mask, output_hidden_states=True)
    return tuple(out.hidden_states)
