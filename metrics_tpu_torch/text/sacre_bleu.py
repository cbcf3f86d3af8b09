"""Modular SacreBLEUScore.

Counterpart of ``metrics_tpu/text/sacre_bleu.py``: ``BLEUScore`` with the
sacrebleu-compatible tokenizer family (13a / char / intl / none / zh).
"""
from typing import Any

from metrics_tpu_torch.functional.text.sacre_bleu import AVAILABLE_TOKENIZERS, _SacreBLEUTokenizer
from metrics_tpu_torch.text.bleu import BLEUScore
from metrics_tpu_torch.utils.imports import _REGEX_AVAILABLE


class SacreBLEUScore(BLEUScore):
    """Calculate BLEU score with sacrebleu-compatible tokenization.

    Args:
        n_gram: Gram value ranged from 1 to 4 (default 4).
        smooth: Whether to apply add-one smoothing.
        tokenize: Tokenization technique: one of ``'none'``, ``'13a'``,
            ``'zh'``, ``'intl'``, ``'char'``.
        lowercase: If True, BLEU is case-insensitive.

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> metric = SacreBLEUScore(device="cpu")
        >>> metric(preds, target)
        tensor(0.7598)
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, **kwargs)
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        if tokenize == "intl" and not _REGEX_AVAILABLE:
            raise ModuleNotFoundError(
                "`'intl'` tokenization requires that `regex` is installed. Use `pip install regex`."
            )
        self.tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
