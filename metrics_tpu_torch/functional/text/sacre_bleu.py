"""SacreBLEU score.

Counterpart of ``metrics_tpu/functional/text/sacre_bleu.py``. Tokenizer
rules follow the sacrebleu project (mjpost/sacrebleu tokenizers): 13a
(mteval-v13a), zh (CJK split + 13a), intl (mteval-v14 international), char,
none. The ``intl`` tokenizer needs the third-party ``regex`` module for
unicode property classes; it is imported at the tokenizer's first use, so
the port imports without it. The score is BLEU's (``bleu.py``).
"""
import re
from typing import Optional, Sequence, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update
from metrics_tpu_torch.utils.imports import _REGEX_AVAILABLE

Tensor = torch.Tensor

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")

_UCODE_RANGES = (
    ("\u3400", "\u4db5"),  # CJK Unified Ideographs Extension A
    ("\u4e00", "\u9fa5"),  # CJK Unified Ideographs
    ("\u9fa6", "\u9fbb"),
    ("\uf900", "\ufa2d"),  # CJK Compatibility Ideographs
    ("\ufa30", "\ufa6a"),
    ("\ufa70", "\ufad9"),
    # CJK Extension B / Compatibility Supplement — written with the 4-digit
    # \u escape exactly as sacrebleu (and the reference) write them, which
    # Python parses as TWO-char strings (' ' + '0', ...): the
    # lexicographic comparison then ALSO classifies single chars in
    # (U+2000, U+2A6D] and (U+2F80, U+2FA1] — general punctuation and
    # currency symbols like '€' — as Chinese in zh mode. Deliberately
    # reproduced for observable tokenizer parity with sacrebleu/the
    # reference (the unicode-correct \U00020000 form diverges from both;
    # pinned by tests/text/test_stored_oracle.py's zh grid rows).
    ("\u2000" "0", "\u2a6d" "6"),
    ("\u2f80" "0", "\u2fa1" "d"),
    ("\uff00", "\uffef"),  # full-width ASCII / half-width kana
    ("\u2e80", "\u2eff"),  # CJK Radicals Supplement
    ("\u3000", "\u303f"),  # CJK punctuation
    ("\u31c0", "\u31ef"),  # CJK strokes
    ("\u2f00", "\u2fdf"),  # Kangxi Radicals
    ("\u2ff0", "\u2fff"),  # character structure
    ("\u3100", "\u312f"),  # phonetic symbols
    ("\u31a0", "\u31bf"),
    ("\ufe10", "\ufe1f"),
    ("\ufe30", "\ufe4f"),
    ("\u2600", "\u26ff"),
    ("\u2700", "\u27bf"),
    ("\u3200", "\u32ff"),
    ("\u3300", "\u33ff"),
)


class _SacreBLEUTokenizer:
    """Line tokenizers for SacreBLEU (reference sacre_bleu.py:80-276)."""

    _REGEX = (
        (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
        (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
        (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
        (re.compile(r"([0-9])(-)"), r"\1 \2 "),
    )

    #: the ``intl`` rules, compiled with ``regex`` at their first use
    _INT_REGEX: Optional[tuple] = None

    _TOKENIZE_FN = {
        "none": "_tokenize_base",
        "13a": "_tokenize_13a",
        "zh": "_tokenize_zh",
        "intl": "_tokenize_international",
        "char": "_tokenize_char",
    }

    def __init__(self, tokenize: str, lowercase: bool = False) -> None:
        self.tokenize_fn = getattr(self, self._TOKENIZE_FN[tokenize])
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized_line = self.tokenize_fn(line)
        return self._lower(tokenized_line, self.lowercase).split()

    @classmethod
    def tokenize(cls, line: str, tokenize: str, lowercase: bool = False) -> Sequence[str]:
        tokenize_fn = getattr(cls, cls._TOKENIZE_FN[tokenize])
        return cls._lower(tokenize_fn(line), lowercase).split()

    @classmethod
    def _tokenize_regex(cls, line: str) -> str:
        for _re, repl in cls._REGEX:
            line = _re.sub(repl, line)
        return " ".join(line.split())

    @staticmethod
    def _is_chinese_char(uchar: str) -> bool:
        return any(start <= uchar <= end for start, end in _UCODE_RANGES)

    @classmethod
    def _tokenize_base(cls, line: str) -> str:
        return line

    @classmethod
    def _tokenize_13a(cls, line: str) -> str:
        line = line.replace("<skipped>", "")
        line = line.replace("-\n", "")
        line = line.replace("\n", " ")
        if "&" in line:
            line = line.replace("&quot;", '"')
            line = line.replace("&amp;", "&")
            line = line.replace("&lt;", "<")
            line = line.replace("&gt;", ">")
        # mteval v13a applies the punctuation regexes to the SPACE-PADDED
        # line (sacrebleu Tokenizer13a: `self._post_tokenizer(f' {line} ')`),
        # so a sentence-final period after a digit still splits: '04.' ->
        # '04 .'. The zh tokenizer shares the regexes but does NOT pad.
        return cls._tokenize_regex(f" {line} ")

    @classmethod
    def _tokenize_zh(cls, line: str) -> str:
        line = line.strip()
        line_in_chars = ""
        for char in line:
            if cls._is_chinese_char(char):
                line_in_chars += " " + char + " "
            else:
                line_in_chars += char
        return cls._tokenize_regex(line_in_chars)

    @classmethod
    def _int_regex(cls) -> tuple:
        if cls._INT_REGEX is None:
            import regex

            cls._INT_REGEX = (
                (regex.compile(r"(\P{N})(\p{P})"), r"\1 \2 "),
                (regex.compile(r"(\p{P})(\P{N})"), r" \1 \2"),
                (regex.compile(r"(\p{S})"), r" \1 "),
            )
        return cls._INT_REGEX

    @classmethod
    def _tokenize_international(cls, line: str) -> str:
        for _re, repl in cls._int_regex():
            line = _re.sub(repl, line)
        return " ".join(line.split())

    @classmethod
    def _tokenize_char(cls, line: str) -> str:
        return " ".join(char for char in line)

    @staticmethod
    def _lower(line: str, lowercase: bool) -> str:
        return line.lower() if lowercase else line


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Calculate BLEU with sacrebleu-compatible tokenization.

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> sacre_bleu_score(preds, target, device="cpu")
        tensor(0.7598)
    """
    if tokenize not in AVAILABLE_TOKENIZERS:
        raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
    if tokenize == "intl" and not _REGEX_AVAILABLE:
        raise ModuleNotFoundError(
            "`'intl'` tokenization requires that `regex` is installed. Use `pip install regex`."
        )
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")

    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    tokenize_fn = _SacreBLEUTokenizer(tokenize, lowercase)
    preds_len, target_len = _bleu_score_update(
        preds, target, numerator, denominator, 0.0, 0.0, n_gram, tokenize_fn
    )
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, smooth, device)
