"""Tokenization for the serving loop (CPU-side).

The reference passes raw strings to vLLM and never tokenizes
(main.py:215, SURVEY.md section 2.1 row 'Tokenization'); here tokenization
is first-party.  Two implementations behind one duck-typed interface:

* ``HFTokenizer`` — a local ``tokenizers``/``transformers`` tokenizer when a
  checkpoint/tokenizer path is configured;
* ``ByteTokenizer`` — a dependency-free UTF-8 byte fallback used in
  zero-egress environments (random-weight benchmarking, CI): byte ``b``
  maps to id ``OFFSET + b``, valid for any vocab >= 259.
"""

from __future__ import annotations

import os
from typing import List, Optional, Protocol

from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.models.specs import ModelSpec

logger = get_logger(__name__)


class Tokenizer(Protocol):
    eos_id: int
    bos_id: int

    def encode(self, text: str) -> List[int]: ...

    def decode(self, ids: List[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes shifted past a small reserved-special region."""

    OFFSET = 3  # 0=pad/eos-ish space, 1=bos, 2=unk

    def __init__(self, spec: ModelSpec) -> None:
        if spec.vocab_size < 256 + self.OFFSET:
            raise ValueError("vocab too small for byte tokenizer")
        self.eos_id = spec.eos_token_id % spec.vocab_size
        self.bos_id = spec.bos_token_id % spec.vocab_size

    def encode(self, text: str) -> List[int]:
        return [self.OFFSET + b for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        data = bytes(
            i - self.OFFSET for i in ids if self.OFFSET <= i < self.OFFSET + 256
        )
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """Wraps a local HF fast tokenizer."""

    def __init__(self, path: str, spec: ModelSpec) -> None:
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        eos = self._tok.eos_token_id
        self.eos_id = eos if eos is not None else spec.eos_token_id
        bos = self._tok.bos_token_id
        self.bos_id = bos if bos is not None else spec.bos_token_id

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: List[dict]) -> Optional[str]:
        """Render chat messages with the model's own template when the
        tokenizer ships one (the gateway falls back to the reference's
        "Role: content" flattening otherwise, main.py:190-196)."""
        if not getattr(self._tok, "chat_template", None):
            return None
        return self._tok.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True
        )


def get_tokenizer(spec: ModelSpec, tokenizer_path: Optional[str]) -> Tokenizer:
    if tokenizer_path and os.path.exists(tokenizer_path):
        try:
            return HFTokenizer(tokenizer_path, spec)
        except Exception:
            logger.warning(
                "failed to load HF tokenizer; falling back to bytes",
                exc_info=True,
            )
    return ByteTokenizer(spec)
