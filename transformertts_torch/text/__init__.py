"""Text frontend: phonemization + tokenization (host-side).

Composition mirrors the reference (data/text/__init__.py:7-21).
"""
from typing import Union

from transformertts_torch.text.symbols import all_phonemes
from transformertts_torch.text.phonemizer import Phonemizer
from transformertts_torch.text.tokenizer import Tokenizer

__all__ = ['TextToTokens', 'Phonemizer', 'Tokenizer', 'all_phonemes']


class TextToTokens:
    def __init__(self, phonemizer: Phonemizer, tokenizer: Tokenizer):
        self.phonemizer = phonemizer
        self.tokenizer = tokenizer

    def __call__(self, input_text: Union[str, list]) -> list:
        phons = self.phonemizer(input_text)
        return self.tokenizer(phons)

    @classmethod
    def default(cls, language: str, add_start_end: bool, with_stress: bool,
                model_breathing: bool, njobs: int = 1, backend: str = 'auto'):
        phonemizer = Phonemizer(language=language, njobs=njobs,
                                with_stress=with_stress, backend=backend)
        tokenizer = Tokenizer(add_start_end=add_start_end, model_breathing=model_breathing)
        return cls(phonemizer=phonemizer, tokenizer=tokenizer)
