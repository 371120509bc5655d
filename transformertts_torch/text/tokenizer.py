"""Character-level IPA tokenizer.

Index semantics match the reference tokenizer (data/text/tokenizer.py:9-48)
exactly — token-index assignment determines embedding rows in trained
checkpoints, so the *layout* below is a compatibility contract:

- id 0 is padding; ids 1..K enumerate the (sorted) alphabet in order;
- optional start ``>`` / end ``<`` tokens take the next two ids;
- optional "breathing" token ``@`` takes the id after those. A space encodes
  to *two* ids (space then breathing), a literal ``@`` to the breathing id,
  and every encoded sentence starts with one breathing id. Start/end wrap
  the whole sequence last.
"""
from typing import Dict, List, Optional, Sequence

from transformertts_torch.text.symbols import all_phonemes


class Tokenizer:

    def __init__(self, start_token: str = '>', end_token: str = '<',
                 pad_token: str = '/', add_start_end: bool = True,
                 alphabet: Optional[Sequence[str]] = None,
                 model_breathing: bool = True):
        # custom alphabets (tests) are deduped + sorted; the default IPA
        # inventory is used as-is — its order is checkpoint-stable
        symbols = list(all_phonemes) if not alphabet else sorted(set(alphabet))
        self.alphabet = symbols
        self.add_start_end = add_start_end
        self.model_breathing = model_breathing

        self.idx_to_token: Dict[int, str] = {0: pad_token}
        self.idx_to_token.update({k + 1: s for k, s in enumerate(symbols)})
        self._char_ids: Dict[str, int] = {s: k + 1 for k, s in enumerate(symbols)}
        self._char_ids[pad_token] = 0  # pad char round-trips to id 0

        next_id = len(symbols) + 1
        if add_start_end:
            self.start_token_index = next_id
            self.end_token_index = next_id + 1
            self.idx_to_token[self.start_token_index] = start_token
            self.idx_to_token[self.end_token_index] = end_token
            next_id += 2
        if model_breathing:
            self.breathing_token = '@'
            self.breathing_token_index = next_id
            self.idx_to_token[self.breathing_token_index] = self.breathing_token
            next_id += 1
        self.vocab_size = next_id

    def __call__(self, sentence: str) -> List[int]:
        """Encode a phonemized sentence; every char must be in-alphabet."""
        ids: List[int] = []
        if self.model_breathing:
            ids.append(self.breathing_token_index)
        for ch in sentence:
            if self.model_breathing and ch == self.breathing_token:
                ids.append(self.breathing_token_index)
                continue
            ids.append(self._char_ids[ch])
            if self.model_breathing and ch == ' ':
                ids.append(self.breathing_token_index)
        if self.add_start_end:
            ids = [self.start_token_index, *ids, self.end_token_index]
        return ids

    def decode(self, sequence) -> str:
        return ''.join(self.idx_to_token[int(t)] for t in sequence)
