"""The text frontend of the reference: a sentence of lexicon words → token ids.

Pronunciations come from the lexicon table beside the traffic
(``data/lexicon_en_us.tsv``, espeak-ng's en-us IPA of each word); the
sentence is the words' IPA joined by spaces, with each comma and the final
full stop attached to the word before it, as the published frontend joins
phonemized clauses. Ids follow the published tokenizer of the
ForwardTransformer (no start or end token, no breathing token): 0 is
padding and 1.. enumerate the sorted symbol inventory below, which is the
published ``data/text/symbols.py``.
"""
from pathlib import Path
from typing import Dict, List

_VOWELS = 'iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻ'
_NON_PULMONIC = 'ʘɓǀɗǃʄǂɠǁʛ'
_PULMONIC = 'pbtdʈɖcɟkɡqɢʔɴŋɲɳnɱmʙrʀⱱɾɽɸβfvθðszʃʒʂʐçʝxɣχʁħʕhɦɬɮʋɹɻjɰlɭʎʟ'
_SUPRASEGMENTALS = 'ˈˌːˑ'
_OTHER = 'ʍwɥʜʢʡɕʑɺɧ'
_DIACRITICS = 'ɚ˞ɫ'
_PUNCTUATION = "!,-.:;? '()"

SYMBOLS = sorted(sorted(_VOWELS + _NON_PULMONIC + _PULMONIC + _SUPRASEGMENTALS + _OTHER
                        + _DIACRITICS) + list(_PUNCTUATION))
SYMBOL_IDS = {s: i + 1 for i, s in enumerate(SYMBOLS)}

LEXICON_FILE = Path(__file__).resolve().parent.parent / 'data' / 'lexicon_en_us.tsv'


def read_lexicon(path: Path = LEXICON_FILE) -> Dict[str, str]:
    """word → IPA, from a ``word<TAB>ipa`` table (``#`` lines skipped)."""
    table = {}
    for line in Path(path).read_text(encoding='utf-8').splitlines():
        if line.strip() and not line.startswith('#'):
            word, ipa = line.split('\t')
            table[word] = ipa
    return table


def phonemes(sentence: str, lexicon: Dict[str, str]) -> str:
    """'Word word, word.' → its IPA string."""
    out = []
    for raw in sentence.split(' '):
        word = raw.rstrip(',.').lower()
        tail = raw[len(word):]
        out.append(lexicon[word] + tail)
    return ' '.join(out).replace(' ,', ',').replace(', ', ',')


def tokens(sentence: str, lexicon: Dict[str, str]) -> List[int]:
    return [SYMBOL_IDS[c] for c in phonemes(sentence, lexicon)]
