"""IPA symbol inventory.

The alphabet ordering defines embedding indices, so it must be stable and
must match the reference inventory exactly for checkpoint compatibility
(reference: data/text/symbols.py:1-12).
"""

_vowels = 'iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻ'
_non_pulmonic_consonants = 'ʘɓǀɗǃʄǂɠǁʛ'
_pulmonic_consonants = 'pbtdʈɖcɟkɡqɢʔɴŋɲɳnɱmʙrʀⱱɾɽɸβfvθðszʃʒʂʐçʝxɣχʁħʕhɦɬɮʋɹɻjɰlɭʎʟ'
_suprasegmentals = 'ˈˌːˑ'
_other_symbols = 'ʍwɥʜʢʡɕʑɺɧ'
_diacrilics = 'ɚ˞ɫ'

_phonemes = sorted(list(
    _vowels + _non_pulmonic_consonants + _pulmonic_consonants
    + _suprasegmentals + _other_symbols + _diacrilics))

_punctuations = "!,-.:;? '()"

_alphabet = 'ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyzäüößÄÖÜ'

all_phonemes = sorted(list(_phonemes) + list(_punctuations))
