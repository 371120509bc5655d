"""Built-in rule-based English grapheme→IPA fallback.

The reference relies on the espeak C library via the ``phonemizer`` package
(reference: data/text/tokenizer.py:66-74). espeak stays the preferred backend
when present on the host (see ``phonemizer.py``), but this module provides a
dependency-free fallback so the framework is usable end-to-end — synthesis,
preprocessing, and all tests — on machines without espeak.

This is a layered lexicon + letter-to-sound-rules G2P:

- a small exception lexicon of very frequent English words with irregular
  spellings, transcribed in the same IPA inventory as espeak en-us output;
- a CMUdict-class table of a few thousand frequent lemmas authored in
  ARPAbet and mapped to the same inventory, with a morphology layer that
  derives regular inflections (``lexicon_en.py``);
- ordered context-sensitive substring rules for everything else;
- primary stress ``ˈ`` placed on the first vowel of content words when
  ``with_stress`` is requested (table entries carry espeak-style stress
  marks of their own).

Output is restricted to ``symbols.all_phonemes`` so it always tokenizes.
"""
import re
from typing import Dict, List, Tuple

from transformertts_torch.text import lexicon_en

# frequent irregular words (espeak-en-us-like IPA)
_LEXICON: Dict[str, str] = {
    'a': 'ɐ', 'an': 'ɐn', 'the': 'ðə', 'of': 'ʌv', 'to': 'tuː', 'and': 'ænd',
    'in': 'ɪn', 'is': 'ɪz', 'it': 'ɪt', 'you': 'juː', 'that': 'ðæt',
    'he': 'hiː', 'she': 'ʃiː', 'we': 'wiː', 'they': 'ðeɪ', 'was': 'wʌz',
    'for': 'fɔːɹ', 'on': 'ɑːn', 'are': 'ɑːɹ', 'as': 'æz', 'with': 'wɪð',
    'his': 'hɪz', 'her': 'hɜː', 'be': 'biː', 'at': 'æt', 'one': 'wʌn',
    'have': 'hæv', 'has': 'hæz', 'had': 'hæd', 'this': 'ðɪs', 'from': 'fɹʌm',
    'or': 'ɔːɹ', 'by': 'baɪ', 'not': 'nɑːt', 'but': 'bʌt', 'what': 'wʌt',
    'all': 'ɔːl', 'were': 'wɜː', 'when': 'wɛn', 'your': 'jʊɹ', 'can': 'kæn',
    'said': 'sɛd', 'there': 'ðɛɹ', 'use': 'juːz', 'word': 'wɜːd',
    'how': 'haʊ', 'each': 'iːtʃ', 'which': 'wɪtʃ', 'do': 'duː',
    'their': 'ðɛɹ', 'if': 'ɪf', 'will': 'wɪl', 'up': 'ʌp', 'other': 'ʌðɚ',
    'about': 'ɐbaʊt', 'out': 'aʊt', 'many': 'mɛni', 'then': 'ðɛn',
    'them': 'ðɛm', 'these': 'ðiːz', 'so': 'soʊ', 'some': 'sʌm',
    'would': 'wʊd', 'into': 'ˌɪntʊ', 'who': 'huː', 'could': 'kʊd',
    'been': 'bɪn', 'now': 'naʊ', 'my': 'maɪ', 'than': 'ðɐn', 'first': 'fɜːst',
    'water': 'wɔːɾɚ', 'people': 'piːpəl', 'i': 'aɪ', 'me': 'miː',
    'no': 'noʊ', 'us': 'ʌs', 'two': 'tuː', 'more': 'moːɹ', 'go': 'ɡoʊ',
    'say': 'seɪ', 'says': 'sɛz', 'very': 'vɛɹi', 'does': 'dʌz',
    'any': 'ɛni', 'our': 'aʊɚ', 'over': 'oʊvɚ', 'know': 'noʊ',
    'only': 'oʊnli', 'here': 'hɪɹ', 'also': 'ɔːlsoʊ', 'after': 'æftɚ',
    'again': 'ɐɡɛn', 'before': 'bɪfɔːɹ', 'through': 'θɹuː', 'where': 'wɛɹ',
    'should': 'ʃʊd', 'because': 'bɪkʌz', 'come': 'kʌm', 'something': 'sʌmθɪŋ',
    'give': 'ɡɪv', 'day': 'deɪ', 'most': 'moʊst', 'once': 'wʌns',
    'love': 'lʌv', 'done': 'dʌn', 'gone': 'ɡɔn', 'none': 'nʌn',
    'great': 'ɡɹeɪt', 'eye': 'aɪ', 'eyes': 'aɪz', 'heart': 'hɑːɹt',
    'world': 'wɜːld', 'friend': 'fɹɛnd', 'woman': 'wʊmən', 'women': 'wɪmɪn',
    'beautiful': 'bjuːɾɪfəl', 'voice': 'vɔɪs', 'speech': 'spiːtʃ',
    'please': 'pliːz', 'hello': 'həlˈoʊ', 'four': 'fɔːɹ', 'though': 'ðoʊ',
    'thought': 'θɔːt', 'enough': 'ɪnˈʌf', 'laugh': 'læf', 'island': 'aɪlənd',
    'hour': 'aʊɚ', 'honest': 'ɑːnɪst', 'answer': 'ænsɚ', 'often': 'ɔfən',
    'listen': 'lɪsən', 'half': 'hæf', 'talk': 'tɔːk', 'walk': 'wɔːk',
    'live': 'lɪv', 'lives': 'lɪvz', 'weren': 'wɜːn',
    'mr': 'mɪstɚ', 'mrs': 'mɪsɪz', 'dr': 'dɑːktɚ', 'st': 'seɪnt',
    # hard-g before e/i (Germanic stock the soft-g rule would misread)
    'get': 'ɡɛt', 'got': 'ɡɑːt', 'girl': 'ɡɜːl', 'gift': 'ɡɪft',
    'begin': 'bɪɡɪn', 'together': 'təɡɛðɚ', 'forget': 'fɚɡɛt',
    'give': 'ɡɪv', 'gave': 'ɡeɪv',
    # frequent words whose vowels the rules miss
    'measure': 'mɛʒɚ', 'pleasure': 'plɛʒɚ', 'treasure': 'tɹɛʒɚ',
    'sure': 'ʃʊɹ', 'human': 'hjuːmən', 'music': 'mjuːzɪk',
    'computer': 'kəmpjuːɾɚ', 'photo': 'foʊɾoʊ', 'good': 'ɡʊd',
    'foot': 'fʊt', 'put': 'pʊt', 'push': 'pʊʃ', 'pull': 'pʊl',
    'full': 'fʊl', 'move': 'muːv', 'prove': 'pɹuːv', 'above': 'ɐbʌv',
    # FORCE-class oːɹ words (espeak distinguishes oːɹ/ɔːɹ; ARPAbet cannot)
    'affordable': 'əfˈoːɹdəbəl', 'laboratory': 'lˈæbɹətˌoːɹi',
}

# ordered letter-to-sound rules: (pattern at current position, IPA, advance)
# longest-match-first within each leading letter.
_RULES: List[Tuple[str, str]] = [
    # multi-letter consonant clusters / digraphs
    ('tch', 'tʃ'), ('sch', 'sk'), ('ght', 't'),
    ('ch', 'tʃ'), ('sh', 'ʃ'), ('th', 'θ'), ('ph', 'f'), ('wh', 'w'),
    ('ck', 'k'), ('ng', 'ŋ'), ('qu', 'kw'), ('gh', 'ɡ'), ('kn', 'n'),
    ('wr', 'ɹ'), ('mb', 'm'), ('dge', 'dʒ'), ('gn', 'n'), ('ps', 's'),
    ('cc', 'k'), ('ss', 's'), ('ll', 'l'), ('tt', 't'), ('pp', 'p'),
    ('bb', 'b'), ('dd', 'd'), ('ff', 'f'), ('gg', 'ɡ'), ('mm', 'm'),
    ('nn', 'n'), ('rr', 'ɹ'), ('zz', 'z'),
    # vowel teams
    ('eigh', 'eɪ'), ('aigh', 'eɪ'), ('ough', 'ɔː'), ('augh', 'ɔː'),
    ('tion', 'ʃən'), ('sion', 'ʒən'), ('ture', 'tʃɚ'), ('cious', 'ʃəs'),
    ('tious', 'ʃəs'), ('cial', 'ʃəl'), ('tial', 'ʃəl'),
    ('air', 'ɛɹ'), ('are', 'ɛɹ'), ('ear', 'ɪɹ'), ('eer', 'ɪɹ'),
    ('oor', 'ɔːɹ'), ('ore', 'ɔːɹ'), ('our', 'aʊɚ'), ('ure', 'ʊɹ'),
    ('ire', 'aɪɚ'), ('ere', 'ɪɹ'),
    ('all', 'ɔːl'), ('alk', 'ɔːk'), ('ook', 'ʊk'),
    ('ai', 'eɪ'), ('ay', 'eɪ'), ('au', 'ɔː'), ('aw', 'ɔː'),
    ('ea', 'iː'), ('ee', 'iː'), ('ei', 'eɪ'), ('ey', 'eɪ'), ('eu', 'juː'),
    ('ew', 'uː'), ('ie', 'iː'), ('oa', 'oʊ'), ('oe', 'oʊ'), ('oi', 'ɔɪ'),
    ('oy', 'ɔɪ'), ('oo', 'uː'), ('ou', 'aʊ'), ('ow', 'aʊ'), ('ue', 'uː'),
    ('ui', 'uː'), ('uy', 'aɪ'),
    # r-controlled vowels
    ('ar', 'ɑːɹ'), ('er', 'ɚ'), ('ir', 'ɜː'), ('or', 'ɔːɹ'), ('ur', 'ɜː'),
    # single letters
    ('a', 'æ'), ('b', 'b'), ('c', 'k'), ('d', 'd'), ('e', 'ɛ'), ('f', 'f'),
    ('g', 'ɡ'), ('h', 'h'), ('i', 'ɪ'), ('j', 'dʒ'), ('k', 'k'), ('l', 'l'),
    ('m', 'm'), ('n', 'n'), ('o', 'ɑː'), ('p', 'p'), ('r', 'ɹ'),
    ('s', 's'), ('t', 't'), ('u', 'ʌ'), ('v', 'v'), ('w', 'w'),
    ('x', 'ks'), ('y', 'j'), ('z', 'z'),
    # german chars from the reference alphabet
    ('ä', 'ɛ'), ('ö', 'ø'), ('ü', 'y'), ('ß', 's'),
]

_VOWEL_IPA = set('iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻ')

_NUMBER_WORDS = {
    '0': 'zero', '1': 'one', '2': 'two', '3': 'three', '4': 'four',
    '5': 'five', '6': 'six', '7': 'seven', '8': 'eight', '9': 'nine',
}

# Words espeak-ng en-us leaves without a primary stress mark. The core set
# plus every word the frozen fixture (tests/fixtures/espeak_en_us_ipa.tsv)
# attests as unstressed — espeak destresses most function words but DOES
# stress e.g. 'who', 'been', 'did', 'two', 'not', so membership follows the
# attested behavior, not a part-of-speech guess.
_FUNCTION_WORDS = {
    'a', 'an', 'the', 'of', 'to', 'and', 'in', 'is', 'it', 'that', 'as',
    'at', 'on', 'or', 'by', 'for', 'but', 'if', 'so', 'was', 'be',
    'you', 'his', 'they', 'this', 'have', 'from', 'one', 'had', 'what',
    'all', 'were', 'when', 'your', 'can', 'said', 'there', 'each', 'which',
    'she', 'how', 'will', 'then', 'them', 'these', 'some', 'her', 'would',
    'him', 'into', 'has', 'could', 'my', 'than', 'get', 'with',
}


def _apply_rules(word: str) -> str:
    out = []
    i = 0
    n = len(word)
    while i < n:
        # multi-letter teams outrank the soft-c/g letter rules ('cial' in
        # "special" must beat soft-c), single letters come after them
        multi = next((r for r in _RULES
                      if len(r[0]) > 1 and word.startswith(r[0], i)), None)
        # soft c / soft g before e, i, y
        if multi is None and word[i] == 'c' and i + 1 < n and word[i + 1] in 'eiy':
            out.append('s')
            i += 1
            continue
        if multi is None and word[i] == 'g' and i + 1 < n and word[i + 1] in 'eiy' and not word.startswith('gg', i):
            out.append('dʒ')
            i += 1
            continue
        # magic-e: vowel + consonant + final e → long vowel. NOT before r:
        # 'are/ere/ire/ore/ure' are r-controlled (care, store), handled by
        # the vowel-team rules below.
        if (i + 2 == n - 1 and word[i] in 'aeiouy'
                and word[i + 1] not in 'aeiour'
                and word[n - 1] == 'e'):
            long_map = {'a': 'eɪ', 'e': 'iː', 'i': 'aɪ', 'o': 'oʊ',
                        'u': 'juː', 'y': 'aɪ'}
            out.append(long_map[word[i]])
            i += 1
            continue
        # final silent e
        if i == n - 1 and word[i] == 'e' and n > 2:
            i += 1
            continue
        # final consonant+'le' → əl (little, table; NOT style — vowel+le is
        # magic-e territory handled above)
        if (i + 2 == n and word[i] == 'l' and word[n - 1] == 'e' and n > 3
                and word[i - 1] not in 'aeiouy'):
            out.append('əl')
            i = n
            continue
        # final y: aɪ in monosyllables (try, my, sky), i elsewhere (city)
        if i == n - 1 and word[i] == 'y' and n > 1:
            out.append('aɪ' if not any(c in 'aeiouy' for c in word[:i])
                       else 'i')
            i += 1
            continue
        for pat, ipa in _RULES:
            if word.startswith(pat, i):
                out.append(ipa)
                i += len(pat)
                break
        else:
            i += 1  # unknown char: drop
    return ''.join(out)


_UNSTRESSABLE = set('əɐɚᵻ')  # espeak never places primary stress on schwa


def _add_stress(ipa: str) -> str:
    first = None
    for k, ch in enumerate(ipa):
        if ch in _VOWEL_IPA:
            if first is None:
                first = k
            if ch not in _UNSTRESSABLE:
                return ipa[:k] + 'ˈ' + ipa[k:]
    if first is not None:  # all-schwa word: stress the first vowel anyway
        return ipa[:first] + 'ˈ' + ipa[first:]
    return ipa


def g2p_word_path(word: str) -> str:
    """Which branch ``g2p_word`` takes: 'lexicon', 'lexicon_possessive',
    'cmudict', 'cmudict_inflected' or 'rules'. Used by
    scripts/measure_g2p_fidelity.py to report how much of a corpus is
    covered by the lexicon layers vs the letter-to-sound rules."""
    word = word.lower()
    if word in _LEXICON:
        return 'lexicon'
    if word.endswith("'s") and word[:-2] in _LEXICON:
        return 'lexicon_possessive'
    hit = lexicon_en.lookup(word, extra=_LEXICON)
    if hit is not None:
        return hit[1]
    return 'rules'


def g2p_word(word: str, with_stress: bool = True) -> str:
    word = word.lower()
    stressed = None      # table entries carry their own espeak-style marks
    if word in _LEXICON:
        ipa = _LEXICON[word]
    elif word.endswith("'s") and word[:-2] in _LEXICON:
        ipa = _LEXICON[word[:-2]] + 'z'
    else:
        hit = lexicon_en.lookup(word, extra=_LEXICON)
        if hit is not None:
            stressed = hit[0]
        else:
            ipa = _apply_rules(word.replace("'", ''))
    if stressed is not None:
        if not with_stress:
            return stressed.replace('ˈ', '').replace('ˌ', '')
        if 'ˈ' not in stressed and word not in _FUNCTION_WORDS:
            # derived from a curated (mark-less) base, e.g. 'goes' <- 'go'
            stressed = _add_stress(stressed)
        return stressed
    if not with_stress:
        # a few curated entries carry espeak-attested marks ('into' ˌɪntʊ)
        return ipa.replace('ˈ', '').replace('ˌ', '')
    if 'ˈ' not in ipa and word not in _FUNCTION_WORDS:
        ipa = _add_stress(ipa)
    return ipa


_TOKEN_RE = re.compile(r"[a-zA-ZäöüßÄÖÜ']+|\d|[^\sa-zA-ZäöüßÄÖÜ\d']")


def g2p_sentence(text: str, with_stress: bool = True) -> str:
    """Phonemize a sentence with the builtin rules; keeps punctuation chars."""
    parts = []
    for tok in _TOKEN_RE.findall(text):
        if tok[0].isalpha() or tok[0] == "'":
            parts.append(g2p_word(tok, with_stress=with_stress))
        elif tok.isdigit():
            parts.append(g2p_word(_NUMBER_WORDS[tok], with_stress=with_stress))
        else:
            # punctuation is passed through; the phonemizer postprocess
            # filters to the known symbol set.
            if parts:
                parts[-1] = parts[-1] + tok
            else:
                parts.append(tok)
    return ' '.join(parts)
