"""The port's text frontend (its own copy of the JAX package's) gives the JAX
package's phonemes and tokens: on config/test_sentences.txt, with and without
stress and breathing tokens, and on every word of the G2P fixture."""
from pathlib import Path

import pytest

from transformertts_torch.text import TextToTokens
from transformertts_torch.text import g2p
from transformertts_torch.text.phonemizer import Phonemizer
from transformertts_torch.text.tokenizer import Tokenizer

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / 'tests' / 'fixtures' / 'espeak_en_us_ipa.tsv'


def _sentences():
    lines = (ROOT / 'config' / 'test_sentences.txt').read_text(encoding='utf-8').splitlines()
    return [l for l in lines if l.strip()]


def _fixture_words():
    return [line.split('\t')[0] for line in FIXTURE.read_text(encoding='utf-8').splitlines()
            if line.strip() and not line.startswith('#')]


@pytest.mark.parametrize('with_stress,model_breathing', [(True, False), (False, True)])
def test_text_to_tokens_matches_jax(with_stress, model_breathing):
    from transformertts_tpu.text import TextToTokens as JTextToTokens
    kwargs = dict(language='en-us', add_start_end=True, with_stress=with_stress,
                  model_breathing=model_breathing)
    mine, ref = TextToTokens.default(**kwargs), JTextToTokens.default(**kwargs)
    sentences = _sentences()
    assert mine.phonemizer(sentences) == ref.phonemizer(sentences)
    for sentence in sentences:
        assert mine(sentence) == ref(sentence)


def test_phonemizer_and_tokenizer_match_jax_on_fixture_words():
    from transformertts_tpu.text import g2p as jg2p
    from transformertts_tpu.text.phonemizer import Phonemizer as JPhonemizer
    from transformertts_tpu.text.tokenizer import Tokenizer as JTokenizer
    words = _fixture_words()
    assert len(words) >= 150
    assert [g2p.g2p_word(w) for w in words] == [jg2p.g2p_word(w) for w in words]
    phon, jphon = (P(language='en-us', with_stress=True, njobs=1)
                   for P in (Phonemizer, JPhonemizer))
    phonemes = phon(words)
    assert phonemes == jphon(words)
    tok, jtok = Tokenizer(add_start_end=False), JTokenizer(add_start_end=False)
    assert tok.alphabet == jtok.alphabet
    assert [tok(p) for p in phonemes] == [jtok(p) for p in phonemes]
    assert all(0 not in tok(p) for p in phonemes if p)
