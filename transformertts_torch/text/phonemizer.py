"""Host-side phonemization (grapheme → IPA).

Mirrors the reference frontend semantics (data/text/tokenizer.py:50-106):
hyphen protection, punctuation preservation, unknown-symbol filtering and
whitespace collapsing — but with pluggable backends:

- ``espeak``: shells out to the espeak/espeak-ng binary when present
  (the reference used the espeak C library through the ``phonemizer``
  package; the subprocess keeps the same host-side boundary).
- ``builtin``: dependency-free rule-based G2P (``g2p.py``).

Backend is auto-detected unless forced.
"""
import re
import shutil
import subprocess
from functools import lru_cache
from typing import Callable, Union

from transformertts_torch.text.symbols import all_phonemes, _punctuations
from transformertts_torch.text import g2p

_KNOWN_SYMBOLS = frozenset(all_phonemes)
# clauses per espeak invocation: large enough that process spawn is
# amortized to noise, small enough to keep invocations streaming
ESPEAK_CHUNK = 500
# one or more whitespace chars, optionally hugging a punctuation mark
_WS = re.compile(r'\s+')
_WS_AROUND_PUNCT = re.compile(r'\s*([' + _punctuations + r'])\s*')


@lru_cache(maxsize=1)
def _find_espeak() -> str:
    for name in ('espeak-ng', 'espeak'):
        path = shutil.which(name)
        if path:
            return path
    return ''


def _per_string(fn: Callable[[str], str], text: Union[str, list]
                ) -> Union[str, list]:
    """Apply ``fn`` to a string or elementwise to a list of strings."""
    if isinstance(text, str):
        return fn(text)
    if isinstance(text, list):
        return [fn(t) for t in text]
    raise TypeError(f'phonemizer input must be list or str, not {type(text)}')


class Phonemizer:

    def __init__(self, language: str, with_stress: bool, njobs: int = 4, backend: str = 'auto'):
        self.language = language
        self.njobs = njobs
        self.with_stress = with_stress
        self.special_hyphen = '—'
        self.punctuation = ';:,.!?¡¿—…"«»“”'
        if backend == 'auto':
            backend = 'espeak' if _find_espeak() else 'builtin'
        if backend == 'espeak' and not _find_espeak():
            raise RuntimeError('espeak backend requested but no espeak binary found on host')
        self.backend = backend

    def __call__(self, text: Union[str, list], with_stress=None, njobs=None,
                 language=None) -> Union[str, list]:
        language = language or self.language
        with_stress = self.with_stress if with_stress is None else with_stress
        njobs = self.njobs if njobs is None else njobs
        text = _per_string(self._shield_hyphens, text)
        if isinstance(text, list) and self.backend == 'espeak':
            # corpus path: ALL clauses of all texts go through a handful of
            # chunked espeak invocations instead of one process per clause —
            # at LJSpeech scale (13k clips × several clauses) process-spawn
            # overhead would otherwise dominate stage 1 (the reference used
            # the in-process espeak C library; data/text/tokenizer.py:66-74)
            phonemes = self._espeak_many(text, language, with_stress,
                                         njobs=njobs)
        else:
            phonemes = _per_string(
                lambda t: self._phonemize_string(t, language, with_stress),
                text)
        return _per_string(self._clean_phonemes, phonemes)

    # backends ---------------------------------------------------------------

    def _phonemize_string(self, text: str, language: str, with_stress: bool) -> str:
        if self.backend == 'espeak':
            return self._espeak(text, language, with_stress)
        return g2p.g2p_sentence(text, with_stress=with_stress)

    def _split_segments(self, text: str) -> list:
        """Split into ('punct', mark) / ('clause', words) segments, keeping
        order; espeak drops punctuation so it must be re-attached."""
        parts = re.split(f'([{re.escape(self.punctuation)}])', text)
        segs = []
        for part in parts:
            if not part.strip():
                continue
            kind = 'punct' if part in self.punctuation else 'clause'
            segs.append((kind, part))
        return segs

    def _espeak_lines(self, clauses: list, language: str,
                      with_stress: bool) -> list:
        """IPA for each clause, one espeak invocation per ESPEAK_CHUNK
        clauses (newline-separated stdin; espeak emits one IPA line per
        input line). Falls back to one invocation per clause if the output
        line count disagrees — that pairing is observed espeak behavior,
        not a documented contract."""
        binary = _find_espeak()
        out: list = []
        for start in range(0, len(clauses), ESPEAK_CHUNK):
            chunk = clauses[start:start + ESPEAK_CHUNK]
            # newlines inside a clause would desync the line pairing
            chunk = [c.replace('\n', ' ') for c in chunk]
            result = subprocess.run(
                [binary, '-q', '--ipa', '-v', language, '--stdin'],
                input='\n'.join(chunk),
                capture_output=True, text=True, check=True)
            # keep EMPTY lines: they carry pairing information. Filtering
            # them out would let a clause that emits nothing compensate for
            # a clause that splits into two lines, mis-pairing the rest of
            # the chunk while the total count still matches.
            lines = [s.strip() for s in result.stdout.split('\n')]
            while lines and not lines[-1]:  # trailing newline(s) of stdout
                lines.pop()
            if len(lines) != len(chunk) or not all(lines):
                # pairing broke (count mismatch, or some clause produced an
                # empty line — suspicious for non-empty input either way):
                # re-run this chunk one clause per process
                lines = []
                for clause in chunk:
                    r = subprocess.run(
                        [binary, '-q', '--ipa', '-v', language, clause],
                        capture_output=True, text=True, check=True)
                    lines.append(r.stdout.strip().replace('\n', ' '))
            out.extend(lines)
        if not with_stress:
            out = [ipa.replace('ˈ', '').replace('ˌ', '') for ipa in out]
        return out

    def _espeak(self, text: str, language: str, with_stress: bool) -> str:
        """One text: all its clauses in a single espeak invocation."""
        segs = self._split_segments(text)
        clauses = [s for kind, s in segs if kind == 'clause']
        ipa = iter(self._espeak_lines(clauses, language, with_stress))
        return ' '.join(next(ipa) if kind == 'clause' else s
                        for kind, s in segs)

    def _espeak_many(self, texts: list, language: str, with_stress: bool,
                     njobs: int = 1) -> list:
        """Corpus batch: flatten every text's clauses into chunked espeak
        invocations (thread-parallel across chunks — the wait is in the
        subprocess, so threads suffice), then reassemble per text."""
        all_segs = [self._split_segments(t) for t in texts]
        flat = [c for segs in all_segs
                for kind, c in segs if kind == 'clause']
        if njobs > 1 and len(flat) > ESPEAK_CHUNK:
            from concurrent.futures import ThreadPoolExecutor
            chunks = [flat[s:s + ESPEAK_CHUNK]
                      for s in range(0, len(flat), ESPEAK_CHUNK)]
            with ThreadPoolExecutor(max_workers=njobs) as pool:
                results = pool.map(
                    lambda ch: self._espeak_lines(ch, language, with_stress),
                    chunks)
            ipa_flat: list = []
            for r in results:
                ipa_flat.extend(r)
        else:
            ipa_flat = self._espeak_lines(flat, language, with_stress)
        it = iter(ipa_flat)
        return [' '.join(next(it) if kind == 'clause' else s
                         for kind, s in segs)
                for segs in all_segs]

    # pre/post-processing (reference-parity semantics) ------------------------

    def _shield_hyphens(self, text: str) -> str:
        # phonemization backends treat '-' as a word break; stand in an
        # em-dash (which survives as punctuation) and swap it back after
        return text.replace('-', self.special_hyphen)

    def _clean_phonemes(self, text: str) -> str:
        """Restore hyphens, drop out-of-inventory symbols, normalize spacing.

        Spacing rule: runs of whitespace become one space, and whitespace
        touching a punctuation mark is absorbed into it (``a , b`` → ``a,b``).
        """
        text = text.replace(self.special_hyphen, '-')
        text = ''.join(c for c in text if c in _KNOWN_SYMBOLS)
        text = _WS_AROUND_PUNCT.sub(r'\1', _WS.sub(' ', text))
        return text.strip()
