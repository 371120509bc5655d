"""Metadata readers: dataset csv → {filename: text}.

Capability parity with the reference registry (data/metadata_readers.py:13-50):
a name-keyed reader registry, the LJSpeech ``name|...|text`` csv format, and
the repo-internal post-processed format whose reader also returns an upsample
list — samples whose text contains ``?`` or ``!`` are repeated 10× for
training.
"""
from pathlib import Path
from typing import Dict, List, Tuple

_READERS = {}


def register_reader(name: str):
    def deco(fn):
        _READERS[name] = fn
        return fn
    return deco


def get_preprocessor_by_name(name: str):
    return _READERS[name.lower()]


@register_reader('ljspeech')
def ljspeech(metadata_path, column_sep: str = '|') -> Dict[str, str]:
    """LJSpeech metadata.csv: ``filename|raw text|normalized text``; the last
    column is used."""
    text_dict = {}
    for line in Path(metadata_path).read_text(encoding='utf-8').splitlines():
        if not line.strip():
            continue
        parts = line.split(column_sep)
        filename = parts[0]
        if filename.endswith('.wav'):
            filename = filename[:-4]
        text_dict[filename] = parts[-1].strip('\n')
    return text_dict


@register_reader('post_processed_reader')
def post_processed_reader(metadata_path, column_sep: str = '|',
                          upsample_indicators: str = '?!',
                          upsample_factor: int = 10
                          ) -> Tuple[Dict[str, str], List[str]]:
    """Repo-written metadata: ``filename|phonemized text``. Returns the text
    dict plus an upsample list with ``upsample_factor`` repeats of every
    sample containing an upsample indicator character."""
    text_dict = {}
    upsample = []
    for line in Path(metadata_path).read_text(encoding='utf-8').splitlines():
        if not line.strip():
            continue
        parts = line.split(column_sep)
        if len(parts) < 2:
            # tolerate a truncated trailing line (interrupted write), like
            # the ljspeech reader does with malformed rows
            continue
        filename, text = parts[0], parts[1].strip('\n')
        if any(ch in text for ch in upsample_indicators):
            upsample.extend([filename] * upsample_factor)
        text_dict[filename] = text
    return text_dict, upsample
