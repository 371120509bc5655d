"""Datasets + length-bucketed batching for training: the port's copy of
``transformertts_tpu/data/datasets.py`` (host code; it imports no jax).

Capability parity with the reference pipeline (data/datasets.py:19-284):
``DataReader`` (metadata kinds original/phonemized/train/valid, with
``?!``-upsampling for training), ``AlignerPreprocessor`` (start/end mel
vectors + stop-probability targets), ``TTSPreprocessor`` (tokenized phonemes
+ mel/durations/char-pitch), per-sample ``.npy`` artifact loading, and a
seeded length-bucketed batcher with an infinite ``next_batch()`` and a finite
``all_batches()``.

TPU-first re-design (vs. tf.data bucket_by_sequence_length):
- every batch has a **fully static shape**: the mel/time axis is padded to
  the *bucket boundary* (not the ragged batch max) and the token axis to a
  multiple of ``TOKEN_PAD``. With B buckets the whole training run compiles
  at most B×(few token widths) executables, then reuses them — the XLA
  equivalent of the reference's signature management.
- batches are plain numpy dicts; sharding/transfer happens once per step in
  the trainer (parallel/mesh.py).
- a background thread prefetches batches so host .npy loading overlaps with
  device steps (the reference's generator feeds synchronously).
"""
import queue
import threading
import time
from pathlib import Path
from random import Random
from typing import Callable, Dict, List, Sequence, Union

import numpy as np

from transformertts_torch.data.metadata import get_preprocessor_by_name
from transformertts_torch.text.tokenizer import Tokenizer

TOKEN_PAD = 32
# overflow-bucket frame axes round up to this multiple; coarse on purpose so
# out-of-range clips cannot mint a new compiled executable per unique length
OVERFLOW_PAD = 256
# soft ceiling on distinct (frames, tokens) batch shapes per dataset before a
# warning is logged — each distinct shape is one XLA executable per step fn
MAX_DISTINCT_SHAPES = 24


def get_files(path: Union[Path, str], extension: str = '.wav') -> List[Path]:
    path = Path(path).expanduser().resolve()
    return sorted(path.rglob(f'*{extension}'))


class DataReader:
    """Filenames + texts from a metadata file.

    kind ∈ {original, phonemized, train, valid}; training readers extend the
    filename list with the upsample set (reference data/datasets.py:19-72).
    """

    def __init__(self, wav_directory, metadata_path, metadata_reading_function,
                 scan_wavs: bool = False, training: bool = False,
                 is_processed: bool = False):
        self.wav_directory = Path(wav_directory)
        self.metadata_path = Path(metadata_path)
        if is_processed:
            self.text_dict, self.upsample = metadata_reading_function(metadata_path)
            self.filenames = list(self.text_dict.keys())
            if training:
                self.filenames += self.upsample
        else:
            self.text_dict = metadata_reading_function(metadata_path)
            self.filenames = list(self.text_dict.keys())
        if scan_wavs:
            wavs = get_files(self.wav_directory, '.wav')
            self.wav_paths = {w.with_suffix('').name: w for w in wavs}

    @classmethod
    def from_config(cls, config_manager, kind: str, scan_wavs: bool = False):
        kinds = ['original', 'phonemized', 'train', 'valid']
        if kind not in kinds:
            raise ValueError(f'invalid kind {kind}; expected one of {kinds}')
        reader = get_preprocessor_by_name('post_processed_reader')
        training = kind == 'train'
        is_processed = kind != 'original'
        metadata = {
            'original': config_manager.metadata_path,
            'train': config_manager.train_metadata_path,
            'valid': config_manager.valid_metadata_path,
            'phonemized': config_manager.phonemized_metadata_path,
        }[kind]
        if kind == 'original':
            reader = get_preprocessor_by_name(config_manager.config['data_name'])
        return cls(wav_directory=config_manager.wav_directory,
                   metadata_path=metadata, metadata_reading_function=reader,
                   scan_wavs=scan_wavs, training=training,
                   is_processed=is_processed)


class AlignerPreprocessor:
    """mel → [start_vec, mel, end_vec]; stop targets 1…1,2; tokenized text
    (reference data/datasets.py:75-103)."""

    def __init__(self, mel_channels: int, mel_start_value: float,
                 mel_end_value: float, tokenizer: Tokenizer):
        self.mel_channels = mel_channels
        self.start_vec = np.full((1, mel_channels), mel_start_value, np.float32)
        self.end_vec = np.full((1, mel_channels), mel_end_value, np.float32)
        self.tokenizer = tokenizer

    def __call__(self, mel: np.ndarray, text: str, sample_name: str) -> dict:
        tokens = np.asarray(self.tokenizer(text), np.int32)
        norm_mel = np.concatenate([self.start_vec, mel.astype(np.float32),
                                   self.end_vec], axis=0)
        stop_probs = np.ones((norm_mel.shape[0],), np.int32)
        stop_probs[-1] = 2
        return {'mel': norm_mel, 'tokens': tokens, 'stop_probs': stop_probs,
                'fname': sample_name}

    @staticmethod
    def sample_length(sample: dict) -> int:
        return sample['mel'].shape[0]

    @classmethod
    def from_config(cls, config_manager, tokenizer: Tokenizer):
        c = config_manager.config
        return cls(c['mel_channels'], c['mel_start_value'], c['mel_end_value'],
                   tokenizer)


class TTSPreprocessor:
    """Tokenized phonemes + mel + durations + char-level pitch
    (reference data/datasets.py:153-169)."""

    def __init__(self, mel_channels: int, tokenizer: Tokenizer):
        self.mel_channels = mel_channels
        self.tokenizer = tokenizer

    def __call__(self, mel, text, durations, pitch, sample_name) -> dict:
        tokens = np.asarray(self.tokenizer(text), np.int32)
        return {'mel': mel.astype(np.float32), 'tokens': tokens,
                'durations': np.asarray(durations, np.float32),
                'pitch': np.asarray(pitch, np.float32),
                'fname': sample_name}

    @staticmethod
    def sample_length(sample: dict) -> int:
        return sample['mel'].shape[0]

    @classmethod
    def from_config(cls, config_manager, tokenizer: Tokenizer):
        return cls(config_manager.config['mel_channels'], tokenizer)


class AlignerDataset:
    """Loads mel ``.npy`` artifacts + metadata text per sample."""

    def __init__(self, data_reader: DataReader, preprocessor: AlignerPreprocessor,
                 mel_directory):
        self.data_reader = data_reader
        self.preprocessor = preprocessor
        self.mel_directory = Path(mel_directory)

    def _process_sample(self, sample_name: str) -> dict:
        text = self.data_reader.text_dict[sample_name]
        mel = np.load(self.mel_directory / f'{sample_name}.npy')
        return self.preprocessor(mel=mel, text=text, sample_name=sample_name)

    def get_dataset(self, bucket_batch_sizes, bucket_boundaries,
                    shuffle=True, drop_remainder=False, seed=42,
                    prefetch: int = 4) -> 'BucketedDataset':
        return BucketedDataset(
            samples=self.data_reader.filenames,
            load_fn=self._process_sample,
            len_fn=self.preprocessor.sample_length,
            mel_channels=self.preprocessor.mel_channels,
            bucket_boundaries=bucket_boundaries,
            bucket_batch_sizes=bucket_batch_sizes,
            shuffle=shuffle, drop_remainder=drop_remainder, seed=seed,
            prefetch=prefetch)

    @classmethod
    def from_config(cls, config_manager, preprocessor, kind: str,
                    mel_directory=None):
        if mel_directory is None:
            mel_directory = config_manager.mel_dir
        reader = DataReader.from_config(config_manager, kind=kind)
        return cls(reader, preprocessor, mel_directory)


class TTSDataset:
    """Loads mel/durations/char-pitch ``.npy`` artifacts per sample."""

    def __init__(self, data_reader: DataReader, preprocessor: TTSPreprocessor,
                 mel_directory, duration_directory, pitch_per_char_directory):
        self.data_reader = data_reader
        self.preprocessor = preprocessor
        self.mel_directory = Path(mel_directory)
        self.duration_directory = Path(duration_directory)
        self.pitch_per_char_directory = Path(pitch_per_char_directory)

    def _process_sample(self, sample_name: str) -> dict:
        text = self.data_reader.text_dict[sample_name]
        mel = np.load(self.mel_directory / f'{sample_name}.npy')
        durations = np.load(self.duration_directory / f'{sample_name}.npy')
        pitch = np.load(self.pitch_per_char_directory / f'{sample_name}.npy')
        return self.preprocessor(mel=mel, text=text, durations=durations,
                                 pitch=pitch, sample_name=sample_name)

    def get_dataset(self, bucket_batch_sizes, bucket_boundaries,
                    shuffle=True, drop_remainder=False, seed=42,
                    prefetch: int = 4) -> 'BucketedDataset':
        return BucketedDataset(
            samples=self.data_reader.filenames,
            load_fn=self._process_sample,
            len_fn=self.preprocessor.sample_length,
            mel_channels=self.preprocessor.mel_channels,
            bucket_boundaries=bucket_boundaries,
            bucket_batch_sizes=bucket_batch_sizes,
            shuffle=shuffle, drop_remainder=drop_remainder, seed=seed,
            prefetch=prefetch)

    @classmethod
    def from_config(cls, config_manager, preprocessor, kind: str,
                    mel_directory=None, duration_directory=None,
                    pitch_per_char_directory=None):
        if mel_directory is None:
            mel_directory = config_manager.mel_dir
        if duration_directory is None:
            duration_directory = config_manager.duration_dir
        if pitch_per_char_directory is None:
            pitch_per_char_directory = config_manager.pitch_per_char
        reader = DataReader.from_config(config_manager, kind=kind)
        return cls(reader, preprocessor, mel_directory, duration_directory,
                   pitch_per_char_directory)


class BucketedDataset:
    """Length-bucketed host batcher with static padded shapes.

    Semantics mirror the reference ``Dataset`` (data/datasets.py:238-284):
    seeded epoch shuffle, samples assigned to the first bucket whose boundary
    exceeds their length, per-bucket batch sizes, infinite ``next_batch()``
    cycling epochs, finite ``all_batches()``.

    Shape policy (TPU): time axes pad to the assigned bucket boundary; token
    axes pad to a multiple of TOKEN_PAD. drop_remainder drops ragged final
    bucket batches (default keeps them, padded with all-zero samples that the
    masked losses ignore).
    """

    def __init__(self, samples: Sequence[str], load_fn: Callable[[str], dict],
                 len_fn: Callable[[dict], int], mel_channels: int,
                 bucket_boundaries: Sequence[int],
                 bucket_batch_sizes: Sequence[int], shuffle: bool = True,
                 drop_remainder: bool = False, seed: int = 42,
                 prefetch: int = 4):
        assert len(bucket_batch_sizes) == len(bucket_boundaries) + 1
        self._random = Random(seed)
        self.samples = list(samples)
        self.load_fn = load_fn
        self.len_fn = len_fn
        self.mel_channels = mel_channels
        self.bucket_boundaries = list(bucket_boundaries)
        self.bucket_batch_sizes = list(bucket_batch_sizes)
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self._iter = None
        self._shapes_seen: set = set()
        # loader-headroom instrumentation: cumulative time next_batch spent
        # blocked waiting on an empty prefetch queue (0 ⇒ the loader thread
        # always stays ahead of the training step)
        self._input_wait_s = 0.0
        self._input_waits = 0

    def take_input_wait_ms(self) -> float:
        """Read-and-reset the accumulated input-stall time (milliseconds).

        Logged by the train CLIs as Meta/input_wait_ms; a persistently
        nonzero value means the single loader thread cannot keep up with
        the device step and prefetch/loader parallelism should rise."""
        ms = self._input_wait_s * 1000.0
        self._input_wait_s = 0.0
        self._input_waits = 0
        return ms

    # ------------------------------------------------------------- internals

    def _bucket_index(self, length: int) -> int:
        for i, boundary in enumerate(self.bucket_boundaries):
            if length <= boundary:
                return i
        return len(self.bucket_boundaries)

    def _bucket_frame_budget(self, bucket_idx: int, max_len: int) -> int:
        if bucket_idx < len(self.bucket_boundaries):
            return self.bucket_boundaries[bucket_idx]
        # overflow bucket: round up to a coarse multiple to bound the number
        # of distinct compiled shapes
        return -(-max_len // OVERFLOW_PAD) * OVERFLOW_PAD

    def _collate(self, bucket_idx: int, items: List[dict]) -> dict:
        batch_size = self.bucket_batch_sizes[bucket_idx]
        max_mel = max(self.len_fn(s) for s in items)
        frames = self._bucket_frame_budget(bucket_idx, max_mel)
        frames = max(frames, max_mel)
        max_tok = max(len(s['tokens']) for s in items)
        tokens_len = -(-max_tok // TOKEN_PAD) * TOKEN_PAD
        shape_key = (batch_size, frames, tokens_len)
        if shape_key not in self._shapes_seen:
            self._shapes_seen.add(shape_key)
            if len(self._shapes_seen) > MAX_DISTINCT_SHAPES:
                print(f'WARNING: dataset has emitted '
                      f'{len(self._shapes_seen)} distinct batch shapes '
                      f'(latest {shape_key}); each costs one XLA compile per '
                      f'step fn — consider coarser buckets')
        out: Dict[str, np.ndarray] = {}
        out['mel'] = np.zeros((batch_size, frames, self.mel_channels), np.float32)
        out['tokens'] = np.zeros((batch_size, tokens_len), np.int32)
        fnames = []
        has_stop = 'stop_probs' in items[0]
        has_dur = 'durations' in items[0]
        if has_stop:
            out['stop_probs'] = np.zeros((batch_size, frames), np.int32)
        if has_dur:
            out['durations'] = np.zeros((batch_size, tokens_len), np.float32)
            out['pitch'] = np.zeros((batch_size, tokens_len), np.float32)
        for i, s in enumerate(items):
            t = s['mel'].shape[0]
            n = len(s['tokens'])
            out['mel'][i, :t] = s['mel']
            out['tokens'][i, :n] = s['tokens']
            if has_stop:
                out['stop_probs'][i, :t] = s['stop_probs']
            if has_dur:
                d = np.asarray(s['durations']).reshape(-1)[:tokens_len]
                p = np.asarray(s['pitch']).reshape(-1)[:tokens_len]
                out['durations'][i, :len(d)] = d
                out['pitch'][i, :len(p)] = p
            fnames.append(s['fname'])
        out['fname'] = np.asarray(fnames + [''] * (batch_size - len(items)))
        return out

    def _epoch_batches(self):
        names = self.samples[:]
        if self.shuffle:
            self._random.shuffle(names)
        pending: Dict[int, List[dict]] = {}
        for name in names:
            sample = self.load_fn(name)
            b = self._bucket_index(self.len_fn(sample))
            pending.setdefault(b, []).append(sample)
            if len(pending[b]) == self.bucket_batch_sizes[b]:
                yield self._collate(b, pending.pop(b))
        if not self.drop_remainder:
            for b, items in sorted(pending.items()):
                yield self._collate(b, items)

    def _prefetched(self, gen):
        if self.prefetch <= 0:
            yield from gen
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        DONE = object()

        def worker():
            try:
                for item in gen:
                    q.put(item)
                q.put(DONE)
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                # a worker failure (e.g. missing .npy) must surface in the
                # consumer, not silently truncate the epoch as an early DONE
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                t0 = time.perf_counter()
                item = q.get()
                self._input_wait_s += time.perf_counter() - t0
                self._input_waits += 1
            if item is DONE:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    # ------------------------------------------------------------------- API

    def next_batch(self) -> dict:
        """Infinite iterator over epochs (reference next_batch)."""
        empty_epochs = 0
        while True:
            if self._iter is None:
                self._iter = self._prefetched(self._epoch_batches())
            try:
                return next(self._iter)
            except StopIteration:
                self._iter = None
                # an epoch with zero batches (empty/mis-pathed metadata)
                # would otherwise busy-loop forever spawning prefetchers
                empty_epochs += 1
                if empty_epochs >= 2:
                    raise RuntimeError(
                        'dataset produced no batches — empty sample list? '
                        f'({len(self.samples)} samples)')

    def all_batches(self):
        """One full pass, in order (reference all_batches)."""
        return self._prefetched(self._epoch_batches())
