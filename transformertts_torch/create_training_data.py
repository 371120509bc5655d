"""Stage-1 CLI: featurize a dataset with the PyTorch port.

    python -m transformertts_torch.create_training_data --config <session.yaml> \
        [--device cuda|cpu] [--workers N] [--skip_mels] [--skip_phonemes]

The counterpart of the root ``create_training_data.py``, writing the same
files: host worker processes (a ``spawn`` pool, which never touches CUDA)
load, resample, volume-normalize and VAD-trim each clip; clips sorted by
file size go to the device in buckets of 16, reflect-padded by n_fft//2 on
the host and zero-padded to a multiple of ``WAV_BUCKET``, and each bucket
takes one ``Audio.log_mel_batch_centered`` call (the fused log-mel kernel,
K5, on a CUDA device) and one batched ``yin_f0`` call. Mels outside
[min_mel_len, max_mel_len] frames are dropped; the pitch of the kept clips is
normalized by the corpus mean and std of its voiced frames (zeros stay
zero), saved in ``pitch_stats.pkl``; the texts are phonemized and split into
train and valid metadata by ``Random(42)``.
"""
import argparse
import multiprocessing
import pickle
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from random import Random

import numpy as np
import torch
import tqdm

from transformertts_torch.audio import Audio
from transformertts_torch.audio.pitch import yin_f0
from transformertts_torch.data.datasets import DataReader
from transformertts_torch.text.phonemizer import Phonemizer
from transformertts_torch.utils.config import TrainingConfigManager

WAV_BUCKET = 256 * 256  # padded wav lengths are multiples of this (about 3 s)
BATCH = 16              # clips a device call

_AUDIO = None


def _init_worker(audio_config):
    global _AUDIO
    _AUDIO = Audio.from_config(audio_config)


def _load_and_trim(args):
    name, path = args
    try:
        y, _ = _AUDIO.load_wav(path, preprocess=True)
        return name, y.astype(np.float32)
    except Exception as e:   # a broken file is reported and skipped, as in the JAX CLI
        print(f'skipping {name}: {e}', file=sys.stderr)
        return name, None


def featurize_batch(audio: Audio, names, wavs, mel_dir: Path, pitch_dir: Path,
                    min_len: int, max_len: int, device):
    """Mel and pitch of one bucket of clips on ``device``; saves the mels and
    raw pitch of the clips within [min_len, max_len] frames and returns their
    names and raw pitch by name (normalized later over the corpus)."""
    hop, n_fft = audio.hop_length, audio.n_fft
    frames = [1 + len(w) // hop for w in wavs]
    # host reflect padding (the STFT's centring), then zeros to the bucket:
    # the frames in each clip's range see exactly its own samples
    target = -(-max(len(w) + n_fft for w in wavs) // WAV_BUCKET) * WAV_BUCKET
    centered = np.zeros((len(wavs), target), np.float32)
    plain = np.zeros((len(wavs), target), np.float32)
    for i, w in enumerate(wavs):
        c = np.pad(w, n_fft // 2, mode='reflect')
        centered[i, :len(c)] = c
        plain[i, :len(w)] = w
    mel = audio.log_mel_batch_centered(torch.as_tensor(centered, device=device))
    pitch = yin_f0(torch.as_tensor(plain, device=device), audio.sampling_rate, hop)
    mel, pitch = mel.cpu().numpy(), pitch.cpu().numpy()

    kept, pitches = [], {}
    for i, name in enumerate(names):
        m, p = mel[i, :frames[i]], pitch[i, :frames[i]]
        if not min_len <= m.shape[0] <= max_len:
            continue
        np.save(mel_dir / f'{name}.npy', m.astype(np.float32))
        np.save(pitch_dir / f'{name}.npy', p.astype(np.float32))
        kept.append(name)
        pitches[name] = p
    return kept, pitches


def main(argv=None) -> dict:
    """Runs stage 1; returns the kept clip count, the wall time of the mel and
    pitch pass and the part of it spent in ``featurize_batch`` (padding, the
    device calls, saving), the rest being the wait for the host workers."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', type=str, required=True)
    parser.add_argument('--skip_mels', action='store_true')
    parser.add_argument('--skip_phonemes', action='store_true')
    parser.add_argument('--workers', type=int, default=None)
    parser.add_argument('--device', default='cuda',
                        help="torch device to featurize on: 'cuda' (the kernels) or 'cpu'")
    args = parser.parse_args(argv)
    device = torch.device(args.device)

    # the aligner's config, as the JAX CLI: data prep needs only its section
    cm = TrainingConfigManager(args.config, aligner=True)
    cm.create_remove_dirs(assume_yes=True)
    config = cm.config
    audio = Audio.from_config(config)

    reader = DataReader.from_config(cm, kind='original', scan_wavs=True)
    names = [n for n in reader.filenames if n in reader.wav_paths]
    # by size on disk (about the duration), so a bucket holds similar lengths
    names.sort(key=lambda n: reader.wav_paths[n].stat().st_size)
    print(f'{len(names)} wavs found')
    stats = {}

    if not args.skip_mels:
        min_len, max_len = int(config['min_mel_len']), int(config['max_mel_len'])
        kept_names, all_pitch = [], {}

        def featurize(pending) -> float:
            t0 = time.perf_counter()
            k, p = featurize_batch(audio, [n for n, _ in pending], [w for _, w in pending],
                                   cm.mel_dir, cm.pitch_dir, min_len, max_len, device)
            kept_names.extend(k)
            all_pitch.update(p)
            return time.perf_counter() - t0

        start, batch_s = time.perf_counter(), 0.0

        ctx = multiprocessing.get_context('spawn')
        with ProcessPoolExecutor(max_workers=args.workers, mp_context=ctx,
                                 initializer=_init_worker, initargs=(audio.config,)) as ex:
            loaded = ex.map(_load_and_trim, [(n, reader.wav_paths[n]) for n in names],
                            chunksize=8)
            pending = []
            for name, y in tqdm.tqdm(loaded, total=len(names), file=sys.stdout,
                                     desc='featurizing'):
                if y is None:
                    continue
                pending.append((name, y))
                if len(pending) == BATCH:
                    batch_s += featurize(pending)
                    pending = []
            if pending:
                batch_s += featurize(pending)
        stats = {'mel_pitch_s': time.perf_counter() - start, 'featurize_batch_s': batch_s}
        print(f'mels and pitch in {stats["mel_pitch_s"]:.2f} s, '
              f'{batch_s:.2f} s of it in featurize_batch')

        # corpus pitch statistics over voiced frames; the files are rewritten
        voiced = [p[p > 0] for p in all_pitch.values() if (p > 0).any()]
        voiced = np.concatenate(voiced) if voiced else np.zeros(0, np.float32)
        mean = float(voiced.mean()) if voiced.size else 0.0
        std = float(voiced.std()) if voiced.size else 1.0
        with open(cm.data_dir / 'pitch_stats.pkl', 'wb') as f:
            pickle.dump({'pitch_mean': mean, 'pitch_std': std}, f)
        for name, p in all_pitch.items():
            norm = np.where(p > 0, (p - mean) / std, 0.0)
            np.save(cm.pitch_dir / f'{name}.npy', norm.astype(np.float32))
        print(f'kept {len(kept_names)}/{len(names)} clips; '
              f'pitch mean {mean:.1f} Hz, std {std:.1f}')
    else:
        kept_names = [p.stem for p in cm.mel_dir.glob('*.npy')]

    if not args.skip_phonemes:
        kept = [n for n in kept_names if n in reader.text_dict]
        print(f'phonemizing {len(kept)} texts')
        phonemizer = Phonemizer(language=config['phoneme_language'],
                                with_stress=config['with_stress'], njobs=args.workers)
        phonemes = phonemizer([reader.text_dict[n] for n in kept])
        ph_map = dict(zip(kept, phonemes))
        with open(cm.phonemized_metadata_path, 'w', encoding='utf-8') as f:
            for n in kept:
                f.write(f'{n}|{ph_map[n]}\n')

        order = kept[:]
        Random(42).shuffle(order)
        n_test = int(config['n_test'])
        with open(cm.valid_metadata_path, 'w', encoding='utf-8') as f:
            for n in order[:n_test]:
                f.write(f'{n}|{ph_map[n]}\n')
        with open(cm.train_metadata_path, 'w', encoding='utf-8') as f:
            for n in order[n_test:]:
                f.write(f'{n}|{ph_map[n]}\n')
        print(f'wrote {len(order[n_test:])} train / {len(order[:n_test])} valid samples')
    print('Done.')
    return {'kept': len(kept_names), **stats}


if __name__ == '__main__':
    main()
