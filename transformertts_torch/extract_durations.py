"""Stage-3 CLI: phoneme durations and phoneme-wise pitch with the PyTorch port.

    python -m transformertts_torch.extract_durations --config <session.yaml> \
        [--best] [--autoregressive_weights <ckpt>] [--skip_durations] \
        [--skip_char_pitch] [--device cuda|cpu] [--workers N]

The counterpart of the root ``extract_durations.py``, writing the same
files. It restores the trained Aligner (``--autoregressive_weights``, else
the session's latest checkpoint; its reduction factor must be 1) and runs
the teacher-forced forward over the whole phonemized corpus, batched and
bucketed as validation is: decoder input ``mel[:, :-1]`` at r = 1, no
dropout, every attention on the fused kernel except the last block's
cross-attention, whose map is the input of duration extraction
(``ops/duration_extraction.py``; the weighted head sum, or the best head
with ``--best``). It saves ``durations/{name}.npy``, logs the heads' scores,
an alignment image and a duration histogram, then averages each phoneme
span's voiced frame pitch (frames over 400 Hz, in de-normalized pitch,
left out) into ``char_pitch/{name}.npy`` in a pool of spawned workers.
Alignment images need matplotlib and are left out without it.
"""
import importlib.util
import multiprocessing
import pickle
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch
import tqdm

from transformertts_torch.data.datasets import AlignerDataset, AlignerPreprocessor, DataReader
from transformertts_torch.ops.duration_extraction import (get_durations_from_alignment,
                                                          resolve_backend)
from transformertts_torch.utils.config import TrainingConfigManager
from transformertts_torch.utils.display import attention_grid_png
from transformertts_torch.utils.logging_utils import SummaryManager
from transformertts_torch.utils.scripts_utils import basic_train_parser

LAST_LAYER_KEY = 'Decoder_LastBlock_CrossAttention'


def pitch_per_char(pitch: np.ndarray, durations: np.ndarray, pitch_mean: float,
                   pitch_std: float, max_hz: float = 400.0) -> np.ndarray:
    """Mean of the non-zero frame pitch under ``max_hz`` (de-normalized) per
    phoneme span."""
    bounds = np.cumsum(np.concatenate([[0], durations])).astype(int)
    out = np.zeros(len(durations), np.float32)
    for i in range(len(durations)):
        seg = pitch[bounds[i]:bounds[i + 1]]
        seg = seg[seg != 0.0]
        seg = seg[(seg * pitch_std + pitch_mean) < max_hz]
        out[i] = seg.mean() if len(seg) else 0.0
    return out


def _char_pitch_job(args):
    name, pitch_dir, duration_dir, out_dir, mean, std = args
    pitch = np.load(f'{pitch_dir}/{name}.npy')
    durations = np.load(f'{duration_dir}/{name}.npy')
    np.save(f'{out_dir}/{name}.npy', pitch_per_char(pitch, durations, mean, std))
    return name


def _sync(device: torch.device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def extract(cm: TrainingConfigManager, model, weighted: bool, backend: str) -> dict:
    """Durations of every phonemized clip; returns the counts and the time
    split (forward on the device, extraction from the maps, the rest on the
    host: loading, batching, saving, logging)."""
    config = cm.config
    prep = AlignerPreprocessor.from_config(cm, model.text_pipeline.tokenizer)
    data = AlignerDataset.from_config(cm, prep, kind='phonemized').get_dataset(
        bucket_batch_sizes=config['val_bucket_batch_size'],
        bucket_boundaries=config['bucket_boundaries'], shuffle=False)
    summary_manager = SummaryManager(model, cm.log_dir / 'duration_extraction', config,
                                     default_writer='duration_extraction')
    device = model.device
    plots = importlib.util.find_spec('matplotlib') is not None
    if not plots:
        print('matplotlib is not installed: no alignment images in the logs')
    all_durations = []
    step = clips = 0
    forward_s = dp_s = 0.0
    start = time.perf_counter()
    for batch in tqdm.tqdm(data.all_batches(), file=sys.stdout, desc='extracting durations'):
        t0 = time.perf_counter()
        with torch.inference_mode():
            tokens = torch.as_tensor(batch['tokens'], device=device)
            mel = torch.as_tensor(batch['mel'], device=device)
            out = model.apply(tokens, mel[:, :-1], 1)
        attn = out['decoder_attention'][LAST_LAYER_KEY]
        _sync(device)
        t1 = time.perf_counter()
        n = int((batch['fname'] != '').sum())
        durations, final_align, jump, peak, diag = get_durations_from_alignment(
            attn[:n], batch['mel'][:n], batch['tokens'][:n], weighted=weighted,
            backend=backend)
        t2 = time.perf_counter()
        forward_s, dp_s = forward_s + t1 - t0, dp_s + t2 - t1
        for h in range(jump.shape[1]):
            summary_manager.add_scalar(f'DurationExtraction/jumpiness_head{h}',
                                       float(np.mean(jump[:n, h])), step)
            summary_manager.add_scalar(f'DurationExtraction/peakiness_head{h}',
                                       float(np.mean(peak[:n, h])), step)
            summary_manager.add_scalar(f'DurationExtraction/diagonality_head{h}',
                                       float(np.mean(diag[:n, h])), step)
        if plots and step % 10 == 0 and n:
            summary_manager.add_image('DurationExtraction/alignment',
                                      attention_grid_png(final_align[0][None, ...]), step)
        for i in range(n):
            np.save(str(cm.duration_dir / f"{batch['fname'][i]}.npy"), durations[i])
            all_durations.append(durations[i])
        step += 1
        clips += n
    if all_durations:
        summary_manager.add_histogram('ExtractedDurations',
                                      np.minimum(np.concatenate(all_durations), 20), step)
    summary_manager.flush()
    total = time.perf_counter() - start
    return {'batches': step, 'clips': clips, 'forward_s': forward_s, 'dp_s': dp_s,
            'host_s': total - forward_s - dp_s, 'durations_s': total}


def char_pitch(cm: TrainingConfigManager, workers: int = None) -> int:
    """Phoneme-wise pitch of every phonemized clip from its frame pitch and
    durations, in a pool of spawned workers; returns the clip count."""
    reader = DataReader.from_config(cm, kind='phonemized')
    stats_path = cm.data_dir / 'pitch_stats.pkl'
    if stats_path.exists():
        with open(stats_path, 'rb') as f:
            stats = pickle.load(f)
    else:
        stats = {'pitch_mean': 0.0, 'pitch_std': 1.0}
    print(f'computing phoneme-wise pitch for {len(reader.filenames)} items')
    jobs = [(name, cm.pitch_dir, cm.duration_dir, cm.pitch_per_char, stats['pitch_mean'],
             stats['pitch_std']) for name in reader.filenames]
    ctx = multiprocessing.get_context('spawn')
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        list(tqdm.tqdm(ex.map(_char_pitch_job, jobs, chunksize=16), total=len(jobs),
                       file=sys.stdout, desc='char pitch'))
    return len(jobs)


def main(argv=None) -> dict:
    """Runs stage 3; returns ``extract``'s counts and time split, the DP
    backend and the char-pitch time."""
    parser = basic_train_parser()
    parser.add_argument('--best', action='store_true',
                        help='use the best head instead of the weighted head sum')
    parser.add_argument('--autoregressive_weights', type=str, default=None,
                        help='an Aligner training checkpoint (default: the latest)')
    parser.add_argument('--skip_durations', action='store_true')
    parser.add_argument('--skip_char_pitch', action='store_true')
    parser.add_argument('--device', default='cuda',
                        help="torch device of the Aligner: 'cuda' (the kernels) or 'cpu'")
    parser.add_argument('--workers', type=int, default=None,
                        help='char-pitch worker processes (default: one a CPU)')
    args = parser.parse_args(argv)

    cm = TrainingConfigManager(args.config, aligner=True)
    cm.create_remove_dirs(assume_yes=True)
    stats = {}
    if not args.skip_durations:
        model = cm.load_model(checkpoint_path=args.autoregressive_weights,
                              device=args.device)
        if model.r != 1:
            raise ValueError(f'reduction factor must be 1, got {model.r}')
        stats['backend'] = resolve_backend('auto')
        print(f'duration DP backend: {stats["backend"]}')
        # the reference CLI's semantics: the weighted head sum unless --best
        stats.update(extract(cm, model, weighted=not args.best, backend=stats['backend']))
    if not args.skip_char_pitch:
        t0 = time.perf_counter()
        char_pitch(cm, args.workers)
        stats['char_pitch_s'] = time.perf_counter() - t0
    print('Done.')
    return stats


if __name__ == '__main__':
    main()
