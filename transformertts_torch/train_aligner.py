"""Stage-2 CLI: Aligner training with the PyTorch port.

    python -m transformertts_torch.train_aligner --config <session.yaml> [--device cuda]

The counterpart of the root ``train_aligner.py``, on one device: the
bucketed Aligner dataset over the featurized mels (``data/datasets.py``),
one Adam step a batch at the reduction factor r of the config's schedule,
diagonal forcing of the encoder's and the decoder's attention for the
config's first steps, and on plotting steps each decoder map's jumpiness,
peakiness and diagonality. Losses are logged one step late, so reading them
never waits on the step just queued. Training checkpoints in the JAX
package's layout every ``checkpoint_frequency`` steps, keeping the newest
``keep_n_weights`` and every ``weights_save_frequency``-th (resume is running
the same command); validation at r = 1 with the attention heads, durations
extracted from the last cross-attention and Griffin-Lim snippets of the
first sample cut at their boundaries; predictions of the test sentences
through ``Aligner.predict``.

The port's trainer computes P·V in float32 whatever ``narrow_pv`` says, so
it always trains as the JAX CLI with ``narrow_pv: false``. As in the JAX
CLI, a failed validation is printed and training goes on; ``main`` returns
the validation losses by step, so a caller can tell. Images need
matplotlib and are left out where it is not installed; the profiler window
of the JAX CLI is not ported.
"""
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import torch
import tqdm

from transformertts_torch.audio import Audio
from transformertts_torch.data.datasets import AlignerDataset, AlignerPreprocessor
from transformertts_torch.ops.duration_extraction import get_durations_from_alignment
from transformertts_torch.training import checkpointing
from transformertts_torch.utils.config import TrainingConfigManager
from transformertts_torch.utils.decorators import ignore_exception, time_it
from transformertts_torch.utils.display import attention_grid_png, mel_png
from transformertts_torch.utils.logging_utils import SummaryManager
from transformertts_torch.utils.metrics import attention_score
from transformertts_torch.utils.scheduling import (piecewise_linear_schedule,
                                                   reduction_schedule)
from transformertts_torch.utils.scripts_utils import basic_train_parser

INIT_SEED = 42   # the weights of a fresh run, as the JAX CLI's PRNGKey(42)
LAST_CROSS = 'Decoder_LastBlock_CrossAttention'
LOSS_KEYS = ('loss', 'mel', 'stop_prob', 'diag_loss')


def cut_with_durations(durations, wav, tokens_text, hop_length, sampling_rate):
    """Audio snippets cut at extracted phoneme boundaries. Yields (symbol,
    snippet)."""
    starts = np.cumsum(np.concatenate([[0], durations[:-1]])) * hop_length
    ends = np.cumsum(durations) * hop_length
    for sym, s, e in zip(tokens_text, starts.astype(int), ends.astype(int)):
        yield sym, wav[s:e]


def _maps_np(maps: dict) -> dict:
    return {k: v.float().cpu().numpy() for k, v in maps.items()}


@ignore_exception
@time_it
def validate(trainer, val_dataset, summary_manager, step, audio: Audio, model,
             plots: bool):
    """Mean validation loss at r = 1, so that the duration diagnostics hold
    throughout training; the attention heads, durations and snippets of the
    last batch."""
    total, n, last = 0.0, 0, None
    for batch in val_dataset.all_batches():
        aux = trainer.val_step(batch, r=1)
        total += float(aux['loss'])
        n += 1
        last = (batch, aux)
    if not n:
        return None
    summary_manager.add_scalar('Validation/loss', total / n, step)
    batch, aux = last
    if plots:
        summary_manager.display_attention_heads(
            {'decoder_attention': _maps_np(aux['decoder_attention']),
             'encoder_attention': _maps_np(aux['encoder_attention'])},
            step, tag='ValidationAttention')
    n_real = int((batch['fname'] != '').sum())
    if n_real == 0:
        return total / n
    durations, final_align, *_ = get_durations_from_alignment(
        aux['decoder_attention'][LAST_CROSS][:n_real], batch['mel'][:n_real],
        batch['tokens'][:n_real])
    if plots:
        summary_manager.add_image('ValidationAlignment/extracted',
                                  attention_grid_png(final_align[0][None, ...]), step)
    # boundary-cut audio snippets of the first sample
    mel = batch['mel'][0]
    n_frames = int((np.abs(mel).sum(-1) > 0).sum())
    wav = audio.reconstruct_waveform(mel[1:n_frames - 1].T, device=model.device)
    text = model.text_pipeline.tokenizer.decode(batch['tokens'][0][1:len(durations[0]) + 1])
    for i, (sym, snippet) in enumerate(cut_with_durations(
            durations[0], wav, text, audio.hop_length, audio.sampling_rate)):
        if i >= 4 or len(snippet) == 0:
            break
        summary_manager.add_audio(f'ValidationSnippets/{i}_{ord(sym[0])}', snippet,
                                  audio.sampling_rate, step)
    return total / n


@ignore_exception
def predict_test_sentences(model, summary_manager, config, step, plots: bool):
    path = Path(config.get('test_sentences_file', 'config/aligner_test_sentences.txt'))
    if not path.exists():
        path = Path('config/aligner_test_sentences.txt')
    if not path.exists():
        return
    for i, text in enumerate(path.read_text().splitlines()):
        if not text.strip():
            continue
        out = model.predict(text, max_length=int(config.get('prediction_max_length', 1000)))
        if out['mel'].shape[0] < 2:
            continue
        if plots:
            summary_manager.add_image(f'TestSentences/{i}_mel', mel_png(out['mel']), step)
        summary_manager.display_audio(f'TestSentences/{i}_wav', out['mel'], step)


def log_attention_scores(aux, batch, r: int, summary_manager, step, plots: bool):
    """Jumpiness, peakiness and diagonality of each decoder map over the
    batch's real rows (neither the bucket's zero rows nor empty samples)."""
    mel_len = np.sum(np.abs(batch['mel']).sum(-1) > 0, axis=-1)
    phon_len = np.sum(batch['tokens'] != 0, axis=-1)
    real = (mel_len > 0) & (phon_len > 0)
    for name, attn in aux['decoder_attention'].items():
        keep = torch.as_tensor(real, device=attn.device)
        loc, peak, diag = attention_score(
            attn[:len(mel_len)][keep], torch.as_tensor(mel_len[real] // r, device=attn.device),
            torch.as_tensor(phon_len[real], device=attn.device), r=1)
        summary_manager.add_scalar(f'AttentionJumpiness/{name}', loc.mean().item(), step)
        summary_manager.add_scalar(f'AttentionPeakiness/{name}', peak.mean().item(), step)
        summary_manager.add_scalar(f'AttentionDiagonality/{name}', diag.mean().item(), step)
    if plots:
        summary_manager.display_attention_heads(
            {'decoder_attention': _maps_np(aux['decoder_attention'])}, step,
            tag='TrainAttention')


def main(argv=None) -> dict:
    """Train to the config's ``max_steps``; returns {step: validation loss}
    of the validations that produced one."""
    parser = basic_train_parser()
    parser.add_argument('--device', default='cuda',
                        help="torch device to train on: 'cuda' (the kernels) or 'cpu'")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda':
        print(f'device: {torch.cuda.get_device_name(device)}')
    else:
        print(f'device: {device}')

    cm = TrainingConfigManager(args.config, aligner=True)
    cm.create_remove_dirs(clear_dir=args.reset_dir, clear_logs=args.reset_logs,
                          clear_weights=args.reset_weights, assume_yes=args.yes)
    cm.dump_config()
    cm.print_config()
    config = cm.config

    model = cm.get_model('cpu').init_params(torch.Generator().manual_seed(INIT_SEED))
    model.to(device)
    trainer = cm.get_trainer(model)
    restored = checkpointing.restore_latest(cm.weights_dir, model, trainer.optimizer)
    if restored is not None:
        trainer.step = model.step = restored
        print(f'resumed from step {restored}')

    prep = AlignerPreprocessor.from_config(cm, model.text_pipeline.tokenizer)
    train_data = AlignerDataset.from_config(cm, prep, kind='train').get_dataset(
        bucket_batch_sizes=config['bucket_batch_sizes'],
        bucket_boundaries=config['bucket_boundaries'])
    val_data = AlignerDataset.from_config(cm, prep, kind='valid').get_dataset(
        bucket_batch_sizes=config['val_bucket_batch_size'],
        bucket_boundaries=config['bucket_boundaries'], shuffle=False)
    audio = Audio.from_config(config)
    summary_manager = SummaryManager(model, cm.log_dir, config, audio=audio)
    plots = importlib.util.find_spec('matplotlib') is not None
    if not plots:
        print('matplotlib is not installed: no images in the logs')

    max_steps = int(config['max_steps'])
    val_freq = int(config['validation_frequency'])
    save_freq = int(config['weights_save_frequency'])
    plot_freq = int(config.get('train_images_plotting_frequency', 1000))
    pred_freq = int(config.get('prediction_frequency', val_freq))
    pred_start = int(config.get('prediction_start_step', 0))
    ckpt_freq = int(config.get('checkpoint_frequency', 1000))
    keep_n = int(config['keep_n_weights'])
    force_enc_steps = int(config.get('force_encoder_diagonal_steps', 0))
    force_dec_steps = int(config.get('force_decoder_diagonal_steps', 0))

    validation = {}
    t = tqdm.trange(trainer.step, max_steps, initial=trainer.step, total=max_steps,
                    file=sys.stdout)

    def log_step(step, aux, r, iter_time):
        """Logging of a finished step, called one step late so that reading
        its losses does not wait for the step just queued."""
        summary_manager.add_scalar('Meta/iter_time', iter_time, step)
        summary_manager.add_scalar('Meta/input_wait_ms', train_data.take_input_wait_ms(),
                                   step)
        losses = {k: float(aux[k]) for k in LOSS_KEYS}
        t.set_postfix(loss=losses['loss'], r=r)
        summary_manager.display_loss(losses, step)
        summary_manager.add_scalar('Meta/reduction_factor', r, step)
        summary_manager.add_scalar(
            'Meta/learning_rate',
            piecewise_linear_schedule(step, config['learning_rate_schedule']), step)

    pending = None
    for _ in t:
        t0 = time.perf_counter()
        step = trainer.step
        r = reduction_schedule(step, config['reduction_factor_schedule'])
        model.set_constants(reduction_factor=r)
        batch = train_data.next_batch()
        plot_step = (step + 1) % plot_freq == 0
        aux = trainer.train_step(batch, r=r, force_encoder_diagonal=step < force_enc_steps,
                                 force_decoder_diagonal=step < force_dec_steps,
                                 return_attention=plot_step)
        step = model.step = trainer.step
        if pending is not None:
            log_step(*pending)
        pending = (step, {k: aux[k] for k in LOSS_KEYS}, r, time.perf_counter() - t0)

        if plot_step:
            log_attention_scores(aux, batch, r, summary_manager, step, plots)
        if step % ckpt_freq == 0:
            checkpointing.save_checkpoint(cm.weights_dir, model, trainer.optimizer, step,
                                          keep_n=keep_n, keep_every=save_freq)
        if step % val_freq == 0:
            result = validate(trainer, val_data, summary_manager, step, audio, model, plots)
            if result is not None:
                summary_manager.add_scalar('Meta/validation_time', result[1], step)
                if result[0] is not None:
                    validation[step] = result[0]
        if step % pred_freq == 0 and step >= pred_start:
            predict_test_sentences(model, summary_manager, config, step, plots)
    if pending is not None:
        log_step(*pending)
    checkpointing.save_checkpoint(cm.weights_dir, model, trainer.optimizer, trainer.step,
                                  keep_n=keep_n)
    summary_manager.flush()
    print('done')
    return validation


if __name__ == '__main__':
    main()
