"""Stage-4 CLI: ForwardTransformer training with the PyTorch port.

    python -m transformertts_torch.train_tts --config <session.yaml> [--device cuda]
    torchrun --nproc_per_node N -m transformertts_torch.train_tts --config <session.yaml>

The counterpart of the root ``train_tts.py``: the bucketed
TTS dataset over the preprocessed artifacts (``data/datasets.py``, the
port's copy of the JAX package's host data pipeline), one teacher-forced
Adam step a batch with the learning rate of the config's schedule, losses
logged one step late (so
reading them never waits on the step just queued), target-vs-predicted
duration histograms per symbol, periodic validation with mel images and
Griffin-Lim wavs of one target and its prediction, training checkpoints
every ``checkpoint_frequency`` steps in the JAX package's layout (resume is
running the same command), ``model_step_N`` model dirs that either package
loads, and mels and wavs of the test sentences. As in the JAX CLI, a failed
validation is printed and training goes on; ``main`` returns the validation
losses by step, so a caller can tell. Mel images need matplotlib and are
left out where it is not installed; the profiler window of the JAX CLI is
not ported.

Under torchrun the config's ``mesh: {data: D, model: M}`` trains over the
D × M processes (``parallel/mesh.py``; ``--device cuda`` is then
``cuda:LOCAL_RANK``; ``data: -1`` takes world // M): rank r is data index
r // M and model index r % M. Every rank runs the same seeded loader and
the trainer takes its data index's slice of each batch; the conv pairs are
sharded over the M model ranks (tensor parallelism) and the Adam moments
over the D data ranks (ZeRO-1, at D > 1). Rank 0 alone writes the logs,
audio, model dirs and checkpoints, each at full width after every rank
gathers, and every rank resumes from the same checkpoint. A mesh that does
not tile the world raises.
"""
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import torch
import tqdm

from transformertts_torch.audio import Audio
from transformertts_torch.data.datasets import TTSDataset, TTSPreprocessor
from transformertts_torch.parallel.mesh import destroy_distributed, local_device
from transformertts_torch.parallel.tensor_parallel import unsharded
from transformertts_torch.training import checkpointing
from transformertts_torch.utils.config import TrainingConfigManager
from transformertts_torch.utils.decorators import ignore_exception, time_it
from transformertts_torch.utils.display import mel_png
from transformertts_torch.utils.logging_utils import SummaryManager
from transformertts_torch.utils.scheduling import piecewise_linear_schedule
from transformertts_torch.utils.scripts_utils import basic_train_parser

INIT_SEED = 42   # the weights of a fresh run, as the JAX CLI's PRNGKey(42)


@ignore_exception
@time_it
def validate(trainer, val_dataset, summary_manager, step, plots: bool):
    """The mean validation loss; logged with a target and its prediction
    unless ``summary_manager`` is None (a rank other than 0)."""
    total, n, aux, batch = 0.0, 0, None, None
    for batch in val_dataset.all_batches():
        aux = trainer.val_step(batch)
        total += float(aux['loss'])
        n += 1
    if n == 0 or summary_manager is None:
        return total / n if n else None
    summary_manager.add_scalar('Validation/loss', total / n, step)
    real = batch['fname'] != ''
    if real.any():
        idx = int(np.argmax(real))
        target, pred = batch['mel'][idx], aux['mel_pred'][idx].float().cpu().numpy()
        if plots:
            summary_manager.add_image('Validation/target_mel', mel_png(target), step)
            summary_manager.add_image('Validation/pred_mel', mel_png(pred), step)
        summary_manager.display_audio('Validation/target_wav', target, step)
        summary_manager.display_audio('Validation/pred_wav', pred, step)
    return total / n


@ignore_exception
def log_duration_histograms(model, fname_durs, summary_manager, step):
    """Target vs predicted durations per phoneme symbol."""
    per_symbol_t, per_symbol_p = {}, {}
    for tokens_b, tgt_b, pred_b in fname_durs:
        for tokens, tgt, pred in zip(tokens_b, tgt_b, pred_b):
            for tok, t, p in zip(tokens, tgt, pred):
                if tok == 0:
                    continue
                sym = model.text_pipeline.tokenizer.idx_to_token[int(tok)]
                per_symbol_t.setdefault(sym, []).append(float(t))
                per_symbol_p.setdefault(sym, []).append(float(p))
    for sym in per_symbol_t:
        safe = f'{ord(sym[0]):04x}' if not sym.isalnum() else sym
        summary_manager.add_histogram(f'DurationsTarget/{safe}',
                                      np.asarray(per_symbol_t[sym]), step)
        summary_manager.add_histogram(f'DurationsPredicted/{safe}',
                                      np.asarray(per_symbol_p[sym]), step)


@ignore_exception
def predict_test_sentences(model, summary_manager, config, step, plots: bool):
    """Mels and wavs of the test sentences, logged unless
    ``summary_manager`` is None (a model rank other than 0)."""
    path = Path(config.get('test_sentences_file', 'config/test_sentences.txt'))
    if not path.exists():
        path = Path('config/test_sentences.txt')
    if not path.exists():
        return
    for i, text in enumerate(path.read_text().splitlines()):
        if text.strip():
            mel = model.predict(text)['mel']
            if summary_manager is None:
                continue
            if plots:
                summary_manager.add_image(f'TestSentences/{i}_mel', mel_png(mel), step)
            summary_manager.display_audio(f'TestSentences/{i}_wav', mel, step)


def main(argv=None) -> dict:
    """Train to the config's ``max_steps``; returns {step: validation loss}
    of the validations that produced one. A process group this call brings
    up, it takes down."""
    parser = basic_train_parser()
    parser.add_argument('--device', default='cuda',
                        help="torch device to train on: 'cuda' (the kernels; cuda:LOCAL_RANK "
                             "under torchrun) or 'cpu'")
    args = parser.parse_args(argv)
    device = local_device(args.device)
    if device.type == 'cuda':
        print(f'device: {torch.cuda.get_device_name(device)}')
    else:
        print(f'device: {device}')
    grouped = torch.distributed.is_initialized()
    cm = TrainingConfigManager(args.config)
    try:
        return train(cm, args, device)
    finally:
        if not grouped:
            destroy_distributed()


def train(cm, args, device) -> dict:
    mesh = cm.get_mesh(device)
    if mesh.is_main:
        cm.create_remove_dirs(clear_dir=args.reset_dir, clear_logs=args.reset_logs,
                              clear_weights=args.reset_weights, assume_yes=args.yes)
        cm.dump_config()
        cm.print_config()
    mesh.barrier()
    if mesh.grouped:
        print(f'rank {mesh.rank} of {mesh.size} (data {mesh.data_rank} of {mesh.data_size}, '
              f'model {mesh.model_rank} of {mesh.model_size})')
    config = cm.config

    model = cm.get_model('cpu').init_params(torch.Generator().manual_seed(INIT_SEED))
    model.to(device)
    trainer = cm.get_trainer(model, mesh)
    restored = checkpointing.restore_latest(cm.weights_dir, model, trainer.optimizer)
    if restored is not None:
        trainer.step = model.step = restored
        print(f'resumed from step {restored}')

    prep = TTSPreprocessor.from_config(cm, model.text_pipeline.tokenizer)
    train_data = TTSDataset.from_config(cm, prep, kind='train').get_dataset(
        bucket_batch_sizes=config['bucket_batch_sizes'],
        bucket_boundaries=config['bucket_boundaries'])
    val_data = TTSDataset.from_config(cm, prep, kind='valid').get_dataset(
        bucket_batch_sizes=config['val_bucket_batch_size'],
        bucket_boundaries=config['bucket_boundaries'], shuffle=False)
    summary_manager = (SummaryManager(model, cm.log_dir, config,
                                      audio=Audio.from_config(config))
                       if mesh.is_main else None)
    plots = importlib.util.find_spec('matplotlib') is not None
    if not plots and mesh.is_main:
        print('matplotlib is not installed: no mel images in the logs')

    max_steps = int(config['max_steps'])
    val_freq = int(config['validation_frequency'])
    save_freq = int(config['weights_save_frequency'])
    save_start = int(config.get('weights_save_starting_step', 0))
    pred_freq = int(config.get('prediction_frequency', val_freq))
    pred_start = int(config.get('prediction_start_step', 0))
    ckpt_freq = int(config.get('checkpoint_frequency', 1000))
    keep_n = int(config['keep_n_weights'])

    fname_durs, validation = [], {}
    t = tqdm.trange(trainer.step, max_steps, initial=trainer.step, total=max_steps,
                    file=sys.stdout, disable=not mesh.is_main)

    def log_step(step, aux, batch, iter_time):
        """Logging of a finished step, called one step late so that reading
        its losses does not wait for the step just queued."""
        summary_manager.add_scalar('Meta/iter_time', iter_time, step)
        summary_manager.add_scalar('Meta/input_wait_ms', train_data.take_input_wait_ms(),
                                   step)
        losses = {k: float(v) for k, v in aux.items()
                  if k in ('loss', 'mel', 'duration', 'pitch')}
        t.set_postfix(loss=losses['loss'])
        summary_manager.display_loss(losses, step)
        summary_manager.add_scalar(
            'Meta/learning_rate',
            piecewise_linear_schedule(step, config['learning_rate_schedule']), step)
        n_real = int((batch['fname'] != '').sum())
        fname_durs.append((batch['tokens'][:n_real], batch['durations'][:n_real],
                           aux['duration_pred'][:n_real].cpu().numpy()))
        if len(fname_durs) >= 100:
            log_duration_histograms(model, fname_durs, summary_manager, step)
            fname_durs.clear()

    pending = None
    for _ in t:
        t0 = time.perf_counter()
        batch = train_data.next_batch()
        aux = trainer.train_step(batch)
        step = trainer.step
        if pending is not None and mesh.is_main:
            log_step(*pending)
        pending = (step, aux, batch, time.perf_counter() - t0)

        if step % ckpt_freq == 0:
            checkpointing.save_checkpoint(cm.weights_dir, model, trainer.optimizer, step,
                                          keep_n=keep_n, mesh=mesh)
        if step % save_freq == 0 and step >= save_start:
            model.step = step
            full = unsharded(model, mesh)   # every rank: a sharded model gathers
            if mesh.is_main:
                full.save_model(cm.base_dir / f'model_step_{step}')
            mesh.barrier()
        if step % val_freq == 0:
            result = validate(trainer, val_data, summary_manager, step, plots)
            if result is not None:
                if mesh.is_main:
                    summary_manager.add_scalar('Meta/validation_time', result[1], step)
                if result[0] is not None:
                    validation[step] = result[0]
        if step % pred_freq == 0 and step >= pred_start and mesh.data_rank == 0:
            # the model ranks of data row 0 together: a sharded model's
            # collectives span the row; rank 0 alone logs
            predict_test_sentences(model, summary_manager, config, step, plots)
    if pending is not None and mesh.is_main:
        log_step(*pending)
    checkpointing.save_checkpoint(cm.weights_dir, model, trainer.optimizer, trainer.step,
                                  keep_n=keep_n, mesh=mesh)
    if mesh.is_main:
        summary_manager.flush()
    print('done')
    return validation


if __name__ == '__main__':
    main()
