"""A training cell: back-to-back ``AlignerTrainer.train_step`` calls.

Set-up builds the configuration's Aligner on the card with weights drawn
from the seed (the published initializers), its trainer (``FlatAdam``,
the dropout generator of base seed 42) and a pool of host batches
(``traffic.aligner_batches``). The trainer's first three steps are the
check's: each on a batch of its own, through the same ``train_step`` call
and feed as the window; the first moment after step 1 and the parameters
after step 3 are copied aside. One step on every other batch of the pool
warms every shape, then the window cycles the pool until ``--seconds``
have passed and synchronizes. After the window the reference
(``reference/aligner.py``) runs the same three steps from the same weights
and batches, and ``judge_cell`` compares.
"""
import gc
import sys
import time
import traceback

import numpy as np
import torch

from h100bench.common import keras_limits, uniform_weights
from h100bench.reference import aligner as ref_aligner
from h100bench.reference.numerics import tf32_products
from h100bench.traffic import aligner_batches

TRAFFIC_KIND = 'aligner_batches'


def build(cfg: dict, seed: int, device='cuda'):
    """(trainer, weights, the pool of batches)."""
    from transformertts_torch.models.aligner import Aligner
    from transformertts_torch.training.aligner_trainer import AlignerTrainer
    tr = cfg['training']
    model = Aligner(**cfg['model']).to(device)
    model.set_constants(reduction_factor=tr['reduction_factor'])
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    limits, constants = keras_limits(shapes, embeddings=('encoder_prenet.weight',))
    weights = uniform_weights(shapes, limits, constants, seed, device)
    model.load_state_dict(weights)
    trainer = AlignerTrainer(model, [tuple(x) for x in tr['learning_rate_schedule']],
                             stop_scaling=tr['stop_loss_scaling'],
                             base_rng_seed=tr['base_rng_seed'])
    return trainer, weights


def pool_of(cfg: dict, mix: dict, trainer, seed: int) -> list:
    m = cfg['model']
    return aligner_batches(mix, cfg['training'], trainer.model.text_pipeline.tokenizer.vocab_size,
                           m['mel_channels'], m['mel_start_value'], m['mel_end_value'], seed)


def run_window(trainer, pool, r, seconds, start_index, log=None) -> dict:
    """Steps on the pool's batches in turn from ``start_index`` until
    ``seconds`` have passed, then a device sync."""
    frames, attempted, failed, i = 0, 0, 0, start_index
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        batch, meta = pool[i % len(pool)]
        i += 1
        attempted += 1
        try:
            trainer.train_step(batch, r=r)
        except Exception:
            failed += 1
            print(f'step {attempted} of the window failed:', file=sys.stderr)
            traceback.print_exc()
            continue
        frames += int(meta['frames'].sum())
        if log is not None:
            log.append(meta | {'shape': batch['mel'].shape, 'tok_pad': batch['tokens'].shape[1]})
    torch.cuda.synchronize()
    return {'frames': frames, 'attempted': attempted, 'failed': failed,
            'window_s': time.perf_counter() - start, 'next': i}


TRACE_A_SECONDS = 10.0
TRACE_B_STEPS_SECONDS = 0.3


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, t_start: float,
             device: str = 'cuda'):
    from h100bench import trace
    from h100bench.common import device_info, log_phase, require_devices
    cfg, mix = cell['config_data'], cell['traffic_data']
    require_devices(cell['chips'])
    log_phase(t_start, 'imports')
    r = cfg['training']['reduction_factor']
    trainer, weights = build(cfg, seed, device)
    log_phase(t_start, 'model, weights and trainer on the device')
    pool = pool_of(cfg, mix, trainer, seed)
    log_phase(t_start, 'host batches')
    n_check = mix['check_steps']
    check = {'batches': [pool[i][0] for i in range(n_check)], 'losses': [],
             'seeds': [trainer.base_rng_seed * 2 ** 32 + s for s in range(n_check)]}
    for i in range(n_check):
        aux = trainer.train_step(pool[i][0], r=r)
        check['losses'].append(aux['loss'].detach())
        if i == 0:
            _, mu, _ = trainer.optimizer.moments()
            check['grad'] = {k: v.detach() / (1.0 - 0.9) for k, v in mu.items()}
    check['params'] = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    log_phase(t_start, 'the check\'s steps (kernels built or loaded)')
    for batch, _ in pool[n_check:]:
        trainer.train_step(batch, r=r)
    if device != 'cpu':
        torch.cuda.synchronize()
    log_phase(t_start, 'a step on every other batch')
    setup_s = time.time() - t_start
    extra, readings = {}, {}
    if not traced:
        w = run_window(trainer, pool, r, seconds, 0)
        readings = {'setup_s': setup_s, 'train_frame_rate': w['frames'] / w['window_s']}
        counts = (w['attempted'], w['failed'])
    else:
        a_work, b_work = [], []
        w, a = trace.device_window(lambda: run_window(
            trainer, pool, r, min(seconds, TRACE_A_SECONDS), 0, a_work))
        wb, b = trace.stack_window(lambda: run_window(
            trainer, pool, r, TRACE_B_STEPS_SECONDS, w['next'], b_work))
        extra = {'ctx': {'cell': cell, 'a': a, 'b': b, 'a_work': a_work, 'b_work': b_work}}
        counts = (w['attempted'] + wb['attempted'], w['failed'] + wb['failed'])
    info = device_info(cell['chips'])
    check['losses'] = [float(x) for x in check['losses']]
    del trainer, pool
    gc.collect()
    if device != 'cpu':
        torch.cuda.empty_cache()
    return readings, counts, info, check, weights, extra


def reference_run(cfg: dict, batches, seeds, weights: dict, tf32: bool = False) -> dict:
    """The reference's steps from ``weights`` on host ``batches``: the same
    keys as the program's check record (losses, first gradient, parameters
    after the last step), with TF32 off in cuBLAS and cuDNN, or on with
    ``tf32`` (the control)."""
    with tf32_products(tf32):
        return _reference_run(cfg, batches, seeds, weights)


def _reference_run(cfg: dict, batches, seeds, weights: dict) -> dict:
    ref = ref_aligner.ReferenceAligner(cfg['model'] | cfg['training'],
                                       cfg['training']['reduction_factor'])
    dev = next(iter(weights.values())).device
    batches = [{k: torch.as_tensor(v, device=dev).float() for k, v in b.items()}
               for b in batches]
    lr = cfg['training']['learning_rate_schedule'][0][1]
    losses, grad, params = ref_aligner.adam_steps(ref, weights, batches, seeds, lr)
    return {'losses': losses, 'grad': grad, 'params': params}


def compare(side: dict, ref: dict, weights: dict) -> dict:
    """The compared numbers of ``side`` (the program's check record, or a
    control's) against the reference's: each step's loss, the worst leaf's
    first-gradient norm and the worst leaf's change norm, leaves whose
    reference gradient is under a thousandth of the median leaf's left out
    of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(side['losses'], ref['losses']))
    grad_gap, grad_leaf = ref_aligner.norm_gaps(side['grad'], ref['grad'])
    gnorm = {k: float(v.norm()) for k, v in ref['grad'].items()}
    floor = 1e-3 * float(np.median(list(gnorm.values())))
    moving = [k for k, v in gnorm.items() if v >= floor]
    update_gap, update_leaf = ref_aligner.norm_gaps(
        {k: side['params'][k] - weights[k] for k in moving},
        {k: ref['params'][k] - weights[k] for k in moving})
    return {'loss_gap': loss_gap, 'grad_gap': grad_gap, 'update_gap': update_gap,
            'grad_leaf': grad_leaf, 'update_leaf': update_leaf, 'losses': side['losses'],
            'ref_losses': ref['losses'], 'left_out': sorted(set(gnorm) - set(moving))}


def judge_numbers(cfg: dict, check: dict, weights: dict) -> dict:
    return compare(check, reference_run(cfg, check['batches'], check['seeds'], weights),
                   weights)


def judge_cell(cell: dict, check: dict, weights: dict) -> tuple:
    cfg = cell['config_data']
    n = judge_numbers(cfg, check, weights)
    print(f"check detail: losses {n['losses']} reference {n['ref_losses']}; worst gradient "
          f"leaf {n['grad_leaf']}, worst change leaf {n['update_leaf']}; change left out "
          f"(reference gradient under 1e-3 of the median leaf's): {n['left_out']}",
          file=sys.stderr)
    limits = cfg['limits']
    checks = {k: (n[k], limits[k]) for k in ('loss_gap', 'grad_gap', 'update_gap')}
    return checks, all(n[k] <= limits[k] for k in checks)


def control_readings(cell, seed, seconds, program_only=False) -> dict:
    """``control.py``'s readings of a training cell on one seed: the
    program's compared numbers, and (unless ``program_only``) the TF32
    control's and the half-batch fault's."""
    cfg = cell['config_data']
    _, _, _, check, weights, _ = run_cell(cell, seed, seconds, False, time.time())
    ref = reference_run(cfg, check['batches'], check['seeds'], weights)
    out = {'program': compare(check, ref, weights)}
    if program_only:
        out['program'].pop('left_out', None)
        return out
    out['control'] = compare(
        reference_run(cfg, check['batches'], check['seeds'], weights, tf32=True), ref, weights)
    halves = [{k: v[:max(1, len(v) // 2)] for k, v in b.items()} for b in check['batches']]
    out['half_batch'] = compare(reference_run(cfg, halves, check['seeds'], weights), ref, weights)
    for side in out.values():
        side.pop('left_out', None)
    return out
