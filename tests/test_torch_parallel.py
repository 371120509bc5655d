"""Data parallelism in the port (``parallel/mesh.py``, ``BaseTrainer(mesh=)``,
the config's ``mesh:`` block, ``train_tts`` under torchrun,
``synthesize_lines(mesh=)``) against one process and the JAX package, on
the CPU at the tiny configs, float32, dropout 0.

Two ranks are two Python processes joined by a gloo process group on a free
local port; each runs this file as a script (``python
tests/test_torch_parallel.py <rank> <world> <port> <job>``) and writes what
its step gave. The global batches give the ranks unequal real rows (3 on
rank 0; 1 and a zero row on rank 1, then the slicing's own zero row), so
averaging per-rank means would fail. Bars, those of
``test_torch_training.py``: the loss to rtol 1e-5; per-leaf gradients to
atol 1e-5 + 1e-4·max|g|; parameters after one Adam step to atol 1e-6,
through optax's Adam fed the two ranks' summed gradients. (A softmax is
invariant to a shift of its keys, so the wk biases' true gradient is 0 and
every summation order returns other rounding noise there, which Adam's
first step, ≈ lr·sign(g), would blow up to O(lr); the same gradients
through both Adams isolate the update, as ``test_torch_training.py`` does.)
Each subprocess has its own time limit, so a hung rank fails its test.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))   # run as a rank's script

from transformertts_torch.parallel.mesh import (MeshConfig, ProcessMesh,  # noqa: E402
                                                make_mesh, pad_batch_to_multiple,
                                                shard_batch)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SCHEDULE = [(0, 1e-3), (10, 5e-4), (100, 1e-4)]
RANK_TIMEOUT_S = 180
WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> dict:
    """The environment torchrun gives a rank, one thread a process."""
    return {**os.environ, 'RANK': str(rank), 'WORLD_SIZE': str(world),
            'LOCAL_RANK': str(rank), 'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': str(port),
            'OMP_NUM_THREADS': '1', 'JAX_PLATFORMS': 'cpu'}


def _run_ranks(argv_of, world=WORLD, cwd=ROOT, env_of=None):
    """``world`` processes at once (``argv_of(rank)``), each with its own time
    limit; their (return code, stdout, stderr)."""
    procs = [subprocess.Popen(argv_of(r), cwd=cwd, env=env_of(r) if env_of else None,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


# ---------------------------------------------------------------------------
# one training step, in this process or as one rank of a gloo group
# ---------------------------------------------------------------------------

def _train_step(job: dict, mesh: ProcessMesh) -> dict:
    """The job's model from its weights, one ``train_step`` and one
    ``val_step`` on its global batch over ``mesh``: the returned losses,
    per-sample outputs, summed gradients, updated parameters and the
    dropout seed of step 0."""
    if job['kind'] == 'tts':
        from transformertts_torch.models.forward_tts import ForwardTransformer as Model
        from transformertts_torch.training.forward_trainer import ForwardTrainer as Trainer
    else:
        from transformertts_torch.models.aligner import Aligner as Model
        from transformertts_torch.training.aligner_trainer import AlignerTrainer as Trainer
    model = Model(**job['model'])
    model.load_state_dict(job['state'], strict=True)
    trainer = Trainer(model, SCHEDULE, grad_accumulation=job['n'], mesh=mesh)
    seed = trainer.step_generator(0).initial_seed()
    aux = trainer.train_step(job['batch'], **job['options'])
    if mesh.grouped and mesh.data_size > 1:
        # ZeRO-1 reduce-scattered the sums into each rank's share of the
        # flat gradient buffer: gather the shares to read the whole sum
        for g in trainer.optimizer.groups:
            dist.all_gather_into_tensor(g.grad, g.shard.grad.clone(), group=mesh.data_group)
    grads = {name: p.grad.clone() for name, p in model.named_parameters()}
    val = trainer.val_step(job['batch'], **job['val_options'])
    return dict(aux={k: v.clone() for k, v in aux.items() if not isinstance(v, dict)},
                grads=grads, params={k: v.clone() for k, v in model.state_dict().items()},
                val_loss=val['loss'].item(), val_mel=val['mel_pred'].clone(), seed=seed)


def _rank_main(rank: int, world: int, port: int, job_path: str):
    """One rank: join the gloo group, take the job's step, save the record."""
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}', rank=rank,
                            world_size=world)
    try:
        record = _train_step(job, ProcessMesh.current())
    finally:
        dist.destroy_process_group()
    torch.save(record, f'{job_path}.rank{rank}')


def _two_ranks(job: dict, tmp_path: Path) -> list:
    job_path = tmp_path / 'job.pt'
    torch.save(job, job_path)
    port = _free_port()
    results = _run_ranks(lambda r: [sys.executable, __file__, str(r), str(WORLD), str(port),
                                    str(job_path)])
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, f'rank {rank}: {err[-3000:]}'
    return [torch.load(f'{job_path}.rank{r}', weights_only=False) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# (a), (b): two ranks against one process and against JAX
# ---------------------------------------------------------------------------

def _tts_case(n: int):
    import jax
    from test_torch_training import NO_DROPOUT, _batch, _jax_trainer, _models
    from test_torch_nn import TINY_CONFIG
    from transformertts_tpu.training.base_trainer import accumulate_grads
    jm, tm = _models(seed=11)
    batch = _batch(jm.text_pipeline.tokenizer.vocab_size, b=5, seed=12)
    jt = _jax_trainer(jm)
    return dict(kind='tts', model={**TINY_CONFIG, **NO_DROPOUT}, batch=batch, options={},
                val_options={}, n=n), jm, tm, (
        lambda p, b: accumulate_grads(jt._loss_and_grads, p, b, jax.random.PRNGKey(0), n))


def _aligner_case(n: int):
    import jax
    from test_torch_aligner_training import _batch, _jax_trainer, _models
    from transformertts_tpu.training.base_trainer import accumulate_grads
    jm, tm = _models(seed=13)
    batch = _batch(jm.text_pipeline.tokenizer.vocab_size, b=5, seed=14)
    jt = _jax_trainer(jm)
    options = dict(r=1, force_decoder_diagonal=True)

    def lag(p, b, rng):
        with jt._attention_scope():
            return jt._loss_and_grads(p, b, rng, 1, False, True, False)

    return dict(kind='aligner', model=dict(jm.config), batch=batch, options=options,
                val_options=options, n=n), jm, tm, (
        lambda p, b: accumulate_grads(lag, p, b, jax.random.PRNGKey(0), n))


CASES = {'tts': (_tts_case, 1), 'tts-accumulate-2': (_tts_case, 2),
         'aligner-forced': (_aligner_case, 1), 'aligner-forced-accumulate-2': (_aligner_case, 2)}


@pytest.fixture(scope='module', params=sorted(CASES))
def parity(request, tmp_path_factory):
    """Two ranks' step, one process's step on the same full batch (padded
    to the mesh's multiple, as the ranks pad it), and the JAX gradients and
    loss there, from the same weights."""
    import jax.numpy as jnp
    from transformertts_tpu.parallel.mesh import pad_batch_to_multiple as j_pad
    from transformertts_tpu.utils.pytree import flatten_params
    make, n = CASES[request.param]
    job, jm, tm, jax_grads = make(n)
    job['state'] = {k: v.clone() for k, v in tm.state_dict().items()}
    ranks = _two_ranks(job, tmp_path_factory.mktemp(request.param))
    full = j_pad(job['batch'], WORLD)
    one = _train_step({**job, 'batch': full}, ProcessMesh())
    jbatch = {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind in 'iu' else v)
              for k, v in full.items()}
    j_grads, j_aux_st, _ = jax_grads(jm.params, jbatch)
    return dict(case=request.param, job=job, ranks=ranks, one=one, jm=jm,
                j_grads=flatten_params(j_grads), j_loss=float(np.mean(j_aux_st['loss'])))


def _flat(state: dict) -> dict:
    from test_torch_training import _port_flat
    return _port_flat(state)


def test_two_ranks_loss_matches_one_process_and_jax(parity):
    for record in parity['ranks']:
        loss = record['aux']['loss'].item()
        np.testing.assert_allclose(loss, parity['one']['aux']['loss'].item(), rtol=1e-5)
        np.testing.assert_allclose(loss, parity['j_loss'], rtol=1e-5)
        for key, value in parity['one']['aux'].items():
            if value.dim() == 0:
                np.testing.assert_allclose(record['aux'][key].item(), value.item(), rtol=1e-5,
                                           atol=1e-7, err_msg=key)
        np.testing.assert_allclose(record['val_loss'], parity['one']['val_loss'], rtol=1e-5)


def test_two_ranks_grads_match_one_process_and_jax(parity):
    from test_torch_training import _grads_close
    one = _flat(parity['one']['grads'])
    for record in parity['ranks']:
        mine = _flat(record['grads'])
        _grads_close(mine, one)
        _grads_close(mine, parity['j_grads'])


def test_two_ranks_params_after_adam_match_optax(parity):
    """Both ranks hold the same parameters, bit for bit, and they are
    optax's Adam step on the summed gradients from the starting weights."""
    import optax
    from transformertts_tpu.training import make_optimizer
    from transformertts_tpu.utils.pytree import flatten_params, unflatten_params
    rank0, rank1 = parity['ranks']
    for name, value in rank0['params'].items():
        assert torch.equal(value, rank1['params'][name]), name
    start = unflatten_params(_flat(parity['job']['state']))
    grads = unflatten_params(_flat(rank0['grads']))
    tx = make_optimizer(SCHEDULE)
    updates, _ = tx.update(grads, tx.init(start), start)
    want = flatten_params(optax.apply_updates(start, updates))
    mine = _flat(rank0['params'])
    assert mine.keys() == want.keys()
    for path, ref in want.items():
        np.testing.assert_allclose(mine[path], np.asarray(ref), rtol=0, atol=1e-6,
                                   err_msg=path)


def test_two_ranks_return_the_whole_batch_outputs(parity):
    """Per-sample outputs come back gathered in batch order, the slicing's
    zero rows dropped: every rank returns one process's rows (the
    validation mels; the TTS step's predicted durations too)."""
    one = parity['one']
    for record in parity['ranks']:
        got, want = record['val_mel'], one['val_mel']
        assert got.shape[0] == 6 and got.shape[1:] == want.shape[1:]
        torch.testing.assert_close(got[:5], want[:5], atol=1e-5, rtol=0)
        if 'duration_pred' in one['aux']:
            got, want = record['aux']['duration_pred'], one['aux']['duration_pred']
            assert got.shape[0] == 6 and got.shape[1:] == want.shape[1:]
            torch.testing.assert_close(got[:5], want[:5], atol=1e-5, rtol=0)


def test_ranks_draw_their_own_dropout_streams(parity):
    rank0, rank1 = parity['ranks']
    assert rank0['seed'] == parity['one']['seed'] == 42 * 2 ** 32
    assert rank1['seed'] != rank0['seed']


# ---------------------------------------------------------------------------
# the mesh rules, shard_batch, dropout streams, checkpoints
# ---------------------------------------------------------------------------

def test_shard_batch_pads_then_slices_contiguously():
    batch = {'x': np.arange(5 * 2).reshape(5, 2), 'y': np.ones((5, 3), np.float32)}
    padded = pad_batch_to_multiple(batch, 2)
    assert padded['x'].shape == (6, 2) and (padded['x'][5] == 0).all()
    parts = [shard_batch(batch, r, 2) for r in range(2)]
    np.testing.assert_array_equal(np.concatenate([p['x'] for p in parts]), padded['x'])
    assert parts[1]['y'][2].sum() == 0 and parts[0]['y'].shape == (3, 3)


def test_make_mesh_tiles_the_devices_or_raises():
    assert make_mesh(MeshConfig(data=2), devices=['cpu', 'cpu']) == [torch.device('cpu')] * 2
    assert len(make_mesh(MeshConfig(), devices=['cpu'] * 3)) == 3
    with pytest.raises(ValueError, match='does not tile 2 devices'):
        make_mesh(MeshConfig(data=3), devices=['cpu', 'cpu'])
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match='does not tile'):
            make_mesh(MeshConfig(data=2))
    # the model axis: rows spread over data only, each data row's first device
    grid = ['cpu:0', 'cpu:1', 'cpu:2', 'cpu:3']
    assert MeshConfig(data=2, model=2) == MeshConfig(2, 2)
    assert make_mesh(MeshConfig(data=2, model=2), devices=grid) == \
        [torch.device('cpu:0'), torch.device('cpu:2')]
    assert make_mesh(MeshConfig(model=2), devices=grid) == make_mesh(MeshConfig(2, 2), grid)
    with pytest.raises(ValueError, match='mesh 3x2 does not tile 4 devices'):
        make_mesh(MeshConfig(data=3, model=2), devices=grid)


def _session(tmp_path, mesh: dict, max_steps=2, **schedule):
    """A TTS session at the tiny widths (float32, dropout 0) with ``mesh``,
    over 8 synthetic training samples and 2 validation samples."""
    import chip_smoke
    from test_torch_nn import TINY_CONFIG
    from transformertts_torch.utils.config import TrainingConfigManager
    cfg = chip_smoke.write_session(
        tmp_path,
        tts_overrides={**{k: TINY_CONFIG[k] for k in (
            'encoder_model_dimension', 'decoder_model_dimension', 'encoder_num_heads',
            'decoder_num_heads', 'encoder_attention_conv_filters',
            'decoder_attention_conv_filters', 'duration_conv_filters',
            'pitch_conv_filters')}, 'compute_dtype': 'float32', 'dropout_rate': 0.0,
            'predictors_dropout': 0.0, 'mesh': mesh, 'max_steps': max_steps,
            'validation_frequency': 100, 'checkpoint_frequency': 1,
            'weights_save_frequency': 100, 'prediction_start_step': 100, **schedule},
        data_overrides={'bucket_boundaries': [60, 90], 'bucket_batch_sizes': [3, 3, 3],
                        'val_bucket_batch_size': [3, 3, 3]})
    cm = TrainingConfigManager(cfg)
    chip_smoke.write_synthetic_data(cm, n_train=8, n_valid=2, frames=(40, 80))
    return cfg, cm


def test_config_mesh_larger_than_the_world_raises(tmp_path):
    from transformertts_torch import train_tts
    from transformertts_torch.utils.config import TrainingConfigManager
    cfg, cm = _session(tmp_path, {'data': 4, 'model': 1})
    model = cm.get_model('cpu')
    with pytest.raises(ValueError, match='mesh 4x1 does not tile 1 devices'):
        cm.get_mesh('cpu')
    with pytest.raises(ValueError, match='does not tile'):
        cm.get_trainer(model)
    with pytest.raises(ValueError, match='does not tile'):
        train_tts.main(['--config', str(cfg), '--yes', '--device', 'cpu'])
    assert not dist.is_initialized()


def test_config_model_axis_raises(tmp_path, monkeypatch):
    """A mesh whose data × model is not the world size raises before any
    process group comes up: {data: 3, model: 2} over 4 ranks, and
    {data: -1, model: 2} in one process."""
    from transformertts_torch.utils.config import TrainingConfigManager
    cfg, _ = _session(tmp_path, {'data': -1, 'model': 2})
    with pytest.raises(ValueError, match='mesh 0x2 does not tile 1 devices'):
        TrainingConfigManager(cfg).get_mesh('cpu')
    cfg, _ = _session(tmp_path, {'data': 3, 'model': 2})
    monkeypatch.setenv('RANK', '0')
    monkeypatch.setenv('WORLD_SIZE', '4')
    with pytest.raises(ValueError, match=r'mesh 3x2 does not tile 4 devices \(world size 4\)'):
        TrainingConfigManager(cfg).get_mesh('cpu')
    assert not dist.is_initialized()


def test_config_without_a_launch_is_one_ungrouped_process(tmp_path):
    from transformertts_torch.utils.config import TrainingConfigManager
    cfg, _ = _session(tmp_path, {'data': -1, 'model': 1}, multihost=True)
    cm = TrainingConfigManager(cfg)
    assert cm.get_mesh('cpu') == ProcessMesh(0, 1, False)
    trainer = cm.get_trainer(cm.get_model('cpu').init_params(torch.Generator().manual_seed(0)))
    assert trainer.mesh == ProcessMesh(0, 1, False) and not dist.is_initialized()


def test_dropout_streams_differ_by_rank_and_rank_0_keeps_one_process_stream():
    from test_torch_nn import TINY_CONFIG
    from transformertts_torch.models.forward_tts import ForwardTransformer
    from transformertts_torch.ops.flash_attention import draw_seed_offset
    from transformertts_torch.training.forward_trainer import ForwardTrainer
    model = ForwardTransformer(**TINY_CONFIG).init_params(torch.Generator().manual_seed(0))
    one = ForwardTrainer(model, SCHEDULE)
    ranks = [ForwardTrainer(model, SCHEDULE, mesh=ProcessMesh(r, 4)) for r in range(4)]
    for step in (0, 7):
        assert one.step_generator(step).initial_seed() == 42 * 2 ** 32 + step
        seeds = [t.step_generator(step).initial_seed() for t in ranks]
        assert seeds[0] == one.step_generator(step).initial_seed()
        assert len(set(seeds)) == 4
        keys = {draw_seed_offset(t.step_generator(step)) for t in ranks}
        masks = {tuple(torch.rand(8, generator=t.step_generator(step)).tolist())
                 for t in ranks}
        assert len(keys) == 4 and len(masks) == 4


def test_checkpoints_are_written_by_rank_0_only(tmp_path):
    from test_torch_nn import TINY_CONFIG
    from transformertts_torch.models.forward_tts import ForwardTransformer
    from transformertts_torch.training import checkpointing
    from transformertts_torch.training.forward_trainer import ForwardTrainer
    model = ForwardTransformer(**TINY_CONFIG).init_params(torch.Generator().manual_seed(0))
    opt = ForwardTrainer(model, SCHEDULE).optimizer
    path = checkpointing.save_checkpoint(tmp_path, model, opt, 3, mesh=ProcessMesh(1, 2))
    assert path == tmp_path / 'ckpt_3.npz' and not path.exists()
    checkpointing.save_checkpoint(tmp_path, model, opt, 3, mesh=ProcessMesh(0, 2))
    assert [s for s, _ in checkpointing.list_checkpoints(tmp_path)] == [3]


# ---------------------------------------------------------------------------
# (c) the training CLI under two gloo ranks, config-driven
# ---------------------------------------------------------------------------

def test_train_tts_cli_over_two_ranks_and_resume(tmp_path):
    from transformertts_torch.training import checkpointing
    cfg, cm = _session(tmp_path, {'data': 2, 'model': 1}, max_steps=2,
                       validation_frequency=2)
    argv = [sys.executable, '-m', 'transformertts_torch.train_tts', '--config', str(cfg),
            '--yes', '--device', 'cpu']
    port = _free_port()
    results = _run_ranks(lambda r: argv, env_of=lambda r: _rank_env(r, WORLD, port))
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, f'rank {rank}: {err[-3000:]}'
        assert f'rank {rank} of 2 (data {rank} of 2, model 0 of 1)' in out and 'done' in out
    assert [s for s, _ in checkpointing.list_checkpoints(cm.weights_dir)] == [1, 2]
    # rank 0 alone logs: one event file a writer
    events = sorted(p.relative_to(cm.log_dir).parent for p in cm.log_dir.rglob('events.*'))
    assert events and len(events) == len(set(events))
    assert 'CONFIGURATION' in results[0][1] and 'CONFIGURATION' not in results[1][1]

    # resume to step 3: every rank restores step 2
    cfg, _ = _session(tmp_path, {'data': 2, 'model': 1}, max_steps=3)
    port = _free_port()
    results = _run_ranks(lambda r: argv, env_of=lambda r: _rank_env(r, WORLD, port))
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, f'rank {rank}: {err[-3000:]}'
        assert 'resumed from step 2' in out
    assert [s for s, _ in checkpointing.list_checkpoints(cm.weights_dir)][-1] == 3


# ---------------------------------------------------------------------------
# (f) serving over a mesh of two CPU devices
# ---------------------------------------------------------------------------

LINES = [l for l in (ROOT / 'config' / 'test_sentences.txt').read_text().splitlines()
         if l.strip()] + ['a much longer sentence with many words in it', 'short',
                          'and another']


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    from test_torch_nn import jax_and_port_models
    return jax_and_port_models(tmp_path_factory.mktemp('tiny'))


def test_batch_bucket_floor_matches_jax():
    from transformertts_torch.models.synthesis import _batch_bucket
    from transformertts_tpu.models.synthesis import _batch_bucket as j_bucket
    for b in (1, 2, 3, 5, 17, 31, 32, 40):
        assert _batch_bucket(b, 32) == j_bucket(b, 32)
    assert [_batch_bucket(b, 32, min_batch=4) for b in (1, 3, 5, 40)] == [4, 4, 8, 32]
    assert [_batch_bucket(b, 12, min_batch=2) for b in (1, 3, 7, 12)] == \
        [j_bucket(b, 12, 2) for b in (1, 3, 7, 12)]


def test_mesh_serving_matches_one_device_and_jax_mesh(served):
    """Two CPU replicas give the single-device wavs (to float32 rounding),
    and the JAX package's wavs over a 2-device mesh to the bar
    ``tests/test_forward_tts.py`` holds that mesh to against one device
    (SPMD sums in another order, which Griffin-Lim amplifies; 2 iterations
    here)."""
    import jax
    from transformertts_torch.audio import Audio as TAudio
    from transformertts_torch.models.synthesis import synthesize_lines
    from transformertts_tpu.audio import Audio as JAudio
    from transformertts_tpu.models.synthesis import synthesize_lines as j_synthesize
    from transformertts_tpu.parallel import MeshConfig as JMeshConfig
    from transformertts_tpu.parallel import make_mesh as j_make_mesh
    jm, tm = served
    audio = TAudio.from_config(tm.config)
    mesh = make_mesh(MeshConfig(data=2), devices=['cpu', 'cpu'])
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    got = synthesize_lines(tm, audio, LINES, n_iter=2, max_batch=3, mesh=mesh)
    one = synthesize_lines(tm, audio, LINES, n_iter=2, max_batch=4)
    j_mesh = j_make_mesh(JMeshConfig(data=2, model=1), devices=jax.devices()[:2])
    j_wavs = j_synthesize(jm, JAudio.from_config(jm.config), LINES, n_iter=2, max_batch=3,
                          mesh=j_mesh)
    assert len(got) == len(one) == len(j_wavs) == len(LINES)
    for g, o, j in zip(got, one, j_wavs):
        assert g.shape == o.shape == j.shape and g.size > 0
        np.testing.assert_allclose(g, o, rtol=0, atol=1e-5)
        diff = np.abs(g - j)
        assert np.mean(diff) < 2e-3 and np.max(diff) < 0.1, (np.mean(diff), np.max(diff))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_mesh_warmup_count_and_shares_match_jax(served, monkeypatch):
    from test_torch_warmup import _jax_count
    import jax
    from transformertts_torch.audio import Audio as TAudio
    from transformertts_torch.models import synthesis
    from transformertts_tpu.parallel import MeshConfig as JMeshConfig
    from transformertts_tpu.parallel import make_mesh as j_make_mesh
    _, tm = served
    mesh = make_mesh(MeshConfig(data=2), devices=['cpu', 'cpu'])
    shapes = []
    decode = synthesis.decode_to_wav

    def spy(model, audio, enc, use, frames, n_iter, vocoder=None):
        shapes.append((use.shape[0], frames))
        return decode(model, audio, enc, use, frames, n_iter, vocoder)

    monkeypatch.setattr(synthesis, 'decode_to_wav', spy)
    kwargs = dict(max_batch=5, token_buckets=(32,), frame_buckets=(128,))
    n = synthesis.warmup_serving(tm, TAudio.from_config(tm.config), n_iter=1, mesh=mesh,
                                 **kwargs)
    j_mesh = j_make_mesh(JMeshConfig(data=2, model=1), devices=jax.devices()[:2])
    assert n == _jax_count(False, mesh=j_mesh, **kwargs) == 3
    # max_batch 5 rounds up to 6; the ragged buckets start at 2: 6, 2, 4 rows
    assert shapes == [(3, 128), (3, 128), (1, 128), (1, 128), (2, 128), (2, 128)]


def test_predict_tts_data_parallel_over_two_cpu_devices(served, tmp_path):
    from transformertts_torch import predict_tts
    from transformertts_torch.audio.wav_io import load_wav
    jm, _ = served
    model_dir = tmp_path / 'model'
    jm.save_model(model_dir)
    text = tmp_path / 'lines.txt'
    text.write_text('\n'.join(LINES[:3]) + '\n')
    for n, out in ((2, 'mesh'), (None, 'one')):
        argv = ['-p', str(model_dir), '-f', str(text), '-o', str(tmp_path / out),
                '--device', 'cpu'] + ([] if n is None else ['--data_parallel', str(n)])
        predict_tts.main(argv)
    wavs = {out: {p.name: load_wav(p)[0] for p in sorted((tmp_path / out).rglob('*.wav'))}
            for out in ('mesh', 'one')}
    assert wavs['mesh'].keys() == wavs['one'].keys() and wavs['one']
    for name, wav in wavs['one'].items():
        assert wav.size > 0 and wavs['mesh'][name].shape == wav.shape
        np.testing.assert_allclose(wavs['mesh'][name], wav, atol=1 / 32767)
    with pytest.raises(ValueError, match='does not tile'):
        predict_tts.main(['-p', str(model_dir), '-f', str(text), '--data_parallel', '2'])


# ---------------------------------------------------------------------------
# on the card: a process group of one over NCCL
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('NCCL and the CUDA kernels run only on a card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
def test_nccl_group_of_one_trains_as_one_process_on_card(cuda):
    """Two steps of the published width at 2+2 blocks (float32, dropout 0)
    on the kernels, with and without an NCCL process group of one: the same
    losses and parameters, and K2/K3/K4 launched alike. Deterministic
    algorithms are on for both: the length regulator's gather backward
    otherwise adds with atomics in any order."""
    import chip_smoke
    from transformertts_torch.models.forward_tts import ForwardTransformer
    from transformertts_torch.ops import flash_attention as fa
    from transformertts_torch.profile_train import synthetic_batch
    from transformertts_torch.training.forward_trainer import ForwardTrainer
    config = {**chip_smoke.PUBLISHED, 'encoder_num_heads': [2, 2], 'decoder_num_heads': [2, 2],
              'dropout_rate': 0.0, 'predictors_dropout': 0.0, 'compute_dtype': 'float32'}
    start = ForwardTransformer(**config).init_params(torch.Generator().manual_seed(0))
    batch = synthetic_batch(start, b=8, n_tok=64, n_frames=256, seed=1)
    ops = (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)

    def run():
        model = ForwardTransformer(**config).to(cuda)
        model.load_state_dict(start.state_dict())
        trainer = ForwardTrainer(model, SCHEDULE)
        counts = [f.launches for f in ops]
        losses = [trainer.train_step(batch)['loss'].item() for _ in range(2)]
        torch.cuda.synchronize()
        return (losses, {k: v.clone() for k, v in model.state_dict().items()},
                [f.launches - c for f, c in zip(ops, counts)], trainer.mesh)

    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        alone = run()
        dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:{_free_port()}',
                                rank=0, world_size=1)
        try:
            grouped = run()
        finally:
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    assert alone[3] == ProcessMesh(0, 1, False) and grouped[3] == ProcessMesh(0, 1, True)
    assert grouped[2] == alone[2] == [8, 8, 8]
    diffs = {k: (v - alone[1][k]).abs().max().item() for k, v in grouped[1].items()}
    print(f'losses {grouped[0]} grouped, {alone[0]} alone; largest parameter difference '
          f'{max(diffs.values())}')
    assert grouped[0] == alone[0]
    assert max(diffs.values()) == 0.0


if __name__ == '__main__':
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
