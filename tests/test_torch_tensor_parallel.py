"""Tensor parallelism (the mesh's ``model`` axis) and ZeRO-1 in the port
(``parallel/mesh.py``'s ``tp_rules`` and ``zero1_partition``,
``parallel/tensor_parallel.py``, ``training/state.py``'s ``FlatAdam``,
full-width checkpoints and model dirs) against one port process and the JAX
package, on the CPU at tiny configs, float32, dropout 0 unless stated.

Ranks are Python processes joined by a gloo group on a free local port,
one thread each; each runs this file as a script (``python
tests/test_torch_tensor_parallel.py <rank> <world> <port> <jobs>``), takes
the jobs' steps on one mesh after another and saves what they gave. The
TTS is ``tests/test_mesh_training.py``'s tiny config (d 32, one dense block
then one conv block: its ``ffn`` and its conv filters [512, 32] are the
sharded pairs), the Aligner ``test_torch_aligner.py``'s (its ``ffn``
pairs, 64 wide).

Bars: losses to rtol 1e-5 of one process; the full-width parameters and
Adam moments after 3 steps leaf by leaf to atol 1e-5 + 1e-4·max|leaf| of
one process (tensor parallelism sums conv_1's and d2's inputs in two
parts, the data ranks' gradients in another order), except where the true
gradient is 0 or rounding noise (a softmax is invariant to a shift of its
keys, so the wk biases' gradient is noise, whose sign Adam's ε of 1e-9
turns into steps of ≈ lr): those parameters to 2.05·3·lr, moments to
1e-5 + 3e-4·max|leaf| (`_leaves_close`); the JAX 2 × 2 step to the same
bars; the model ranks' replicated parameters equal bit for bit.
Each rank has its own time limit, so a hung rank fails its test.
"""
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))   # run as a rank's script
sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_parallel import _free_port, _rank_env  # noqa: E402
from transformertts_torch.parallel.mesh import (ProcessMesh, tp_rules,  # noqa: E402
                                                zero1_partition)
from transformertts_torch.training import checkpointing  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SCHEDULE = [(0, 1e-3), (10, 5e-4), (100, 1e-4)]
LR = SCHEDULE[0][1]
STEPS = 3
NO_DROPOUT = dict(dropout_rate=0.0, predictors_dropout=0.0)
# tests/test_mesh_training.py's TTS widths
MESH_TTS = dict(encoder_model_dimension=32, decoder_model_dimension=32,
                encoder_num_heads=[2, 2], decoder_num_heads=[2, 2],
                encoder_feed_forward_dimension=32, decoder_feed_forward_dimension=32,
                encoder_attention_conv_filters=[512, 32],
                decoder_attention_conv_filters=[512, 32],
                encoder_dense_blocks=1, decoder_dense_blocks=1,
                duration_conv_filters=[16, 8], pitch_conv_filters=[16, 8])
LAYOUTS = {'2x2': (2, 2), '1x2': (1, 2), '2x1': (2, 1)}


# ---------------------------------------------------------------------------
# steps on a mesh, in this process or as one rank of a gloo group
# ---------------------------------------------------------------------------

def _steps(job: dict, mesh: ProcessMesh) -> dict:
    """The job's model from its full weights, ``STEPS`` train steps on its
    batch over ``mesh``: each step's loss, the full-width checkpoint leaves
    after them, this rank's local parameters, its ZeRO-1 share and the
    first step's dropout seed."""
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
    losses = [trainer.train_step(job['batch'], **job['options'])['loss'].item()
              for _ in range(STEPS)]
    group = trainer.optimizer.groups[0]
    moment = trainer.optimizer.adam.state[group.shard]['exp_avg']
    return dict(losses=losses, seed=seed,
                leaves=checkpointing.flatten_state(model, trainer.optimizer, trainer.step),
                local={k: v.clone() for k, v in model.state_dict().items()},
                share=(group.start, group.stop, sum(p.numel() for p in model.parameters()),
                       moment.numel()),
                mesh=(mesh.data_rank, mesh.data_size, mesh.model_rank, mesh.model_size))


def _rank_main(rank: int, world: int, port: int, jobs_path: str):
    """One rank: join the gloo group, take each job's steps on its mesh,
    save the records."""
    torch.set_num_threads(1)
    jobs = torch.load(jobs_path, weights_only=False)
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}', rank=rank,
                            world_size=world)
    try:
        records = {name: _steps(job, ProcessMesh.current(job['model_size']))
                   for name, job in jobs.items()}
    finally:
        dist.destroy_process_group()
    torch.save(records, f'{jobs_path}.rank{rank}')


def _start_ranks(jobs: dict, world: int, work: Path):
    """Start ``world`` ranks on ``jobs``; returns a function that waits for
    them and returns each rank's records."""
    import subprocess
    path = work / f'jobs{world}.pt'
    torch.save(jobs, path)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(port),
                               str(path)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env={**os.environ, 'OMP_NUM_THREADS': '1'})
             for r in range(world)]

    def wait():
        try:
            for r, p in enumerate(procs):
                _, err = p.communicate(timeout=RANK_TIMEOUT_S)
                assert p.returncode == 0, f'rank {r} of {world}: {err[-3000:]}'
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        return [torch.load(f'{path}.rank{r}', weights_only=False) for r in range(world)]

    return wait


RANK_TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# the jobs: the same weights and batch on every mesh
# ---------------------------------------------------------------------------

def _tts_models(seed=21, **overrides):
    import jax
    from test_torch_nn import TINY_CONFIG
    from transformertts_torch.models.forward_tts import ForwardTransformer as TFT
    from transformertts_torch.models.persistence import params_from_jax
    from transformertts_tpu.models.forward_tts import ForwardTransformer as JFT
    from transformertts_tpu.utils.pytree import flatten_params
    config = {**TINY_CONFIG, **NO_DROPOUT, **MESH_TTS, **overrides}
    jm = JFT(**config)
    jm.init_params(jax.random.PRNGKey(seed))
    tm = TFT(**config)
    tm.load_state_dict(params_from_jax(flatten_params(jm.params)), strict=True)
    return config, jm, tm


def _jobs():
    """(name → job, JAX model, batch) for the parity runs; every job's
    weights are full width."""
    from test_torch_aligner import TINY_ALIGNER
    from test_torch_aligner_training import _batch as aligner_batch
    from test_torch_training import _batch as tts_batch
    from transformertts_torch.models.aligner import Aligner
    config, jm, tm = _tts_models()
    batch = tts_batch(jm.text_pipeline.tokenizer.vocab_size, b=6, seed=22)
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    tts = dict(kind='tts', model=config, state=state, batch=batch, options={}, n=1)
    aligner_config = {**TINY_ALIGNER, 'dropout_rate': 0.0, 'decoder_prenet_dropout': 0.0}
    aligner = Aligner(**aligner_config).init_params(torch.Generator().manual_seed(23))
    jobs = {name: dict(tts, model_size=m) for name, (_, m) in LAYOUTS.items()}
    jobs['2x2-accumulate-2'] = dict(tts, model_size=2, n=2)
    jobs['aligner-2x2'] = dict(
        kind='aligner', model=aligner_config, model_size=2, n=1, options=dict(r=1),
        state={k: v.clone() for k, v in aligner.state_dict().items()},
        batch=aligner_batch(aligner.text_pipeline.tokenizer.vocab_size, b=6, seed=24))
    jobs['1x2-dropout'] = dict(
        tts, model={**config, 'dropout_rate': 0.1, 'predictors_dropout': 0.1}, model_size=2)
    return jobs, jm, batch


# each job's one-process run: the TTS layouts share the '2x2' job's
ONE = {'2x2': '2x2', '1x2': '2x2', '2x1': '2x2', '2x2-accumulate-2': '2x2-accumulate-2',
       'aligner-2x2': 'aligner-2x2', '1x2-dropout': '1x2-dropout'}


def _session_mesh(cfg: Path, section: str, **settings):
    """Rewrite the session YAML ``cfg`` with ``settings`` in ``section``."""
    import yaml
    session = yaml.safe_load(cfg.read_text())
    session[section].update(settings)
    cfg.write_text(yaml.safe_dump(session))


def _cli_sessions(work: Path) -> dict:
    """A TTS session seeded with a JAX checkpoint at step 1 and an Aligner
    session, both at mesh {2, 2} (float32, dropout 0, checkpoints every
    step): kind → (session yaml, config manager, max steps)."""
    import jax
    from test_torch_aligner_training import _tiny_session
    from test_torch_parallel import _session
    from test_torch_training import _batch as tts_batch
    from transformertts_tpu.parallel import MeshConfig, make_mesh
    from transformertts_tpu.training import ForwardTrainer, make_optimizer
    from transformertts_tpu.training import checkpointing as j_ckpt
    from transformertts_tpu.utils.config import TrainingConfigManager as JConfig
    mesh = {'data': 2, 'model': 2}
    cfg, cm = _session(work / 'tts', mesh, max_steps=3, weights_save_frequency=2,
                       weights_save_starting_step=0)
    jm = JConfig(cfg).get_model()
    jm.init_params(jax.random.PRNGKey(31))
    trainer = ForwardTrainer(jm, make_optimizer(SCHEDULE),
                             mesh=make_mesh(MeshConfig(1, 1), jax.devices('cpu')[:1]))
    batch = tts_batch(jm.text_pipeline.tokenizer.vocab_size, b=4, seed=32)
    state, _ = trainer.train_step(trainer.init_state(params=jm.params),
                                  {k: v.astype(np.int32) if v.dtype.kind in 'iu' else v
                                   for k, v in batch.items()})
    j_ckpt.save_checkpoint(cm.weights_dir, state)
    a_cfg, a_cm = _tiny_session(
        work / 'aligner', mesh=mesh, max_steps=2, reduction_factor_schedule=[[0, 3], [1, 1]],
        force_encoder_diagonal_steps=1, force_decoder_diagonal_steps=1, dropout_rate=0.0,
        decoder_prenet_dropout=0.0, validation_frequency=2, checkpoint_frequency=1,
        train_images_plotting_frequency=100, prediction_start_step=100)
    return {'tts': (cfg, cm, 3), 'aligner': (a_cfg, a_cm, 2)}


def _start_cli(kind: str, cfg: Path):
    """The ``kind`` training CLI under 4 gloo ranks, each with the
    environment torchrun gives it; returns a function that waits for them
    and returns each rank's (return code, stdout, stderr)."""
    import subprocess
    argv = [sys.executable, '-m', f'transformertts_torch.train_{kind}', '--config', str(cfg),
            '--yes', '--device', 'cpu']
    port = _free_port()
    procs = [subprocess.Popen(argv, cwd=ROOT, env=_rank_env(r, 4, port), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(4)]

    def wait():
        try:
            outputs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
            return [(p.returncode,) + out for p, out in zip(procs, outputs)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()

    return wait


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Every layout's records and the CLIs at {2, 2}, all started at once;
    meanwhile, the same jobs in this process and the JAX trainer's 3 steps
    on a 2 × 2 mesh of virtual CPU devices."""
    work = tmp_path_factory.mktemp('tp')
    jobs, jm, batch = _jobs()
    sessions = _cli_sessions(work)
    four = {k: v for k, v in jobs.items() if k.startswith(('2x2', 'aligner'))}
    two = {k: v for k, v in jobs.items() if k not in four}
    waits = [_start_ranks(four, 4, work), _start_ranks(two, 2, work)]
    clis = {kind: _start_cli(kind, cfg) for kind, (cfg, _, _) in sessions.items()}
    one = {name: _steps(jobs[name], ProcessMesh()) for name in set(ONE.values())}
    j_losses, j_leaves = _jax_steps(jm, batch)
    ranks = {}
    for wait in waits:
        records = wait()
        for name in records[0]:
            ranks[name] = [r[name] for r in records]
    return dict(ranks=ranks, one=one, jax_losses=j_losses, jax_leaves=j_leaves, jobs=jobs,
                sessions=sessions, clis={kind: wait() for kind, wait in clis.items()})


def _jax_steps(jm, batch):
    """The JAX ForwardTrainer's 3 steps on a (data 2, model 2) mesh: its
    losses and its checkpoint leaves."""
    import jax
    from transformertts_tpu.parallel import MeshConfig, make_mesh
    from transformertts_tpu.training import ForwardTrainer, make_optimizer
    from transformertts_tpu.training import checkpointing as j_ckpt
    mesh = make_mesh(MeshConfig(data=2, model=2), devices=jax.devices('cpu')[:4])
    trainer = ForwardTrainer(jm, make_optimizer(SCHEDULE), mesh=mesh)
    state = trainer.init_state(params=jm.params)
    jbatch = {k: v.astype(np.int32) if v.dtype.kind in 'iu' else v for k, v in batch.items()}
    losses = []
    for _ in range(STEPS):
        state, aux = trainer.train_step(state, jbatch)
        losses.append(float(np.mean(aux['loss'])))
    return losses, j_ckpt._flatten_state(jax.device_get(state))


def _leaves_close(mine: dict, want: dict, what: str):
    """Checkpoint leaves at the bars of the module docstring: the step
    and counts equal; moments to 1e-5 + 3e-4·max|leaf|; parameters to
    1e-5 + 1e-4·max|leaf| + 0.05·STEPS·lr, and to 2.05·STEPS·lr where the
    reference's √ν is under 1e-6 of the model's largest (a gradient that is
    rounding noise, or 0: Adam steps it by at most 1.0023·lr in each of the
    first three steps at β 0.9/0.98, either way)."""
    assert mine.keys() == want.keys(), what
    n = (len(want) - 3) // 3
    for i in (0, n + 1, 3 * n + 2):
        assert int(mine[f'leaf_{i:05d}']) == int(want[f'leaf_{i:05d}']), (what, i)
    root_nu = [np.sqrt(np.asarray(want[f'leaf_{2 * n + 2 + j:05d}'], np.float64))
               for j in range(n)]
    floor = 1e-6 * max(r.max(initial=0.0) for r in root_nu)
    for i in list(range(1, n + 1)) + list(range(n + 2, 3 * n + 2)):
        key = f'leaf_{i:05d}'
        a, b = np.asarray(mine[key], np.float64), np.asarray(want[key], np.float64)
        assert a.shape == b.shape, (what, key)
        if i <= n:
            atol = np.where(root_nu[i - 1] < floor, 2.05 * STEPS * LR,
                            1e-5 + 1e-4 * np.abs(b).max(initial=0.0) + 0.05 * STEPS * LR)
        else:
            atol = 1e-5 + 3e-4 * np.abs(b).max(initial=0.0)
        excess = np.abs(a - b) - atol
        assert (excess <= 0).all(), f'{what} {key}: over its bar by up to {excess.max()}'


# ---------------------------------------------------------------------------
# (a) the rule against tp_param_specs; the published models' shares
# ---------------------------------------------------------------------------

def _port_name(path: str) -> str:
    from transformertts_torch.models.persistence import params_from_jax
    return next(iter(params_from_jax({path: np.zeros((2, 2) if path.endswith('kernel')
                                                     else (2,))})))


def _jax_rules(params: dict) -> dict:
    """``tp_param_specs`` of a JAX parameter tree on a (data 4, model 2)
    mesh, as port names → (mode, PyTorch dim)."""
    import jax
    from transformertts_tpu.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=4, model=2),
                              devices=jax.devices('cpu')[:8])
    specs = mesh_lib.tp_param_specs(params, mesh)
    rules = {}

    def walk(tree, spec, prefix):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], spec[k], f'{prefix}{k}/')
            return
        path = prefix[:-1]
        parts = tuple(spec)
        if mesh_lib.MODEL_AXIS not in parts:
            rules[_port_name(path)] = ('replicated', None)
        elif path.endswith('bias') or parts[-1] == mesh_lib.MODEL_AXIS:
            rules[_port_name(path)] = ('column', 0)     # JAX's last dim: PyTorch's 0
        else:
            rules[_port_name(path)] = ('row', 1)        # JAX's second to last: 1
    walk(params, specs, '')
    return rules


def test_tp_rules_match_jax_tp_param_specs():
    """The port's rule gives JAX's sharding on the same weights carried
    across: tests/test_mesh_training.py's rule table (a same-shaped
    unrelated tensor stays whole; a matched dim that does not divide warns
    and stays whole) and the tiny TTS and Aligner of these tests."""
    from test_torch_aligner import jax_and_port_aligners
    from transformertts_torch.models.persistence import params_from_jax
    from transformertts_tpu.utils.pytree import flatten_params
    table = {
        'enc': {'conv_0': {'conv': {
            'conv_0': {'kernel': np.zeros((3, 64, 512)), 'bias': np.zeros(512)},
            'conv_1': {'kernel': np.zeros((3, 512, 64)), 'bias': np.zeros(64)}}}},
        'ffn': {'d1': {'kernel': np.zeros((64, 512)), 'bias': np.zeros(512)},
                'd2': {'kernel': np.zeros((512, 64)), 'bias': np.zeros(64)}},
        'other': {'proj': {'kernel': np.zeros((64, 512)), 'bias': np.zeros(512)}},
        'odd': {'ffn': {'d1': {'kernel': np.zeros((64, 513)), 'bias': np.zeros(513)}}},
    }
    _, jm, _ = _tts_models()
    aligner, _ = jax_and_port_aligners()
    for params in (table, jm.params, aligner.params):
        state = params_from_jax(flatten_params(params))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            mine = tp_rules(state.items(), 2)
        assert mine == _jax_rules(params)
        assert any(r[0] != 'replicated' for r in mine.values())
        if params is table:
            assert mine['enc.conv_0.conv.conv_0.weight'] == ('column', 0)
            assert mine['enc.conv_0.conv.conv_1.weight'] == ('row', 1)
            assert mine['enc.conv_0.conv.conv_1.bias'] == ('replicated', None)
            assert mine['other.proj.weight'] == ('replicated', None)
            assert mine['odd.ffn.d1.weight'] == ('replicated', None)
            assert any('does not divide' in str(w.message) for w in caught)
    assert all(v == ('replicated', None) for v in tp_rules(state.items(), 1).values())


@pytest.mark.parametrize('kind, pairs, row_biases, total, tensors', [
    ('tts', 42_490_368, 12 * 384, 52_396_772, 223),
    ('aligner', 2_366_208, 9 * 256, 7_312_741, None)])
def test_published_models_shard_only_their_pairs(kind, pairs, row_biases, total, tensors):
    """At config/training_config.yaml's widths only the Megatron pairs
    split over ``model``: the TTS's 12 conv_0/conv_1 pairs (384 → 1536 →
    384, k 3) and the Aligner's 9 ffn pairs (256 → 512 → 256), all but
    their row modules' biases, which stay whole."""
    from transformertts_torch.utils.config import TrainingConfigManager
    model = TrainingConfigManager(ROOT / 'config' / 'training_config.yaml',
                                  aligner=kind == 'aligner').get_model('cpu')
    named = list(model.named_parameters())
    rules = tp_rules(named, 2)
    split = {n for n, r in rules.items() if r[1] is not None}
    names = {'tts': ('conv.conv_0', 'conv.conv_1'), 'aligner': ('ffn.d1', 'ffn.d2')}[kind]
    in_pairs = {n for n, _ in named if '.'.join(n.split('.')[-3:-1]) in names}
    assert split <= in_pairs
    assert sum(p.numel() for n, p in named if n in in_pairs) == pairs
    assert sum(p.numel() for n, p in named if n in split) == pairs - row_biases
    assert sum(p.numel() for _, p in named) == total
    assert tensors is None or len(named) == tensors


# ---------------------------------------------------------------------------
# (b) ZeRO-1's partition
# ---------------------------------------------------------------------------

def test_zero1_partition_covers_the_state_in_ceil_shares():
    for n, data in ((10, 1), (10, 2), (10, 3), (7, 4), (3, 4)):
        shares = [zero1_partition(n, data, r) for r in range(data)]
        chunk = -(-n // data)
        assert all(stop - start == chunk for start, stop in shares)
        assert [s for s, _ in shares] == [r * chunk for r in range(data)]
        assert shares[-1][1] >= n > shares[-1][0] - (chunk if data > 1 else 0)


@pytest.mark.parametrize('name', ['2x2', '2x1', '1x2', 'aligner-2x2'])
def test_each_data_rank_holds_its_share_of_the_moments(runs, name):
    """Each data rank keeps ⌈n/D⌉ of the flat Adam state (n: its model
    rank's parameters), the data ranks' shares tile it, the model ranks of
    a data row hold the same share, and no rank at ``data`` > 1 holds
    the whole."""
    data, model = LAYOUTS.get(name, (2, 2))
    records = runs['ranks'][name]
    for rank, record in enumerate(records):
        start, stop, n, held = record['share']
        assert record['mesh'] == (rank // model, data, rank % model, model)
        chunk = -(-n // data)
        assert (start, stop) == zero1_partition(n, data, rank // model)
        assert held == stop - start == chunk and (data == 1 or held < n)


# ---------------------------------------------------------------------------
# (c), (e), (f): three steps on each layout against one process and JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', sorted(ONE))
def test_layout_matches_one_process(runs, name):
    """Losses, full-width parameters and moments after 3 steps: every rank
    gathers the same checkpoint, which one process's matches at the bars."""
    one = runs['one'][ONE[name]]
    for record in runs['ranks'][name]:
        np.testing.assert_allclose(record['losses'], one['losses'], rtol=1e-5)
        _leaves_close(record['leaves'], one['leaves'], name)
        for key, value in record['leaves'].items():
            np.testing.assert_array_equal(value, runs['ranks'][name][0]['leaves'][key])


def test_2x2_matches_the_jax_step_on_a_2x2_mesh(runs):
    for record in runs['ranks']['2x2']:
        np.testing.assert_allclose(record['losses'], runs['jax_losses'], rtol=1e-5)
        _leaves_close(record['leaves'], runs['jax_leaves'], '2x2 against JAX')


@pytest.mark.parametrize('name', sorted(ONE))
def test_model_ranks_hold_identical_replicated_parameters(runs, name):
    """The model ranks of a data row draw the same masks and sum the same
    partial products, so their replicated parameters stay equal bit for
    bit; each holds its half of every sharded one."""
    data, model = LAYOUTS.get(name, (1, 2) if 'dropout' in name else (2, 2))
    records = runs['ranks'][name]
    full = runs['jobs'][name]['state']
    rules = tp_rules([(k, v) for k, v in full.items()], model)
    for rank, record in enumerate(records):
        partner = records[rank - rank % model]
        for key, value in record['local'].items():
            mode, dim = rules[key]
            if dim is None:
                assert torch.equal(value, partner['local'][key]), (name, rank, key)
            else:
                assert value.shape[dim] * model == full[key].shape[dim], (name, key)


def test_dropout_masks_follow_the_data_rank(runs):
    """With dropout 0.1, {1, 2} takes the steps of one process (the same
    masks: both model ranks seed from data rank 0, one process's stream);
    on {2, 2} the model ranks of a data row share a seed and the rows
    differ."""
    one = runs['one']['1x2-dropout']
    for record in runs['ranks']['1x2-dropout']:
        assert record['seed'] == one['seed'] == 42 * 2 ** 32
    seeds = [r['seed'] for r in runs['ranks']['2x2']]
    assert seeds[0] == seeds[1] == one['seed'] and seeds[2] == seeds[3] != seeds[0]


# ---------------------------------------------------------------------------
# (d) the CLIs at {2, 2}, resumed at {1, 1} and restored by the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['tts', 'aligner'])
def test_cli_at_2x2_resumes_at_1x1_and_in_jax(runs, kind):
    """The CLI at mesh {2, 2} over 4 gloo ranks (the TTS resuming a JAX
    checkpoint of step 1), then one process at {1, 1} resuming its last
    checkpoint for one more step, whose checkpoint the JAX package
    restores; the TTS's model dir written at {2, 2} holds the full weights
    of its step's checkpoint."""
    import jax
    from transformertts_torch import train_aligner, train_tts
    from transformertts_tpu.training import checkpointing as j_ckpt
    from transformertts_tpu.training import make_optimizer
    from transformertts_tpu.training.state import init_state
    from transformertts_tpu.utils.config import TrainingConfigManager as JConfig
    cfg, cm, steps = runs['sessions'][kind]
    for rank, (rc, out, err) in enumerate(runs['clis'][kind]):
        assert rc == 0, f'rank {rank}: {err[-3000:]}'
        assert f'rank {rank} of 4 (data {rank // 2} of 2, model {rank % 2} of 2)' in out
        assert 'done' in out and 'ignored exception' not in out, out[-2000:]
        assert kind == 'aligner' or 'resumed from step 1' in out
    assert checkpointing.list_checkpoints(cm.weights_dir)[-1][0] == steps
    if kind == 'tts':
        from transformertts_torch.models.forward_tts import ForwardTransformer
        from transformertts_tpu.models.forward_tts import ForwardTransformer as JFT
        saved = ForwardTransformer.load_model(cm.base_dir / 'model_step_2', device='cpu')
        ckpt = cm.get_model('cpu')
        checkpointing.restore_checkpoint(cm.weights_dir / 'ckpt_2.npz', ckpt)
        for key, value in ckpt.state_dict().items():
            assert torch.equal(saved.state_dict()[key], value), key
        assert JFT.load_model(cm.base_dir / 'model_step_2').config['step'] == 2
    section = 'tts_settings' if kind == 'tts' else 'aligner_settings'
    _session_mesh(cfg, section, mesh={'data': -1, 'model': 1}, max_steps=steps + 1)
    (train_tts if kind == 'tts' else train_aligner).main(
        ['--config', str(cfg), '--yes', '--device', 'cpu'])
    assert checkpointing.list_checkpoints(cm.weights_dir)[-1][0] == steps + 1
    jm = JConfig(cfg, aligner=kind == 'aligner').get_model()
    jm.init_params(jax.random.PRNGKey(0))
    restored = j_ckpt.restore_latest(cm.weights_dir, init_state(jm.params,
                                                                make_optimizer(SCHEDULE)))
    assert int(restored.step) == steps + 1 and int(restored.opt_state[0].count) == steps + 1
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(restored))


# ---------------------------------------------------------------------------
# (g) serving over a mesh with a model axis
# ---------------------------------------------------------------------------

def test_serving_over_a_model_axis_gives_the_model_1_wavs(tmp_path):
    """Serving replicates the parameters and spreads rows over ``data``
    only, as the JAX package's ``_prepare_mesh``: {data 2, model 2} over
    four CPU devices gives {data 2}'s wavs, and one device's to float32
    rounding."""
    from test_torch_nn import jax_and_port_models
    from test_torch_parallel import LINES
    from transformertts_torch.audio import Audio
    from transformertts_torch.models.synthesis import synthesize_lines
    from transformertts_torch.parallel import MeshConfig, make_mesh
    _, tm = jax_and_port_models(tmp_path / 'tiny')
    audio = Audio.from_config(tm.config)
    grid = make_mesh(MeshConfig(data=2, model=2), devices=['cpu'] * 4)
    assert len(grid) == 2
    got = synthesize_lines(tm, audio, LINES, n_iter=2, max_batch=3, mesh=grid)
    data = synthesize_lines(tm, audio, LINES, n_iter=2, max_batch=3,
                            mesh=make_mesh(MeshConfig(data=2), devices=['cpu'] * 2))
    one = synthesize_lines(tm, audio, LINES, n_iter=2, max_batch=4)
    for g, d, o in zip(got, data, one):
        assert g.size > 0
        np.testing.assert_array_equal(g, d)
        np.testing.assert_allclose(g, o, rtol=0, atol=1e-5)


if __name__ == '__main__':
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
