"""The PyTorch port imports no JAX and nothing of the JAX package.

Runs in a subprocess: this test process has already imported jax through
tests/conftest.py. The port keeps its own copies of the JAX package's host
modules (text frontend, data pipeline, logging and CLI helpers), so
importing every port module loads no ``transformertts_tpu`` module at all.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PORT_MODULES = [
    'transformertts_torch',
    'transformertts_torch.models',
    'transformertts_torch.models.aligner',
    'transformertts_torch.models.convert',
    'transformertts_torch.models.factory',
    'transformertts_torch.models.forward_tts',
    'transformertts_torch.models.hifigan',
    'transformertts_torch.models.melgan',
    'transformertts_torch.models.persistence',
    'transformertts_torch.models.synthesis',
    'transformertts_torch.models.vocoder',
    'transformertts_torch.nn.attention',
    'transformertts_torch.nn.blocks',
    'transformertts_torch.nn.core',
    'transformertts_torch.nn.length_regulator',
    'transformertts_torch.nn.masks',
    'transformertts_torch.nn.posenc',
    'transformertts_torch.native',
    'transformertts_torch.ops.build',
    'transformertts_torch.ops.duration_extraction',
    'transformertts_torch.ops.flash_attention',
    'transformertts_torch.ops.fused_log_mel',
    'transformertts_torch.ops.griffin_lim',
    'transformertts_torch.parallel',
    'transformertts_torch.parallel.mesh',
    'transformertts_torch.parallel.tensor_parallel',
    'transformertts_torch.audio',
    'transformertts_torch.audio.griffinlim',
    'transformertts_torch.audio.pitch',
    'transformertts_torch.audio.spectral',
    'transformertts_torch.audio.vad',
    'transformertts_torch.audio.wav_io',
    'transformertts_torch.create_training_data',
    'transformertts_torch.data',
    'transformertts_torch.data.datasets',
    'transformertts_torch.data.metadata',
    'transformertts_torch.extract_durations',
    'transformertts_torch.predict_tts',
    'transformertts_torch.profile_train',
    'transformertts_torch.train_aligner',
    'transformertts_torch.train_tts',
    'transformertts_torch.training.aligner_trainer',
    'transformertts_torch.training.base_trainer',
    'transformertts_torch.training.checkpointing',
    'transformertts_torch.training.forward_trainer',
    'transformertts_torch.training.state',
    'transformertts_torch.text',
    'transformertts_torch.text.g2p',
    'transformertts_torch.text.lexicon_en',
    'transformertts_torch.text.phonemizer',
    'transformertts_torch.text.symbols',
    'transformertts_torch.text.tokenizer',
    'transformertts_torch.utils.config',
    'transformertts_torch.utils.decorators',
    'transformertts_torch.utils.display',
    'transformertts_torch.utils.event_writer',
    'transformertts_torch.utils.logging_utils',
    'transformertts_torch.utils.losses',
    'transformertts_torch.utils.metrics',
    'transformertts_torch.utils.scheduling',
    'transformertts_torch.utils.scripts_utils',
    'transformertts_torch.utils.spectrogram_ops',
    'transformertts_torch.verify_checkpoint',
    'chip_smoke',
]


def _imported_after(modules):
    code = (f'import importlib, json, sys\n'
            f'for m in {modules!r}: importlib.import_module(m)\n'
            f'print(json.dumps(sorted(sys.modules)))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax():
    loaded = _imported_after(PORT_MODULES)
    assert not [m for m in loaded if m == 'jax' or m.startswith(('jax.', 'jaxlib'))]
    assert not [m for m in loaded if m.startswith('transformertts_tpu')]
    assert 'transformertts_torch.create_training_data' in loaded
    assert 'transformertts_torch.extract_durations' in loaded
    assert 'transformertts_torch.train_aligner' in loaded
    assert 'transformertts_torch.models.vocoder' in loaded
    assert 'transformertts_torch.training.aligner_trainer' in loaded
    assert 'transformertts_torch.parallel.mesh' in loaded
    assert 'transformertts_torch.parallel.tensor_parallel' in loaded
    # h5py is imported only when hdf5 weights are read or written, matplotlib
    # only when a plot is drawn: the card's machine has neither
    assert 'transformertts_torch.models.convert' in loaded and 'h5py' not in loaded
    assert 'transformertts_torch.verify_checkpoint' in loaded
    assert not [m for m in loaded if m.split('.')[0] == 'matplotlib']


def test_chip_smoke_imports_nothing_of_jax_itself():
    """chip_smoke.py runs on a card without JAX: none of its own imports
    names jax or the JAX package."""
    tree = ast.parse((ROOT / 'chip_smoke.py').read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert 'transformertts_torch.ops.build' in names or 'transformertts_torch.ops' in names
    assert not [m for m in names if m.split('.')[0] in ('jax', 'jaxlib', 'transformertts_tpu')]
