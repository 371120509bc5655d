"""The PyTorch port imports no JAX.

Runs in a subprocess: this test process has already imported jax through
tests/conftest.py. Of the JAX package the port may use only host modules
that import no jax: the text frontend (``transformertts_tpu.text``), the
data pipeline (``transformertts_tpu.data``) and the logging and CLI helpers
of ``transformertts_tpu.utils`` listed in ``SHARED_HOST_MODULES``.
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
    'transformertts_torch.models.forward_tts',
    'transformertts_torch.models.persistence',
    'transformertts_torch.models.synthesis',
    'transformertts_torch.nn.attention',
    'transformertts_torch.nn.blocks',
    'transformertts_torch.nn.core',
    'transformertts_torch.nn.length_regulator',
    'transformertts_torch.nn.masks',
    'transformertts_torch.nn.posenc',
    'transformertts_torch.ops.build',
    'transformertts_torch.ops.flash_attention',
    'transformertts_torch.audio',
    'transformertts_torch.audio.griffinlim',
    'transformertts_torch.audio.spectral',
    'transformertts_torch.audio.wav_io',
    'transformertts_torch.predict_tts',
    'transformertts_torch.profile_train',
    'transformertts_torch.train_tts',
    'transformertts_torch.training.base_trainer',
    'transformertts_torch.training.checkpointing',
    'transformertts_torch.training.forward_trainer',
    'transformertts_torch.training.state',
    'transformertts_torch.utils.config',
    'transformertts_torch.utils.losses',
    'transformertts_torch.utils.scheduling',
    'chip_smoke',
]

SHARED_HOST_MODULES = {
    'transformertts_tpu.utils',
    'transformertts_tpu.utils.decorators',
    'transformertts_tpu.utils.display',
    'transformertts_tpu.utils.event_writer',
    'transformertts_tpu.utils.logging_utils',
    'transformertts_tpu.utils.scripts_utils',
}


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
    # of the JAX package, only the package root and the shared host modules
    tpu = [m for m in loaded if m.startswith('transformertts_tpu')]
    assert all(m == 'transformertts_tpu' or m in SHARED_HOST_MODULES
               or m.startswith(('transformertts_tpu.text', 'transformertts_tpu.data'))
               for m in tpu), tpu


def test_chip_smoke_imports_nothing_of_jax_itself():
    """chip_smoke.py runs on a card without JAX: none of its own imports
    names jax or the JAX package (the port's host modules may use the JAX
    package's jax-free ones, as the test above allows)."""
    tree = ast.parse((ROOT / 'chip_smoke.py').read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert 'transformertts_torch.ops.build' in names or 'transformertts_torch.ops' in names
    assert not [m for m in names if m.split('.')[0] in ('jax', 'jaxlib', 'transformertts_tpu')]
