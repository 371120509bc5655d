"""The PyTorch port imports no JAX.

Runs in a subprocess: this test process has already imported jax through
tests/conftest.py. Of the JAX package the port may use only the host text
frontend (``transformertts_tpu.text``), which imports no jax.
"""
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
    # of the JAX package, only the package root and its host text frontend
    tpu = [m for m in loaded if m.startswith('transformertts_tpu')]
    assert all(m == 'transformertts_tpu' or m.startswith('transformertts_tpu.text')
               for m in tpu), tpu
