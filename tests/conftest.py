"""Test configuration: run everything on a virtual 8-device CPU mesh.

Sharding/pjit paths are exercised without TPU hardware via
``xla_force_host_platform_device_count`` (see SURVEY.md §4). The platform is
forced to CPU through jax.config because ambient PJRT plugins may override
the ``JAX_PLATFORMS`` env var after import.
"""
import os

os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

# Persistent XLA compile cache: the suite is compile-bound (single-core CI
# hosts); repeat runs skip every unchanged executable. Subprocess-spawning
# tests (multihost, graft-entry) inherit it via the env var.
from transformertts_tpu.utils.scripts_utils import enable_compilation_cache  # noqa: E402

_cache_dir = os.environ.setdefault(
    'JAX_COMPILATION_CACHE_DIR',
    os.path.expanduser('~/.cache/tts_tpu_xla_tests'))
enable_compilation_cache(_cache_dir)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: runs a CUDA kernel on a card; skips where there is none')
