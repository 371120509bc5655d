"""YAML training configuration, the counterpart of
``transformertts_tpu/utils/config.py`` (which imports jax through its
scheduling module, so the port keeps its own).

The session YAML's sections, with the settings of the model kind (``tts``,
or ``aligner`` with ``aligner=True``), are merged into one flat dict; the
session names key the artifact directories, so the port reads and writes the
same data, log and weight dirs as the JAX package for the same config. The
model (a ForwardTransformer, or with ``aligner=True`` an Aligner at the
reduction schedule's first r) and its trainer (a ``ForwardTrainer`` or an
``AlignerTrainer``) come from the merged config;
``load_model`` restores a model from a training checkpoint of either package.
Models go to the card unless the caller names another device.
"""
import shutil
import subprocess
from pathlib import Path

import yaml

from transformertts_torch.utils.scheduling import reduction_schedule

CONFIG_SECTIONS = ['paths', 'naming', 'training_data_settings', 'audio_settings',
                   'text_settings']


class TrainingConfigManager:

    def __init__(self, config_path, aligner: bool = False):
        self.config_path = Path(config_path)
        self.model_kind = 'aligner' if aligner else 'tts'
        with open(self.config_path) as f:
            session_config = yaml.safe_load(f)
        self.config = {}
        for section in CONFIG_SECTIONS + [f'{self.model_kind}_settings']:
            self.config.update(session_config[section])
        self.git_hash = self._get_git_hash()
        self.data_name = self.config['data_name']

        text_name = self.config['text_settings_name']
        audio_name = self.config['audio_settings_name']
        aligner_name = self.config['aligner_settings_name']
        tts_name = self.config['tts_settings_name']
        self.session_names = {
            'data': f'{text_name}.{audio_name}',
            'aligner': f'{aligner_name}.{text_name}.{audio_name}',
            'tts': f'{tts_name}.{aligner_name}',
        }
        self.wav_directory = Path(self.config['wav_directory'])
        self.metadata_path = Path(self.config['metadata_path'])
        self.data_dir = Path(f"{self.config['train_data_directory']}.{self.data_name}")
        self.base_dir = (Path(self.config['log_directory']) / self.data_name
                         / self.session_names[self.model_kind])
        self.log_dir = self.base_dir / 'logs'
        self.weights_dir = self.base_dir / 'weights'
        self.train_metadata_path = self.data_dir / f'train_metadata.{text_name}.txt'
        self.valid_metadata_path = self.data_dir / f'valid_metadata.{text_name}.txt'
        self.phonemized_metadata_path = self.data_dir / f'phonemized_metadata.{text_name}.txt'
        self.mel_dir = self.data_dir / f'mels.{audio_name}'
        self.pitch_dir = self.data_dir / f'pitch.{audio_name}'
        self.duration_dir = self.data_dir / f"durations.{self.session_names['aligner']}"
        self.pitch_per_char = self.data_dir / f"char_pitch.{self.session_names['aligner']}"
        if self.model_kind == 'aligner':
            self.max_r = int(self.config['reduction_factor_schedule'][0][1])
            self.stop_scaling = float(self.config.get('stop_loss_scaling', 1.0))
            # the JAX trainer's bf16 P·V boundary; the port computes P·V in
            # float32 whatever it says (its trainer takes and ignores it)
            self.narrow_pv = bool(self.config.get('narrow_pv', True))

    @staticmethod
    def _get_git_hash():
        try:
            return subprocess.check_output(['git', 'describe', '--always'],
                                           stderr=subprocess.DEVNULL).strip().decode()
        except (OSError, subprocess.CalledProcessError):
            return None

    def print_config(self):
        print(f'\nCONFIGURATION {self.session_names[self.model_kind]}')
        for k, v in self.config.items():
            print(f'  - {k} : {v}')

    def dump_config(self):
        self.config['git_hash'] = self.git_hash
        self.config['automatic'] = True
        self.base_dir.mkdir(parents=True, exist_ok=True)
        with open(self.base_dir / 'config.yaml', 'w') as f:
            yaml.safe_dump(dict(self.config), f, allow_unicode=True)

    def get_model(self, device='cuda'):
        """A model of this config on ``device`` (the card unless the caller
        names another), parameters uninitialized: an Aligner at r = max_r,
        or a ForwardTransformer."""
        stored = self.config.get('git_hash')
        if stored is not None and self.git_hash is not None and stored != self.git_hash:
            print(f'WARNING: git hash mismatch: current {self.git_hash}, config {stored}')
        if self.model_kind == 'aligner':
            from transformertts_torch.models.aligner import Aligner
            return Aligner.from_config(self.config, max_r=self.max_r, device=device)
        from transformertts_torch.models.forward_tts import ForwardTransformer
        return ForwardTransformer.from_config(self.config, device)

    def load_model(self, checkpoint_path=None, device='cuda', verbose: bool = True):
        """The model with the weights of ``checkpoint_path``, or of the latest
        checkpoint under ``weights_dir`` (fresh weights from seed 42, with a
        warning, where there is none), on ``device``. An Aligner takes the
        reduction schedule's r at the restored step."""
        import torch
        from transformertts_torch.training import checkpointing
        model = self.get_model('cpu').init_params(torch.Generator().manual_seed(42))
        if checkpoint_path is not None:
            step = checkpointing.restore_checkpoint(checkpoint_path, model)
        else:
            step = checkpointing.restore_latest(self.weights_dir, model)
        if step is None:
            print(f'WARNING: no checkpoint under {self.weights_dir}; using fresh weights.')
        else:
            model.step = step
            if verbose:
                print(f'restored weights at step {model.step}')
        if self.model_kind == 'aligner':
            model.set_constants(reduction_factor=reduction_schedule(
                model.step, self.config['reduction_factor_schedule']))
        return model.to(device)

    def get_trainer(self, model):
        """The trainer of this config's model kind: an ``AlignerTrainer`` or
        a ``ForwardTrainer``."""
        schedule = self.config['learning_rate_schedule']
        grad_accumulation = int(self.config.get('grad_accumulation', 1))
        if self.model_kind == 'aligner':
            from transformertts_torch.training.aligner_trainer import AlignerTrainer
            return AlignerTrainer(model, schedule, stop_scaling=self.stop_scaling,
                                  grad_accumulation=grad_accumulation,
                                  narrow_pv=self.narrow_pv)
        from transformertts_torch.training.forward_trainer import ForwardTrainer
        return ForwardTrainer(model, schedule, grad_accumulation=grad_accumulation)

    def create_remove_dirs(self, clear_dir: bool = False, clear_logs: bool = False,
                           clear_weights: bool = False, assume_yes: bool = False):
        self.base_dir.mkdir(parents=True, exist_ok=True)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        for d in (self.pitch_dir, self.pitch_per_char, self.mel_dir, self.duration_dir):
            d.mkdir(exist_ok=True)

        def confirm(prompt):
            return assume_yes or input(prompt) == 'y'

        if clear_dir and confirm(f'Delete {self.log_dir} AND {self.weights_dir}? (y/[n])'):
            shutil.rmtree(self.log_dir, ignore_errors=True)
            shutil.rmtree(self.weights_dir, ignore_errors=True)
        if clear_logs and confirm(f'Delete {self.log_dir}? (y/[n])'):
            shutil.rmtree(self.log_dir, ignore_errors=True)
        if clear_weights and confirm(f'Delete {self.weights_dir}? (y/[n])'):
            shutil.rmtree(self.weights_dir, ignore_errors=True)
        self.log_dir.mkdir(exist_ok=True)
        self.weights_dir.mkdir(exist_ok=True)
