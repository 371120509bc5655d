"""SummaryManager: TensorBoard observability for training runs.

Capability parity with the reference (utils/logging_utils.py:24-200):
- per-tag *sub-writers* for loss components so their curves overlay on one
  chart;
- scalars, images (attention-head grids, mel plots), histograms, audio
  (on-the-fly Griffin-Lim of predicted mels into TensorBoard), text;
- a ``control_frequency`` throttle decorator (available to callers — the
  train CLIs do their own step-gating of plot calls, so SummaryManager's
  display methods are deliberately NOT decorated to avoid double
  throttling) and ``@ignore_exception`` so logging can never kill a run.

Backed by the framework's own TF-free event writer (utils/event_writer.py).
"""
from functools import wraps
from pathlib import Path
from typing import Dict

import numpy as np

from transformertts_torch.utils.decorators import ignore_exception
from transformertts_torch.utils.display import attention_grid_png, mel_png
from transformertts_torch.utils.event_writer import EventWriter


def control_frequency(freq_attr: str):
    """Run the wrapped method only every ``self.<freq_attr>`` steps."""
    def deco(fn):
        @wraps(fn)
        def wrapper(self, *args, **kwargs):
            freq = getattr(self, freq_attr, 1) or 1
            step = kwargs.get('step', args[-1] if args else 0)
            if int(step) % int(freq) == 0:
                return fn(self, *args, **kwargs)
            return None
        return wrapper
    return deco


class SummaryManager:

    def __init__(self, model, log_dir, config: dict,
                 default_writer: str = 'log_dir', audio=None):
        self.model = model
        self.log_dir = Path(log_dir)
        self.config = config
        self.audio = audio
        self.default_writer = default_writer
        self.writers: Dict[str, EventWriter] = {}
        self.add_writer(default_writer, self.log_dir)
        # available for control_frequency-decorated subclass methods; the
        # shipped CLIs gate their plot calls by step themselves
        self.plot_frequency = int(config.get(
            'train_images_plotting_frequency', 1) or 1)

    # --------------------------------------------------------------- writers

    def add_writer(self, tag: str, path=None) -> EventWriter:
        """One event-file writer per tag subdir (overlaid TB curves)."""
        if tag not in self.writers:
            path = Path(path) if path is not None else self.log_dir / tag
            self.writers[tag] = EventWriter(path)
        return self.writers[tag]

    @ignore_exception
    def add_scalars(self, tag: str, dictionary: dict, step: int):
        """Component losses: same scalar tag, one writer per component."""
        for k, v in dictionary.items():
            self.add_writer(str(k)).add_scalar(tag, float(v), step)

    @ignore_exception
    def add_scalar(self, tag: str, scalar_value, step: int):
        self.writers[self.default_writer].add_scalar(
            tag, float(scalar_value), step)

    @ignore_exception
    def add_image(self, tag: str, png_tuple, step: int):
        png, h, w = png_tuple
        self.writers[self.default_writer].add_image_png(tag, png, h, w, step)

    @ignore_exception
    def add_histogram(self, tag: str, values, step: int, bins: int = 30):
        self.writers[self.default_writer].add_histogram(tag, values, step, bins)

    @ignore_exception
    def add_audio(self, tag: str, wav: np.ndarray, sample_rate: int, step: int):
        self.writers[self.default_writer].add_audio(tag, wav, sample_rate, step)

    @ignore_exception
    def add_text(self, tag: str, text: str, step: int):
        self.writers[self.default_writer].add_text(tag, text, step)

    # --------------------------------------------------------------- display

    @ignore_exception
    def display_attention_heads(self, outputs: dict, step: int,
                                tag: str = 'AttentionHeads', fname: list = None):
        """Attention grids per layer (reference logging_utils.py:113-151)."""
        for group in ('encoder_attention', 'decoder_attention'):
            if group not in outputs:
                continue
            for layer_name, attn in outputs[group].items():
                attn = np.asarray(attn)
                batch_plot_path = f'{tag}_{group.split("_")[0]}/{layer_name}'
                self.add_image(batch_plot_path, attention_grid_png(attn[0]),
                               step)

    @ignore_exception
    def display_mel(self, mel: np.ndarray, step: int, tag: str = 'mel'):
        self.add_image(tag, mel_png(np.asarray(mel)), step)

    @ignore_exception
    def display_audio(self, tag: str, mel: np.ndarray, step: int, device=None):
        """Griffin-Lim a predicted mel into TensorBoard audio
        (reference logging_utils.py:195-200). ``mel`` is (T, C). Griffin-Lim
        runs on ``device``, by default the model's."""
        if self.audio is None:
            return
        device = self.model.device if device is None else device
        wav = self.audio.reconstruct_waveform(np.asarray(mel).T, device=device)
        self.add_audio(tag, wav, int(self.audio.config['sampling_rate']), step)

    @ignore_exception
    def display_loss(self, aux: dict, step: int, tag: str = 'Losses'):
        self.add_scalar(f'{tag}/total', float(aux['loss']), step)
        components = {k: v for k, v in aux.items()
                      if k not in ('loss',) and np.ndim(v) == 0}
        self.add_scalars(f'{tag}/components', components, step)

    @ignore_exception
    def display_scalar(self, tag: str, scalar_value, step: int):
        self.add_scalar(tag, float(scalar_value), step)

    # ------------------------------------------------------------- lifecycle

    def flush(self):
        for w in self.writers.values():
            w.flush()

    def close(self):
        for w in self.writers.values():
            w.close()
