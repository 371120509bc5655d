"""transformertts_torch: the PyTorch/CUDA port of ``transformertts_tpu``.

It mirrors the JAX package's layout and names and reads and writes the same
self-describing model dirs, training checkpoints and featurized data dirs.
It imports torch and numpy, never jax, and nothing of the JAX package: the
host modules it shares with it (text frontend, data pipeline, logging
helpers, VAD) are its own copies.

    from transformertts_torch.models import ForwardTransformer
    from transformertts_torch.audio import Audio
    model = ForwardTransformer.load_model('/path/to/model_dir')
    audio = Audio.from_config(model.config)
    out = model.predict('Please, say something.')
    wav = audio.reconstruct_waveform(out['mel'])

Entry points that take a ``device`` run on the card unless the caller names
another (``device='cpu'``, as the CPU tests do); without a card such a call
raises and never falls back to the CPU.
"""
