"""Check a reference (or custom) hdf5 ForwardTransformer checkpoint against the port.

    python -m transformertts_torch.verify_checkpoint <model_dir> [--device cuda]

``model_dir`` holds ``config.yaml`` and hdf5 weights (``model_weights.hdf5``,
else the first ``*.hdf5`` then ``*.h5``), as the published
``bdf06b9_ljspeech`` artifacts and ``save_model(weights_format='hdf5')`` of
either package write it. The port's counterpart of steps 1-2 of
``scripts/verify_checkpoint.py``:

1. converts the weights, printing a per-layer match report that shows which
   signal carried each assignment (explicit-name / order-fallback /
   named-group), every assignment checked against the model's shapes;
2. runs one ``predict`` on fixed tokens, durations and pitch on ``--device``
   (the card unless the caller names another) and prints the mel's
   statistics.

Step 3 of that script (``--tf``: the same hdf5 through the reference's TF
model, compared by mel MAE) needs TensorFlow and the reference sources and
is not ported. Reading hdf5 needs h5py.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import yaml

from transformertts_torch.models import convert
from transformertts_torch.models.forward_tts import ForwardTransformer
from transformertts_torch.models.persistence import hdf5_weights


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('model_dir', type=Path,
                        help='self-describing model dir (config.yaml + hdf5 weights)')
    parser.add_argument('--tokens', type=int, default=12, help='number of fixed test tokens')
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    with open(args.model_dir / 'config.yaml') as f:
        config = yaml.safe_load(f)
    weights_path = hdf5_weights(args.model_dir)
    print(f'config:  {args.model_dir / "config.yaml"}')
    print(f'weights: {weights_path}')
    model = ForwardTransformer(**config)

    print('\n-- per-layer match report ' + '-' * 40)
    signals = {}
    for lname, root, signal in convert.describe_weight_match(model, weights_path):
        print(f'  {lname:<28} -> {root:<28} [{signal}]')
        signals[signal] = signals.get(signal, 0) + 1
    print('  signals:', ', '.join(f'{k}×{v}' for k, v in signals.items()))

    convert.load_reference_weights_into(model, weights_path)
    model.to(args.device)
    print('\nconversion OK (every assignment shape-verified against the model)')

    rng = np.random.default_rng(0)
    tokens = rng.integers(1, model.text_pipeline.tokenizer.vocab_size, size=args.tokens)
    pitch = rng.standard_normal(args.tokens).astype(np.float32)
    mel = model.predict(tokens, encode=False, phoneme_durations=np.full(args.tokens, 4.0),
                        phoneme_pitch=pitch)['mel']
    print('\n-- predict on fixed tokens ' + '-' * 39)
    print(f'  device {args.device}  mel shape {mel.shape}  finite={np.isfinite(mel).all()}')
    print(f'  mean {mel.mean():+.4f}  std {mel.std():.4f}  '
          f'min {mel.min():+.4f}  max {mel.max():+.4f}')
    if not np.isfinite(mel).all():
        print('ERROR: non-finite mel output')
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
