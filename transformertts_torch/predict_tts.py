"""Text → mel → Griffin-Lim → wav with the PyTorch port.

    python -m transformertts_torch.predict_tts -p <model_dir> -t "some text" [-o outdir]
    python -m transformertts_torch.predict_tts -p <model_dir> -f lines.txt [--per_line] [-s]

The flags are those of the JAX package's ``predict_tts.py``, plus
``--device`` (default ``cuda``). The model dir is one that either package
saved. Several lines run batched through ``synthesize_lines`` unless
``--per_line`` or ``--store_mel`` asks for one ``predict`` per line.
"""
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from transformertts_torch.audio import Audio
from transformertts_torch.models import ForwardTransformer


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument('--path', '-p', dest='path', required=True, type=str)
    parser.add_argument('--text', '-t', dest='text', default=None, type=str)
    parser.add_argument('--file', '-f', dest='file', default=None, type=str)
    parser.add_argument('--outdir', '-o', dest='outdir', default=None, type=str)
    parser.add_argument('--store_mel', '-m', dest='store_mel', action='store_true')
    parser.add_argument('--verbose', '-v', dest='verbose', action='store_true')
    parser.add_argument('--single', '-s', dest='single', action='store_true')
    parser.add_argument('--per_line', dest='per_line', action='store_true',
                        help='one predict call per line instead of batched synthesis')
    parser.add_argument('--device', dest='device', default='cuda', type=str)
    args = parser.parse_args(argv)

    if args.file is not None:
        with open(args.file, 'r') as file:
            text = file.readlines()
        fname = Path(args.file).stem
    elif args.text is not None:
        text = [args.text]
        fname = 'custom_text'
    else:
        parser.error('specify an input text (-t "some text") or a text file (-f file.txt)')

    print(f'Loading model from {args.path}')
    model = ForwardTransformer.load_model(args.path, device=args.device)
    file_name = (f"{fname}_{model.config.get('data_name', 'custom')}_"
                 f"{model.config.get('git_hash', 'local')}_{model.config.get('step', 0)}")
    outdir = Path(args.outdir or '.') / 'outputs' / fname
    outdir.mkdir(exist_ok=True, parents=True)
    output_path = (outdir / file_name).with_suffix('.wav')
    audio = Audio.from_config(model.config)
    print(f'Output wav under {output_path.parent}')
    lines = [line for line in text if line.strip()]
    if not args.per_line and not args.store_mel and len(lines) > 1:
        from transformertts_torch.models.synthesis import synthesize_lines
        wavs = synthesize_lines(model, audio, lines)
        if args.single:
            for i, wav in enumerate(wavs):
                audio.save_wav(wav, (outdir / f'{file_name}_{i}').with_suffix('.wav'))
    else:
        wavs = []
        for i, line in enumerate(lines):
            phons = model.text_pipeline.phonemizer(line)
            tokens = model.text_pipeline.tokenizer(phons)
            if args.verbose:
                print(f'Predicting {line}')
                print(f'Phonemes: "{phons}"')
                print(f'Tokens: "{tokens}"')
            out = model.predict(tokens, encode=False)
            wav = audio.reconstruct_waveform(out['mel'], device=args.device)
            wavs.append(wav)
            if args.store_mel:
                np.save(str((outdir / f'{file_name}_{i}').with_suffix('.mel')), out['mel'])
            if args.single:
                audio.save_wav(wav, (outdir / f'{file_name}_{i}').with_suffix('.wav'))
    audio.save_wav(np.concatenate(wavs), output_path)


if __name__ == '__main__':
    main()
