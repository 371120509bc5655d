"""Text → mel → Griffin-Lim or a neural vocoder → wav with the PyTorch port.

    python -m transformertts_torch.predict_tts -p <model_dir> -t "some text" [-o outdir]
    python -m transformertts_torch.predict_tts -p <model_dir> -f lines.txt [--per_line] [-s]
    python -m transformertts_torch.predict_tts --step 95000 -f lines.txt --vocoder <ckpt>
    python -m transformertts_torch.predict_tts -p <model_dir> -f lines.txt --data_parallel 2

The flags are those of the JAX package's ``predict_tts.py``, plus
``--device`` (default ``cuda``). The model dir is
one that either package saved; without ``-p`` the published LJSpeech model
at ``--step`` is found by ``models/factory.py::tts_ljspeech``. ``--vocoder``
names a MelGAN or HiFi-GAN torch checkpoint, which then makes the waveform
in place of Griffin-Lim. Several lines run batched through
``synthesize_lines`` unless ``--per_line`` or ``--store_mel`` asks for one
``predict`` per line. ``--data_parallel N`` spreads the batched path's
chunks over the first N cards (``parallel.make_mesh``; N copies of the CPU
with ``--device cpu``); N larger than the number of cards raises.
``--trace PATH`` writes the batched path's spans and counters
(``utils.tracing``) to PATH as a Chrome-trace JSON on the epoch clock of
``torch.profiler``'s traces.
"""
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from transformertts_torch.audio import Audio
from transformertts_torch.models import ForwardTransformer
from transformertts_torch.models.factory import tts_ljspeech
from transformertts_torch.utils import tracing


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument('--path', '-p', dest='path', default=None, type=str)
    parser.add_argument('--step', dest='step', default='95000', type=str,
                        help='step of the published LJSpeech model, used without -p')
    parser.add_argument('--text', '-t', dest='text', default=None, type=str)
    parser.add_argument('--file', '-f', dest='file', default=None, type=str)
    parser.add_argument('--outdir', '-o', dest='outdir', default=None, type=str)
    parser.add_argument('--store_mel', '-m', dest='store_mel', action='store_true')
    parser.add_argument('--verbose', '-v', dest='verbose', action='store_true')
    parser.add_argument('--single', '-s', dest='single', action='store_true')
    parser.add_argument('--per_line', dest='per_line', action='store_true',
                        help='one predict call per line instead of batched synthesis')
    parser.add_argument('--vocoder', dest='vocoder', default=None, type=str,
                        help='a MelGAN (seungwonpark/melgan) or HiFi-GAN (jik876/hifi-gan) '
                             'torch checkpoint, which makes the waveform in place of '
                             'Griffin-Lim')
    parser.add_argument('--data_parallel', dest='data_parallel', default=None, type=int,
                        help='spread batched synthesis over the first N cards (N copies of '
                             'the CPU with --device cpu): a data-parallel mesh, batched path '
                             'only')
    parser.add_argument('--trace', dest='trace', default=None, type=str,
                        help="write the batched path's spans and counters to this path as a "
                             'Chrome-trace JSON (the per-line path records none)')
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
    mesh = None
    if args.data_parallel is not None:
        from transformertts_torch.parallel import MeshConfig, make_mesh
        on_cpu = torch.device(args.device).type == 'cpu'
        mesh = make_mesh(MeshConfig(data=args.data_parallel),
                         [args.device] * args.data_parallel if on_cpu else None)

    if args.path is not None:
        print(f'Loading model from {args.path}')
        model = ForwardTransformer.load_model(args.path, device=args.device)
    else:
        model = tts_ljspeech(args.step, device=args.device)
    file_name = (f"{fname}_{model.config.get('data_name', 'custom')}_"
                 f"{model.config.get('git_hash', 'local')}_{model.config.get('step', 0)}")
    outdir = Path(args.outdir or '.') / 'outputs' / fname
    outdir.mkdir(exist_ok=True, parents=True)
    output_path = (outdir / file_name).with_suffix('.wav')
    audio = Audio.from_config(model.config)
    vocoder = None
    if args.vocoder is not None:
        from transformertts_torch.models.vocoder import load_vocoder
        print(f'Loading vocoder from {args.vocoder}')
        vocoder = load_vocoder(args.vocoder, mel_channels=model.config['mel_channels'],
                               device=args.device)
        print(f'Vocoder: {type(vocoder).__name__}')
    print(f'Output wav under {output_path.parent}')
    lines = [line for line in text if line.strip()]
    if not args.per_line and not args.store_mel and len(lines) > 1:
        from transformertts_torch.models.synthesis import synthesize_lines
        if mesh is not None:
            print(f'Serving over a {len(mesh)}-device data-parallel mesh')
        if args.trace is not None:
            tracing.enable()
        try:
            wavs = synthesize_lines(model, audio, lines, vocoder=vocoder, mesh=mesh)
        finally:
            if args.trace is not None:
                tracing.disable()
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
            if vocoder is not None:
                wav = vocoder.inference(out['mel'].T)
            else:
                wav = audio.reconstruct_waveform(out['mel'], device=args.device)
            wavs.append(wav)
            if args.store_mel:
                np.save(str((outdir / f'{file_name}_{i}').with_suffix('.mel')), out['mel'])
            if args.single:
                audio.save_wav(wav, (outdir / f'{file_name}_{i}').with_suffix('.wav'))
    audio.save_wav(np.concatenate(wavs), output_path)
    if args.trace is not None:
        tracing.write_chrome_trace(args.trace, tracing.take())
        print(f'Spans and counters written to {args.trace}')


if __name__ == '__main__':
    main()
